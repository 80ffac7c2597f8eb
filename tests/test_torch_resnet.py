"""The port's ResNet-18/34/50 against the JAX package on the same f32
weights and inputs: parameter leaves, counts and BN statistics (the JAX
package's init shapes), logits and BN running statistics in train and
eval (batch 2, 16 x 16), one ResNet-18 train step (loss, every gradient,
the updated parameters and statistics), the ImageNet layout (7x7 stride-2
stem and SAME max-pool) at 32 px, the max-pool and explicit conv padding
against flax, and ``get_model``'s names and refusals. Tolerance 1e-4
relative to each tensor's scale, as tests/test_torch_cnn.py. JAX compiles
ResNet-50 once: one program gives its train and eval forwards.

Inputs are 16 px (64 px for the ImageNet stem), not 8: at 8 px the last
group's maps are 1 x 1, so training-mode BatchNorm normalizes 2 values
per channel at batch 2, which is ill-conditioned in f32 — the port's own
f32 ResNet-50 logits differ from its float64 ones by 1.7 there (of a
largest logit of 3.4), and by 9e-5 at 16 px."""

from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.models import get_model as jget_model
from distributed_model_parallel_tpu.models import layers as jlayers
from distributed_model_parallel_tpu.models import resnet as jresnet
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch.data.registry import (
    CIFAR10_MEAN,
    CIFAR10_STD,
)
from distributed_model_parallel_tpu_torch.models import (
    get_model,
    params_from_jax,
    params_to_jax,
)
from distributed_model_parallel_tpu_torch.models import embedding as tbow
from distributed_model_parallel_tpu_torch.models import layers as tlayers
from distributed_model_parallel_tpu_torch.models import resnet as tresnet
from distributed_model_parallel_tpu_torch.train import optim as toptim
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from tests.test_torch_cnn import (
    RTOL,
    _check_units,
    _close,
    _close_trees,
    _perturbed,
    _trace,
    _x,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

# From the JAX package's init (CIFAR layout, 10 classes): parameter
# leaves, parameters, BN running statistics (mean and var elements).
COUNTS = {"resnet18": (62, 11_173_962, 9_600),
          "resnet50": (161, 23_520_842, 53_120)}


def _port(name, **extra):
    return get_model(tconfig.ModelConfig(name=name, extra=extra),
                     device="cpu")


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


@pytest.fixture(scope="module")
def jax_forwards():
    """Per arch, the JAX package's train and eval forwards of one
    perturbed weight set (one compiled program each) and the port model
    holding the same weights."""
    out = {}
    x = _x((2, 16, 16, 3), seed=3)
    for arch in ("resnet18", "resnet50"):
        tm = _port(arch)
        params, state = _perturbed(tm, seed=5)
        jm = jresnet.build_resnet(arch)

        @jax.jit
        def both(p, s, xx, jm=jm):
            return (jm.apply(p, s, xx, train=True),
                    jm.apply(p, s, xx, train=False))

        jp, js = (jax.tree.map(jnp.asarray, t) for t in (params, state))
        (yt, st), (ye, _) = both(jp, js, jnp.asarray(x))
        out[arch] = dict(tm=tm, params=params, state=state, x=x,
                         train=(np.asarray(yt), jax.tree.map(np.asarray, st)),
                         eval=np.asarray(ye))
    return out


@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50"])
def test_leaves_and_counts_match_jax_init(arch):
    """Every leaf's name and shape (both trees) equals the JAX package's
    init; ResNet-18/50 carry the leaf, parameter and statistics counts
    the JAX package gives."""
    jm = jget_model(jconfig.ModelConfig(name=arch))
    jp, js = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((2, 32, 32, 3)))
    tm = tresnet.build_resnet(arch)             # shapes only: no init
    tp, ts = params_to_jax(tm)
    assert tm.name == jm.name == arch
    assert tm.num_units == jm.num_units == 2 + sum(jresnet.ARCH[arch][1])
    assert _shapes(tp) == _shapes(tuple(jp)) and _shapes(ts) == _shapes(
        tuple(js))
    if arch in COUNTS:
        leaves = jax.tree.leaves(tp)
        stats = sum(a.size for a in jax.tree.leaves(ts))
        assert (len(leaves), sum(a.size for a in leaves), stats) == \
            COUNTS[arch]
        assert sum(p.numel() for p in tm.parameters()) == COUNTS[arch][1]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_matches_jax(jax_forwards, arch, train):
    """Logits (train and eval) and the BN running statistics after the
    training forward, from the same perturbed weights, batch 2 at 16
    px."""
    f = jax_forwards[arch]
    tm = f["tm"]
    params_from_jax(tm, f["params"], f["state"], "cpu")
    y, _ = tm.apply(torch.from_numpy(f["x"]), train=train)
    if train:
        jy, jst = f["train"]
        _close(y.detach().numpy(), jy, "logits")
        _close_trees(params_to_jax(tm)[1], jst, "state")
    else:
        _close(y.detach().numpy(), f["eval"], "logits")


def test_resnet18_train_step_matches_jax():
    """One ResNet-18 step (augment off; SGD lr 0.1, momentum 0.9, wd 1e-4)
    from the same weights and batch: loss, every gradient leaf, the
    updated parameters and the BN running statistics."""
    tm = _port("resnet18")
    params, state = _perturbed(tm, seed=11)
    rng = np.random.default_rng(12)
    images = rng.integers(0, 256, (4, 8, 8, 3), np.uint8)
    labels = rng.integers(0, 10, 4).astype(np.int32)

    tx = joptim.make_optimizer(jconfig.OptimizerConfig(learning_rate=0.1),
                               10, 1)
    jp, js = (jax.tree.map(jnp.asarray, t) for t in (params, state))
    st = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                             model_state=js, opt_state=tx.init(jp))
    step = jax.jit(jtrainer.make_train_step(
        jresnet.build_resnet("resnet18"), tx, mean=CIFAR10_MEAN,
        std=CIFAR10_STD, augment=False))
    new, jmet = step(st, jax.random.key(0), jnp.asarray(images),
                     jnp.asarray(labels))
    wd = np.float32(1e-4)
    jgrads = jax.tree.map(lambda t, p: np.asarray(t) - wd * p,
                          _trace(new.opt_state), params)

    opt = toptim.make_optimizer(tconfig.OptimizerConfig(learning_rate=0.1),
                                10, 1, tm.parameters())
    tstep = ttrainer.make_train_step(tm, opt, mean=CIFAR10_MEAN,
                                     std=CIFAR10_STD, augment=False)
    tmet = tstep(torch.from_numpy(images), torch.from_numpy(labels))
    _close(tmet["loss"].item(), float(jmet["loss"]), "loss")
    tgrads, _ = params_to_jax(tm, grads=True)
    gmax = max(float(np.abs(g).max()) for g in jax.tree.leaves(jgrads))
    for (path, g), w in zip(jax.tree.flatten_with_path(tgrads)[0],
                            jax.tree.leaves(jgrads)):
        err = float(np.abs(g - w).max())
        assert err <= RTOL * gmax, (jax.tree_util.keystr(path), err)
    tparams, tstate = params_to_jax(tm)
    _close_trees(tparams, jax.tree.map(np.asarray, new.params), "params")
    _close_trees(tstate, jax.tree.map(np.asarray, new.model_state), "bn")


@pytest.mark.parametrize("train", [True, False])
def test_resnet18_imagenet_layout_matches_jax(train):
    """The ImageNet stem at 64 px: a 7x7 stride-2 conv (SAME pads 2, 3 on
    the even input) and a 3x3 stride-2 SAME max-pool (pads 0, 1 with
    -inf), 10 units, ``resnet18_imagenet``."""
    tm = _port("resnet18", input_layout="imagenet")
    jm = jget_model(jconfig.ModelConfig(
        name="resnet18", extra={"input_layout": "imagenet"}))
    assert tm.name == jm.name == "resnet18_imagenet"
    assert tm.num_units == jm.num_units == 10
    params, state = _perturbed(tm, seed=4)
    x = _x((2, 64, 64, 3), seed=6)
    jp, js = (jax.tree.map(jnp.asarray, t) for t in (params, state))
    jy, jst = jax.jit(partial(jm.apply, train=train))(jp, js, jnp.asarray(x))
    y, _ = tm.apply(torch.from_numpy(x), train=train)
    _close(y.detach().numpy(), np.asarray(jy), "logits")
    _close_trees(params_to_jax(tm)[1], jax.tree.map(np.asarray, jst),
                 "state")


@pytest.mark.parametrize("size", [7, 8, 9, 16, 1, 2])
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_max_pool_matches_flax(size, stride):
    """``max_pool_same`` == ``nn.max_pool(x, (3, 3), (s, s), "SAME")`` on
    negative-heavy inputs (a zero padding would show), odd and even
    sizes, bit for bit."""
    x = _x((2, size, size, 5), seed=size * 10 + stride) - 2.0
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(stride, stride),
                        padding="SAME")
    got = tlayers.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2),
                                3, stride).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_max_pool_in_bf16_pads_with_minus_inf():
    x = torch.full((1, 1, 4, 4), -3.0, dtype=torch.bfloat16)
    y = tlayers.max_pool_same(x, 3, 2)
    assert y.dtype == torch.bfloat16 and (y == -3.0).all()


@pytest.mark.parametrize("padding", ["VALID", 1, ((0, 1), (2, 0)), (2, 1)])
@pytest.mark.parametrize("train", [True, False])
def test_conv_unit_explicit_padding_and_pool_match_flax(padding, train):
    ops = ({"features": 8, "kernel": 3, "stride": 2, "padding": padding,
            "maxpool": 2},)
    _check_units([jlayers.ConvUnit(ops=ops)], [tlayers.ConvUnit(3, ops)],
                 _x((2, 11, 11, 3)), train)


def test_get_model_names_and_refusals():
    for arch in ("resnet18", "resnet34", "resnet50"):
        for layout in ("cifar", "imagenet"):
            jcfg = jconfig.ModelConfig(name=arch,
                                       extra={"input_layout": layout})
            assert (tresnet.build_resnet(arch, input_layout=layout).name
                    == jget_model(jcfg).name)
    tm = get_model(tconfig.ModelConfig(
        name="resnet18", extra={"input_layout": "imagenet"}), device="cpu")
    assert tm.name == "resnet18_imagenet"
    bow = get_model(tconfig.ModelConfig(name="embedding_bow",
                                        extra={"vocab_size": 50}))
    jbow = jget_model(jconfig.ModelConfig(name="embedding_bow",
                                          extra={"vocab_size": 50}))
    assert isinstance(bow, tbow.BowConfig)
    assert (bow.vocab_size, bow.embed_dim, bow.num_classes) == (
        jbow.vocab_size, jbow.embed_dim, jbow.num_classes) == (50, 64, 10)
    for name in ("tinycnn", "embedding_bow"):
        with pytest.raises(ValueError, match="takes no input_layout"):
            get_model(tconfig.ModelConfig(
                name=name, extra={"input_layout": "cifar"}), device="cpu")
    with pytest.raises(ValueError, match="input_layout"):
        get_model(tconfig.ModelConfig(
            name="resnet18", extra={"input_layout": "hd"}), device="cpu")
    with pytest.raises(KeyError, match="unknown model 'vgg17'"):
        get_model(tconfig.ModelConfig(name="vgg17"), device="cpu")
    with pytest.raises(KeyError, match="unknown ResNet"):
        tresnet.build_resnet("resnet101")
