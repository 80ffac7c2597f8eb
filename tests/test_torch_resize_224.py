"""One step of the reference's finetune recipe (``Readme.md:186-202``):
CIFAR-shaped 32 px uint8 rows resized to 224 px on the device
(``data/loader.resize_batch`` inside ``make_train_step``), ImageNet-layout
MobileNetV2 and ResNet-18 from the JAX package's init, SGD lr 0.05,
momentum 0.9, wd 1e-4, augment off, against JAX's
``make_train_step(resize_to=224)``: in f32 the loss and top-k sums within
1e-4; in float64 in both packages every gradient leaf within 1e-4 of the
largest and the BN running statistics after the step within 1e-4. The
gradients' f32 values move with ReLU masks that flip between any two f32
evaluations at this depth and width (tests/test_torch_cnn.py,
STEP_SEED), and on the CPU at one thread torch's f32 convolutions leave
MobileNetV2's last BN statistics 1.6e-4 of their scale from the float64
values where JAX's f32 ones sit 4e-6 from them (measured on these
inputs): the kernels' rounding, held where it does not enter."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.data import loader as jloader
from distributed_model_parallel_tpu.models import get_model as jget_model
from distributed_model_parallel_tpu.models import mobilenetv2 as jmnv2
from distributed_model_parallel_tpu.models import resnet as jresnet
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu.train import trainer as jtrainer
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch.data import loader as tloader
from distributed_model_parallel_tpu_torch.data.registry import (
    CIFAR10_MEAN,
    CIFAR10_STD,
)
from distributed_model_parallel_tpu_torch.models import (
    get_model,
    layers,
    params_from_jax,
    params_to_jax,
)
from distributed_model_parallel_tpu_torch.models import mobilenetv2 as tmnv2
from distributed_model_parallel_tpu_torch.models import resnet as tresnet
from distributed_model_parallel_tpu_torch.train import optim as toptim
from distributed_model_parallel_tpu_torch.train import trainer as ttrainer
from tests.test_torch_cnn import RTOL, _close, _close_trees

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

EXTRA = {"input_layout": "imagenet"}
OPT = dict(learning_rate=0.05, weight_decay=1e-4)
BUILD = {"mobilenetv2": (jmnv2.build_mobilenetv2, tmnv2.build_mobilenetv2,
                         {}),
         "resnet18": (jresnet.build_resnet, tresnet.build_resnet,
                      {"arch": "resnet18"})}


def _inputs(name):
    jm = jget_model(jconfig.ModelConfig(name=name, extra=EXTRA))
    params, state = jm.init(jax.random.key(0), jnp.zeros((2, 224, 224, 3)))
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (2, 32, 32, 3), np.uint8)
    labels = rng.integers(0, 10, 2).astype(np.int32)
    return jm, params, state, images, labels


@pytest.mark.parametrize("name", ["mobilenetv2", "resnet18"])
def test_224_px_step_matches_jax(name):
    jm, params, state, images, labels = _inputs(name)
    tx = joptim.make_optimizer(jconfig.OptimizerConfig(**OPT), 10, 1)
    st = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             model_state=state, opt_state=tx.init(params))
    step = jax.jit(jtrainer.make_train_step(
        jm, tx, mean=CIFAR10_MEAN, std=CIFAR10_STD, augment=False,
        resize_to=224))
    new, jmet = step(st, jax.random.key(0), jnp.asarray(images),
                     jnp.asarray(labels))

    tm = get_model(tconfig.ModelConfig(name=name, extra=EXTRA),
                   device="cpu")
    params_from_jax(tm, *(jax.tree.map(np.asarray, t)
                          for t in (params, state)), "cpu")
    opt = toptim.make_optimizer(tconfig.OptimizerConfig(**OPT), 10, 1,
                                tm.parameters())
    tstep = ttrainer.make_train_step(tm, opt, mean=CIFAR10_MEAN,
                                     std=CIFAR10_STD, augment=False,
                                     resize_to=224)
    tmet = tstep(torch.from_numpy(images), torch.from_numpy(labels))
    _close(tmet["loss"].item(), float(jmet["loss"]), "loss")
    for k in ("batch", "correct@1", "correct@5"):
        assert float(tmet[k]) == float(jmet[k]), k
    assert int(new.step) == opt.count == 1


@pytest.mark.parametrize("name", ["mobilenetv2", "resnet18"])
def test_224_px_gradients_match_jax_in_float64(name):
    """The port's resize gives JAX's uint8 batch here (no .5 ties at 7x);
    both packages' convolutions and BN in float64 (the head's Dense in
    f32, as the JAX package fixes it): every gradient leaf within 1e-4
    of the largest, the step's BN statistics within 1e-4."""
    _, params, state, images, labels = _inputs(name)
    jbuild, tbuild, kw = BUILD[name]
    big = tloader.resize_batch(torch.from_numpy(images), 224)
    np.testing.assert_array_equal(
        big.numpy(), np.asarray(jloader.resize_batch(jnp.asarray(images),
                                                     224)))
    tm = tbuild(dtype=torch.float64, input_layout="imagenet", **kw)
    for m in tm.modules():
        if isinstance(m, (layers.Conv, layers.BatchNorm)):
            m.double()
    params_from_jax(tm, *(jax.tree.map(np.asarray, t)
                          for t in (params, state)), "cpu")
    logits, _ = tm.apply(tloader.normalize(big, CIFAR10_MEAN, CIFAR10_STD,
                                           torch.float64), train=True)
    ttrainer.cross_entropy(logits, torch.from_numpy(labels)).backward()
    tgrads, tstate = params_to_jax(tm, grads=True)

    with jax.enable_x64(True):
        jm = jbuild(dtype=jnp.float64, input_layout="imagenet", **kw)
        x = jloader.normalize(jnp.asarray(big.numpy()), CIFAR10_MEAN,
                              CIFAR10_STD, jnp.float64)

        def loss(p):
            y, new = jm.apply(p, jax.tree.map(jnp.asarray, state), x,
                              train=True)
            return optax.softmax_cross_entropy_with_integer_labels(
                y.astype(jnp.float32), jnp.asarray(labels)).mean(), new

        jgrads, jstate = jax.tree.map(np.asarray, jax.jit(jax.grad(
            loss, has_aux=True))(jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64), params)))
    _close_trees(tstate, jstate, "bn")
    gmax = max(float(np.abs(g).max()) for g in jax.tree.leaves(jgrads))
    for (path, g), w in zip(jax.tree.flatten_with_path(tgrads)[0],
                            jax.tree.leaves(jgrads), strict=True):
        err = float(np.abs(np.asarray(g, np.float64) - w).max())
        assert err <= RTOL * gmax, (jax.tree_util.keystr(path), err, gmax)
