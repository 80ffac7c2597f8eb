"""The port's zoo blocks (``models/zoo.py``) against the JAX package's on
the same numpy weights (through the extended weight carrier): every
block class at narrow widths, outputs and BN statistics in train and
eval mode within 1e-4 (f32), the channel-shuffle order and the SAME
``avg_pool`` border pinned, and the ``bn_mode="none"``/``"sync"``
builds. Whole models: ``tests/test_torch_zoo_models.py``."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_model_parallel_tpu.models import zoo as jzoo
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch.models import get_model
from distributed_model_parallel_tpu_torch.models import zoo as tzoo
from distributed_model_parallel_tpu_torch.models.layers import BatchNorm
from tests.test_torch_cnn import _check_units, _x

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

# name -> (input NHWC shape, JAX block, port block), narrow widths.
BLOCKS = {
    "vgg_pool": ((2, 8, 8, 3), jzoo.VGGUnit(features=8, pool=True),
                 lambda: tzoo.VGGUnit(3, 8, True)),
    "vgg": ((2, 8, 8, 3), jzoo.VGGUnit(features=8),
            lambda: tzoo.VGGUnit(3, 8)),
    "preact_down": ((2, 8, 8, 8), jzoo.PreActBlock(features=16, stride=2),
                    lambda: tzoo.PreActBlock(8, 16, 2)),
    "preact_se": ((2, 8, 8, 16), jzoo.PreActBlock(features=16,
                                                  se_ratio=0.25),
                  lambda: tzoo.PreActBlock(16, 16, 1, 0.25)),
    "senet_down": ((2, 8, 8, 8), jzoo.PreActBlock(features=16, stride=2,
                                                  se_ratio=1 / 16),
                   lambda: tzoo.PreActBlock(8, 16, 2, 1 / 16)),
    "inception_pool": ((2, 8, 8, 8),
                       jzoo.Inception(spec=(4, 4, 6, 2, 4, 4),
                                      pool_after=True),
                       lambda: tzoo.Inception(8, (4, 4, 6, 2, 4, 4), True)),
    "dense": ((2, 8, 8, 8), jzoo.DenseBlock(num_layers=3, growth=4),
              lambda: tzoo.DenseBlock(8, 3, 4)),
    "dense_last": ((2, 4, 4, 8), jzoo.DenseBlock(num_layers=2, growth=4,
                                                 transition=False),
                   lambda: tzoo.DenseBlock(8, 2, 4, False)),
    "dense_head": ((2, 4, 4, 12), jzoo.DenseHead(num_classes=10),
                   lambda: tzoo.DenseHead(12, 10)),
    "resnext_down": ((2, 8, 8, 8), jzoo.ResNeXtBlock(cardinality=2, width=4,
                                                     stride=2),
                     lambda: tzoo.ResNeXtBlock(8, 2, 4, 2)),
    "resnext": ((2, 8, 8, 16), jzoo.ResNeXtBlock(cardinality=2, width=4),
                lambda: tzoo.ResNeXtBlock(16, 2, 4)),
    "depthwise": ((2, 8, 8, 8), jzoo.DepthwiseSeparable(features=16,
                                                        stride=2),
                  lambda: tzoo.DepthwiseSeparable(8, 16, 2)),
    "dpn_first": ((2, 8, 8, 8), jzoo.DPNBlock(width=32, out_planes=16,
                                              dense_depth=8, stride=2,
                                              first=True),
                  lambda: tzoo.DPNBlock(8, 32, 16, 8, 2, True)),
    "dpn": ((2, 4, 4, 24), jzoo.DPNBlock(width=32, out_planes=16,
                                         dense_depth=8),
            lambda: tzoo.DPNBlock(24, 32, 16, 8)),
    "shuffle1_down": ((2, 8, 8, 8), jzoo.ShuffleV1Block(features=24,
                                                        stride=2),
                      lambda: tzoo.ShuffleV1Block(8, 24, 2, 2)),
    "shuffle1_first": ((2, 8, 8, 6), jzoo.ShuffleV1Block(
        features=24, stride=2, first_group=True),
        lambda: tzoo.ShuffleV1Block(6, 24, 2, 2, True)),
    "shuffle1": ((2, 4, 4, 24), jzoo.ShuffleV1Block(features=24),
                 lambda: tzoo.ShuffleV1Block(24, 24)),
    "shuffle2_down": ((2, 8, 8, 8), jzoo.ShuffleV2Block(features=16,
                                                        stride=2),
                      lambda: tzoo.ShuffleV2Block(8, 16, 2)),
    "shuffle2": ((2, 4, 4, 16), jzoo.ShuffleV2Block(features=16),
                 lambda: tzoo.ShuffleV2Block(16, 16)),
    "mbconv_residual": ((2, 8, 8, 8), jzoo.MBConv(expansion=1, features=8),
                        lambda: tzoo.MBConv(8, 1, 8)),
    "mbconv_expand": ((2, 8, 8, 8), jzoo.MBConv(expansion=6, features=12,
                                                kernel=5, stride=2),
                      lambda: tzoo.MBConv(8, 6, 12, 5, 2)),
    "mbconv_expand_residual": ((2, 4, 4, 8), jzoo.MBConv(expansion=6,
                                                         features=8),
                               lambda: tzoo.MBConv(8, 6, 8)),
    "regnet_down": ((2, 8, 8, 8), jzoo.RegNetBlock(features=16, stride=2),
                    lambda: tzoo.RegNetBlock(8, 16, 2)),
    "dla_basic": ((2, 8, 8, 8), jzoo.DLABasic(features=16, stride=2),
                  lambda: tzoo.DLABasic(8, 16, 2)),
    "dla_tree1": ((2, 8, 8, 8), jzoo.DLATree(features=8, level=1),
                  lambda: tzoo.DLATree(8, 8, 1)),
    "dla_tree2": ((2, 8, 8, 8), jzoo.DLATree(features=16, level=2,
                                             stride=2),
                  lambda: tzoo.DLATree(8, 16, 2, 2)),
}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name, train):
    """One block on the port's (perturbed) weights through both packages:
    output and BN statistics within 1e-4 of the JAX block's."""
    shape, jblock, tblock = BLOCKS[name]
    _check_units([jblock], [tblock()], _x(shape, seed=len(name)), train,
                 seed=len(name))


def test_dla_tree_nests_as_flax_does():
    """The level-2 tree's parameters nest two levels deep, as flax's do:
    the carrier pairs ``left.left.conv0`` by path."""
    from distributed_model_parallel_tpu_torch.models.staged import (
        _unit_slots,
    )

    params, state = _unit_slots(tzoo.DLATree(8, 16, 2, 2))
    want = jzoo.DLATree(features=16, level=2, stride=2).init(
        jax.random.key(0), jnp.zeros((1, 8, 8, 8)), train=False)
    shapes = jax.tree.map(np.shape, want["params"])
    assert set(params) == set(shapes) == {"left", "right", "root",
                                          "root_bn"}
    assert set(params["left"]) == {"left", "right", "root", "root_bn"}
    assert (tuple(params["left"]["right"]["conv0"]["kernel"][0].shape)
            == (16, 16, 3, 3))
    assert set(state["left"]["left"]) == {"conv0_bn", "conv1_bn",
                                          "shortcut_bn"}
    assert "root" not in state and "root_bn" in state


def test_channel_shuffle_order():
    """The NCHW shuffle == JAX's NHWC shuffle on the same channels ==
    ``view(N, g, C/g, H, W).transpose(1, 2)``."""
    x = np.arange(2 * 3 * 3 * 12, dtype=np.float32).reshape(2, 3, 3, 12)
    for g in (2, 3, 4):
        want = np.asarray(jzoo._channel_shuffle(jnp.asarray(x), g))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = tzoo.channel_shuffle(xt, g)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
        alt = xt.reshape(2, g, 12 // g, 3, 3).transpose(1, 2).reshape(
            2, 12, 3, 3)
        np.testing.assert_array_equal(got.numpy(), alt.numpy())
    # channel j·g + i of the output is input channel i·(C/g) + j
    assert got[0, 1, 0, 0].item() == x[0, 0, 0, 3]


@pytest.mark.parametrize("size", [8, 7])
def test_avg_pool_same_border(size):
    """ShuffleNet v1's shortcut: flax's SAME average (0 low, 1 high on an
    even input, zeros counted, /9); torch's symmetric ``padding=1`` is
    another function."""
    x = _x((2, size, size, 4), seed=size)
    want = np.asarray(fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding="SAME"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tzoo.avg_pool_same(xt, 3, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    sym = F.avg_pool2d(xt, 3, 2, padding=1).permute(0, 2, 3, 1).numpy()
    if size % 2 == 0:
        assert not np.allclose(sym, want, atol=1e-3)


@pytest.mark.parametrize("bn", ["none", "sync"])
def test_bn_modes_build(bn):
    """``bn_mode="none"`` drops every BatchNorm and biases the convs;
    ``"sync"`` builds synchronized BatchNorms over the group given."""
    cfg = tconfig.ModelConfig(name="efficientnetb0", batchnorm=bn)
    if bn == "sync":
        with pytest.raises(ValueError, match="sync BatchNorm requires"):
            get_model(cfg, device="cpu")
        model = get_model(cfg, device="cpu", axis="data-group")
        bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
        assert bns and all(m.group == "data-group" for m in bns)
        return
    model = get_model(cfg, device="cpu")
    assert not any(isinstance(m, BatchNorm) for m in model.modules())
    y = model(torch.from_numpy(_x((2, 32, 32, 3))), True)
    assert y.shape == (2, 10) and torch.isfinite(y).all()
    # under "none" only the gates had a bias before; now every conv has one
    from distributed_model_parallel_tpu_torch.models.layers import Conv

    assert all(m.bias is not None for m in model.modules()
               if isinstance(m, Conv))
