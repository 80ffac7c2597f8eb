"""The port's cost-balanced partitioning (``parallel/auto_partition.py``)
against the JAX package's: the minimax DP (== brute force, == JAX's on
seeded costs with ties), ``unit_costs`` per unit == JAX's XLA counts
(MobileNetV2 at microbatch rows 128 and tinycnn) and the boundaries they
give at 2, 3, 4 and 8 stages, ResNet-50's (with the ImageNet stem's max-pool,
which XLA counts as window − 1 comparisons per output) at 2 and 4 stages
in both layouts, and ``microbatch_rows``. JAX's MobileNetV2 and ResNet-50
costs compile every unit: computed once for the module."""

import itertools

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.models import get_model as jget_model
from distributed_model_parallel_tpu.parallel import auto_partition as jap
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch.models import get_model
from distributed_model_parallel_tpu_torch.models import layers as tlayers
from distributed_model_parallel_tpu_torch.parallel import auto_partition as tap

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROWS = {"mobilenetv2": 128, "tinycnn": 8}
# JAX's auto_boundaries for MobileNetV2 (CIFAR, 19 units) at microbatch
# rows 128, as the JAX package computes them on the CPU.
MOBILENET_CUTS = {2: [0, 11, 19], 3: [0, 7, 14, 19], 4: [0, 5, 11, 15, 19],
                  8: [0, 3, 4, 7, 11, 13, 15, 17, 19]}


@pytest.fixture(scope="module")
def jax_costs():
    return {name: jap.unit_costs(jget_model(jconfig.ModelConfig(name=name)),
                                 (rows, 32, 32, 3))
            for name, rows in ROWS.items()}


# ResNet-50's layouts at their input sizes: (rows, px), and the per-unit
# gap allowed. XLA's CPU cost analysis counts a reduction over a length
# that is not a power of two as a few elements longer (a mean over 6272
# rows costs 6300 per column, over 3136 costs 3166): the ImageNet layout's
# BN statistics at 112/56/28/14/7 px lengthen its units 1-4 by up to
# 0.26%, which the port does not model; the cuts agree all the same.
RESNET = {"cifar": (128, 32, 1e-6), "imagenet": (2, 224, 3e-3)}


@pytest.fixture(scope="module")
def resnet_costs():
    """Per layout, (JAX's unit costs, the port's) for ResNet-50."""
    out = {}
    for layout, (rows, px, _) in RESNET.items():
        extra = {"input_layout": layout}
        shape = (rows, px, px, 3)
        out[layout] = (
            jap.unit_costs(jget_model(jconfig.ModelConfig(
                name="resnet50", extra=extra)), shape),
            tap.unit_costs(get_model(tconfig.ModelConfig(
                name="resnet50", extra=extra), device="cpu"), shape))
    return out


def _port_costs(name):
    model = get_model(tconfig.ModelConfig(name=name), device="cpu")
    return tap.unit_costs(model, (ROWS[name], 32, 32, 3))


def _bottleneck(costs, bounds):
    return max(sum(costs[lo:hi]) for lo, hi in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_dp_matches_brute_force_and_jax(seed, s):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0.5, 10.0, size=9).tolist()
    got = tap.cost_balanced_boundaries(costs, s)
    best = min(_bottleneck(costs, [0, *c, 9])
               for c in itertools.combinations(range(1, 9), s - 1))
    assert _bottleneck(costs, got) == pytest.approx(best)
    assert got == jap.cost_balanced_boundaries(costs, s)
    # Integer costs with ties: the `<=` rule picks the same (latest) cut.
    ints = rng.integers(1, 4, size=9).tolist()
    assert (tap.cost_balanced_boundaries(ints, s)
            == jap.cost_balanced_boundaries(ints, s))


def test_dp_refuses_impossible_splits():
    for costs, s in (([1.0, 2.0], 3), ([1.0], 0)):
        with pytest.raises(ValueError):
            tap.cost_balanced_boundaries(costs, s)


@pytest.mark.parametrize("name", list(ROWS))
def test_unit_costs_match_jax_per_unit(jax_costs, name):
    """Every unit's count == XLA's within its float32 rounding (the JAX
    counts carry ~1e-7 relative noise)."""
    got, want = _port_costs(name), jax_costs[name]
    assert len(got) == len(want)
    gap = max(abs(g - w) / w for g, w in zip(got, want))
    assert gap <= 1e-6, gap


@pytest.mark.parametrize("stages", [2, 3, 4, 8])
def test_mobilenet_boundaries_match_jax(jax_costs, stages):
    got = tap.cost_balanced_boundaries(_port_costs("mobilenetv2"), stages)
    assert got == jap.cost_balanced_boundaries(jax_costs["mobilenetv2"],
                                               stages)
    assert got == MOBILENET_CUTS[stages]
    model = get_model(tconfig.ModelConfig(), device="cpu")
    assert tap.auto_boundaries(model, (128, 32, 32, 3), stages) == got


@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("layout", list(RESNET))
def test_resnet50_boundaries_match_jax(resnet_costs, layout, stages):
    """18 units; every unit's count == XLA's (the ImageNet stem's
    max-pool and the residual adds included; see RESNET for the ImageNet
    gap) and the cost-balanced cut == JAX's ``auto_boundaries``."""
    want, got = resnet_costs[layout]
    assert len(got) == len(want) == 18
    assert max(abs(g - w) / w for g, w in zip(got, want)) <= \
        RESNET[layout][2]
    assert (tap.cost_balanced_boundaries(got, stages)
            == jap.cost_balanced_boundaries(want, stages))


@pytest.mark.parametrize("size,stride,pads", [
    (32, 2, None), (7, 2, None), (16, 1, (1, 1)), (11, 2, (0, 1)),
    (9, 3, (2, 0))])
def test_conv_taps_with_explicit_padding(size, stride, pads):
    """Taps inside the input == the count over an explicit zero padding's
    window positions that land on the input."""
    k = 3
    lo, hi = pads if pads is not None else tlayers.same_padding(size, k,
                                                               stride)
    out = (size + lo + hi - k) // stride + 1
    want = sum(1 for o in range(out) for t in range(k)
               if 0 <= o * stride - lo + t < size)
    assert tap.conv_taps(size, k, stride, pads) == want


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_tinycnn_boundaries_match_jax(jax_costs, stages):
    got = tap.cost_balanced_boundaries(_port_costs("tinycnn"), stages)
    assert got == jap.cost_balanced_boundaries(jax_costs["tinycnn"], stages)


def test_conv_and_matmul_counts_alone_cut_elsewhere():
    """The trap the elementwise terms avoid: FlopCounterMode's convolution
    and matmul FLOPs alone put MobileNetV2's 2-stage cut one unit later
    than JAX's."""
    model = get_model(tconfig.ModelConfig(), device="cpu")
    x = torch.zeros(128, 32, 32, 3)
    costs = []
    with torch.no_grad():
        for i in range(model.num_units):
            with FlopCounterMode(display=False) as counter:
                x, _ = model.apply_unit(i, x, train=True)
            costs.append(counter.get_total_flops())
    assert tap.cost_balanced_boundaries(costs, 2) == [0, 12, 19]
    assert MOBILENET_CUTS[2] == [0, 11, 19]


@pytest.mark.parametrize("b,m,d", [(512, 4, 1), (512, 8, 2), (16, 32, 1),
                                   (128, 1, 4), (7, 0, 0)])
def test_microbatch_rows_matches_jax(b, m, d):
    assert tap.microbatch_rows(b, m, d) == jap.microbatch_rows(b, m, d)
