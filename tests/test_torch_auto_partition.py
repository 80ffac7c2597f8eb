"""The port's cost-balanced partitioning (``parallel/auto_partition.py``)
against the JAX package's: the minimax DP (== brute force, == JAX's on
seeded costs with ties), ``unit_costs`` per unit == JAX's XLA counts
(MobileNetV2 at microbatch rows 128 and tinycnn) and the boundaries they
give at 2, 3, 4 and 8 stages, and ``microbatch_rows``. JAX's MobileNetV2
costs compile 19 units: computed once for the module."""

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
