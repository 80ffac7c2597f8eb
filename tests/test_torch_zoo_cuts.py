"""The cost-balanced cuts of a narrow model chaining the zoo's blocks
(``models/zoo.py``) at 2 and 4 stages: the port's
``parallel/auto_partition.unit_costs`` against JAX's XLA counts per unit
(within float32 rounding, the DLA tree's duplicated BatchNorm tail
excepted: ``tests/test_torch_zoo_partition.py``) and the cuts equal."""

import jax
import pytest
import torch

from distributed_model_parallel_tpu.models import staged as jstaged
from distributed_model_parallel_tpu.parallel import auto_partition as jap
from distributed_model_parallel_tpu_torch.models import layers as tlayers
from distributed_model_parallel_tpu_torch.parallel import auto_partition as tap

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


class JitInitStagedModel(jstaged.StagedModel):
    """The JAX ``StagedModel`` with ``init`` compiled as one program:
    ``unit_costs`` inits the model before costing it, and flax's eager
    init (one compile per operation) was most of this file's time. The
    counts are the compiled units' either way."""

    def init(self, rng, sample):
        return jax.jit(super().init)(rng, sample)


def _narrow_zoo():
    """(JAX, port) StagedModels chaining zoo blocks at narrow widths."""
    from distributed_model_parallel_tpu.models import layers as jlayers
    from distributed_model_parallel_tpu.models import zoo as jzoo
    from distributed_model_parallel_tpu_torch.models import zoo as tzoo
    from distributed_model_parallel_tpu_torch.models.staged import (
        StagedModel,
    )

    junits = (jlayers.ConvUnit(ops=({"features": 8},)),
              jzoo.VGGUnit(features=16, pool=True),
              jzoo.PreActBlock(features=16, se_ratio=0.25),
              jzoo.Inception(spec=(4, 4, 6, 2, 4, 2)),
              jzoo.DenseBlock(num_layers=2, growth=4),
              jzoo.MBConv(expansion=6, features=16),
              jzoo.ShuffleV2Block(features=16),
              jzoo.ShuffleV1Block(features=32, stride=2),
              jzoo.DLATree(features=32, level=2))
    tunits = [tlayers.ConvUnit(3, ({"features": 8},)),
              tzoo.VGGUnit(8, 16, True), tzoo.PreActBlock(16, 16, 1, 0.25),
              tzoo.Inception(16, (4, 4, 6, 2, 4, 2)),
              tzoo.DenseBlock(16, 2, 4), tzoo.MBConv(12, 6, 16),
              tzoo.ShuffleV2Block(16, 16), tzoo.ShuffleV1Block(16, 32, 2, 2),
              tzoo.DLATree(32, 32, 2)]
    return JitInitStagedModel(units=junits), StagedModel(tunits)


@pytest.fixture(scope="module")
def narrow_zoo_costs():
    jm, tm = _narrow_zoo()
    shape = (4, 16, 16, 3)
    return jap.unit_costs(jm, shape), tap.unit_costs(tm, shape)


@pytest.mark.parametrize("stages", [2, 4])
def test_zoo_cuts_match_jax(narrow_zoo_costs, stages):
    """The cost-balanced cut of a narrow model chaining the zoo's blocks
    == JAX's ``auto_boundaries``; every unit but the DLA tree's within
    float32 rounding."""
    want, got = narrow_zoo_costs
    gaps = [abs(g - w) / w for g, w in zip(got, want)]
    assert max(gaps[:-1]) <= 1e-6 and gaps[-1] <= 2e-2, gaps
    assert (tap.cost_balanced_boundaries(got, stages)
            == jap.cost_balanced_boundaries(want, stages))
