"""Whole-model logits of the port's zoo (``get_model``'s models) against
the JAX package's at batch 2, 32 px, in eval mode, on the same seeded
weights and BN statistics, within 1e-4 (f32). The members heaviest to
run here are marked slow; every block they are built of is held against
JAX in ``tests/test_torch_zoo.py``."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu_torch.models import params_from_jax
from distributed_model_parallel_tpu_torch.models.zoo import ZOO_BUILDERS
from tests.test_torch_cnn import _close, _x
from tests.test_torch_zoo_models import _jax_shapes, _numpy_trees, _port

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

HEAVY = ("dpn92", "densenet121", "vgg19", "googlenet", "vgg16")


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n in HEAVY else n
    for n in ZOO_BUILDERS])
def test_logits_match_jax(name):
    """Eval-mode logits of the whole model at batch 2, 32 px, on the same
    seeded weights and BN statistics."""
    jmodel, shapes = _jax_shapes(name)
    params, state = _numpy_trees(shapes, seed=2)
    model = params_from_jax(_port(name), params, state, "cpu")
    x = _x((2, 32, 32, 3), seed=3)
    want, _ = jax.jit(partial(jmodel.apply, train=False))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
        jnp.asarray(x))
    with torch.no_grad():
        got, _ = model.apply(torch.from_numpy(x), train=False)
    _close(got.numpy(), np.asarray(want), name)
