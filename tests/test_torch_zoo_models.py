"""The port's 16 zoo models (``get_model`` on the CPU) against the JAX
package's: each one's parameter count and leaf count (JAX's through
``jax.eval_shape`` of ``init``, nothing compiled), the weight carrier's
name pairing round-tripping a seeded numpy tree in the JAX layout.
Logits: ``tests/test_torch_zoo_logits.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.models import get_model as jget_model
from distributed_model_parallel_tpu_torch.models import (
    params_from_jax,
    params_to_jax,
)
from distributed_model_parallel_tpu_torch.models.zoo import ZOO_BUILDERS

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

# name -> (parameters, leaves, units) of the JAX package's model.
COUNTS = {
    "vgg11": (9228362, 26, 9), "vgg13": (9413066, 32, 11),
    "vgg16": (14724042, 41, 14), "vgg19": (20035018, 50, 17),
    "preactresnet18": (11171210, 55, 10), "senet18": (11260290, 87, 10),
    "googlenet": (6158346, 194, 11), "densenet121": (6956362, 363, 6),
    "resnext29_2x64d": (9130314, 95, 11), "mobilenetv1": (3217226, 83, 15),
    "dpn92": (34236634, 287, 32), "shufflenetg2": (888158, 149, 18),
    "shufflenetv2": (1263854, 170, 18), "efficientnetb0": (3598598, 210, 18),
    "regnetx_200mf": (2321946, 134, 15), "simpledla": (15142970, 119, 8),
}


def _jax_shapes(name):
    """(params, batch_stats) of the JAX model at 32 px, as trees of
    ``ShapeDtypeStruct``."""
    model = jget_model(jconfig.ModelConfig(name=name))
    return model, jax.eval_shape(lambda k, x: model.init(k, x),
                                 jax.random.key(0), jnp.zeros((1, 32, 32, 3)))


def _numpy_trees(shapes, seed):
    """Seeded float32 trees of the given shapes: kernels N(0, 1/fan-in),
    BN scales near 1, biases and means near 0, variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, struct):
        name, shape = str(path[-1].key), struct.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name == "scale":
            return (1 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.random(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return tuple(jax.tree_util.tree_map_with_path(leaf, t) for t in shapes)


def _port(name):
    """The port's model, uninitialized (the trees are loaded into it)."""
    return ZOO_BUILDERS[name](num_classes=10)


@pytest.mark.parametrize("name", list(ZOO_BUILDERS))
def test_counts_and_carrier_round_trip(name):
    """Parameters, leaves and units == the JAX model's; a seeded numpy
    tree in the JAX layout loads by name and comes back bit for bit."""
    _, (pshapes, sshapes) = _jax_shapes(name)
    leaves = jax.tree.leaves(pshapes)
    n = sum(int(np.prod(s.shape)) for s in leaves)
    assert (n, len(leaves), len(pshapes)) == COUNTS[name]
    model = _port(name)
    ps = list(model.parameters())
    assert (sum(p.numel() for p in ps), len(ps),
            model.num_units) == COUNTS[name]
    params, state = _numpy_trees((pshapes, sshapes), seed=1)
    params_from_jax(model, params, state, "cpu")
    back = params_to_jax(model)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves((params,
                                                                 state))):
        np.testing.assert_array_equal(got, want)
    assert (jax.tree.structure(back)
            == jax.tree.structure((params, state)))
