"""Import guard: the port imports with ``jax`` blocked and loads nothing
of the JAX package; ``chip_smoke.py`` imports neither."""

import ast
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises
import pkgutil, importlib
import distributed_model_parallel_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "distributed_model_parallel_tpu"
             or m.startswith("distributed_model_parallel_tpu."))
print(" ".join(names), "|", bad)
"""

# Every module of the serving, LM training, CNN training, data-parallel
# and pipeline slices, ResNet, the remaining data-parallel engines and the
# sparse-gradient embedding path.
_MODULES = {
    "config", "models.transformer", "ops._build", "ops.paged_attention",
    "ops.flash_attention", "serve.engine", "serve.generate", "serve.model",
    "serve.paged_kv", "serve.scheduler", "train.lm_trainer", "train.optim",
    "train.metrics", "train.train_lm", "utils.profiling",
    "models.layers", "models.staged", "models.mobilenetv2", "models.tinycnn",
    "data.registry", "data.loader", "ops.collectives", "ops.fused_sgd",
    "train.trainer", "train.train_cnn",
    "mesh", "parallel.data_parallel", "parallel.ddp", "parallel.workers",
    "parallel.pipeline", "parallel.auto_partition",
    "parallel.spmd_cnn_pipeline", "train.pipeline_trainer",
    "train.train_model_parallel",
    "models.resnet", "models.embedding", "ops.ring_reduce", "ops.sparse",
    "parallel.zero", "parallel.fsdp",
}


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.strip().split(" | ")
    prefix = "distributed_model_parallel_tpu_torch."
    assert {prefix + m for m in _MODULES} <= set(names.split()), out.stdout
    assert bad == "[]", out.stdout


@pytest.mark.parametrize("path", [
    "chip_smoke.py",
    "distributed_model_parallel_tpu_torch",
])
def test_no_source_imports_jax(path):
    full = os.path.join(REPO, path)
    files = ([full] if full.endswith(".py") else
             [os.path.join(d, f) for d, _, fs in os.walk(full)
              for f in fs if f.endswith(".py")])
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib",
                                   "distributed_model_parallel_tpu"), (f, m)
