"""Shared inputs for the torch-port tests: one small model shape in both
packages and one numpy parameter tree (from a seed) that feeds both."""

import os

import jax.numpy as jnp
import numpy as np
import torch

from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu_torch.models import transformer as ttfm

# tests/test_serve.py's model (vocab 64, d 32, 4 heads, 2 layers, RoPE),
# multi-head, grouped-query and sliding-window; and the multi-head model
# with a learned position table.
SHAPES = {
    "learned": dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                    d_ff=64, max_seq_len=128),
    "mha": dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq_len=128, pos_embedding="rope"),
    "gqa": dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq_len=128, pos_embedding="rope", n_kv_heads=2),
    "window": dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                   d_ff=64, max_seq_len=128, pos_embedding="rope",
                   attn_window=6),
}


def configs(kind: str, **kw):
    """(JAX config, port config), float32, with overrides ``kw``."""
    return (jtfm.TransformerConfig(**SHAPES[kind], **kw),
            ttfm.TransformerConfig(**SHAPES[kind], **kw))


def numpy_params(tcfg, seed: int = 0) -> dict:
    """A parameter tree of float32 numpy arrays in the shared layout, with
    non-trivial layer-norm scales and biases."""
    rng = np.random.default_rng(seed)

    def make(spec):
        shape, init = spec
        if init == "ones":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if init == "zeros":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (rng.standard_normal(shape) * init).astype(np.float32)

    return {k: ({bk: make(bs) for bk, bs in s.items()}
                if k == "blocks" else make(s))
            for k, s in ttfm.param_specs(tcfg).items()}


def both_params(kind: str, seed: int = 0, **kw):
    """(jcfg, tcfg, JAX params, port params) from one numpy tree."""
    jcfg, tcfg = configs(kind, **kw)
    tree = numpy_params(tcfg, seed)
    jp = {k: ({bk: jnp.asarray(bv) for bk, bv in v.items()}
              if k == "blocks" else jnp.asarray(v)) for k, v in tree.items()}
    return jcfg, tcfg, jp, ttfm.params_from_jax(tree, tcfg, "cpu")


def t(x) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor."""
    return torch.from_numpy(np.array(x))


def run_dirs(root, name: str = "run") -> dict:
    """A port ``TrainConfig``'s ``log_dir``, ``log_name`` and
    ``checkpoint_dir`` under ``root`` (a test's temporary directory), so
    that no test run writes logs or checkpoints into the working
    directory and runs under one root share neither."""
    base = os.path.join(str(root), name)
    return dict(log_dir=os.path.join(base, "log"), log_name=name,
                checkpoint_dir=os.path.join(base, "checkpoint"))


def cli_dirs(root) -> list:
    """:func:`run_dirs` as ``train_cnn`` flags."""
    d = run_dirs(root)
    return ["--log-dir", d["log_dir"], "--checkpoint-dir",
            d["checkpoint_dir"]]
