"""The port's generate CLI (``serve/generate.py``) on checkpoints the port's
``train_lm`` wrote, on the CPU: it restores the ``lm`` slot and prints the
greedy tokens the JAX package's ``generate`` gives on those weights — for a
plain run and for a ``--pp 2 --virtual-stages 2`` run, whose block rows it
de-interleaves (checked with the JAX package's ``deinterleave_block_rows``);
without ``--pp-stages`` it refuses in the JAX script's words; ``--tp 2``
(two gloo ranks, ``generate_sharded``) prints the engine's tokens; MoE
decodes through ``generate``; a checkpoint of another shape is refused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu.parallel.spmd_pipeline import (
    deinterleave_block_rows,
)
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.serve import generate as cli
from distributed_model_parallel_tpu_torch.train import train_lm
from distributed_model_parallel_tpu_torch.train.checkpoint import (
    Checkpointer,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

SHAPE = ["--vocab", "64", "--d-model", "32", "--heads", "4", "--layers",
         "4", "--d-ff", "64", "--rope"]
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
           max_seq_len=128, pos_embedding="rope")
PROMPT = [5, 17, 42, 9]
STEPS = 8


def _train(tmp_path, name: str, *flags) -> str:
    ckpt = str(tmp_path / name / "ckpt")
    train_lm.main(["--device", "cpu", *SHAPE, "--seq-len", "16",
                   "--batch-size", "4", "--steps", "2", "--lr", "0.5",
                   "--log-dir", str(tmp_path / name / "log"),
                   "--checkpoint-dir", ckpt, *flags])
    return ckpt


def _jax_tokens(ckpt: str, deinterleave: tuple | None = None) -> list:
    """JAX's greedy ``generate`` on the checkpoint's params (blocks
    de-interleaved by the JAX package's own function when asked)."""
    specs = ttfm.param_specs(ttfm.TransformerConfig(**CFG))
    template = {k: ({bk: np.zeros(bs[0], np.float32) for bk, bs in s.items()}
                    if k == "blocks" else np.zeros(s[0], np.float32))
                for k, s in specs.items()}
    tree = Checkpointer(ckpt).restore_subtree({"params": template},
                                              "lm")["params"]
    jp = jax.tree.map(jnp.asarray, tree)
    if deinterleave:
        jp["blocks"] = deinterleave_block_rows(jp["blocks"], 4,
                                               *deinterleave)
    out = jtfm.generate(jp, jtfm.TransformerConfig(**CFG),
                        jnp.asarray([PROMPT], jnp.int32), STEPS)
    return [int(t) for t in np.asarray(out)[0]]


def _cli(ckpt: str, *flags) -> list:
    return cli.main(["--device", "cpu", *SHAPE, "--checkpoint-dir", ckpt,
                     "--prompt", ",".join(map(str, PROMPT)),
                     "--gen-steps", str(STEPS), *flags])


def test_cli_decodes_a_train_lm_checkpoint(tmp_path, capsys):
    ckpt = _train(tmp_path, "plain")
    capsys.readouterr()
    tokens = _cli(ckpt)
    out = capsys.readouterr()
    assert "restored LM checkpoint" in out.err
    assert out.out.strip() == ",".join(map(str, tokens))
    assert tokens == _jax_tokens(ckpt)
    # Random weights decode differently: the restore took effect.
    assert tokens != _cli(str(tmp_path / "none"))
    with pytest.raises(SystemExit, match="does not match the model flags"):
        _cli(ckpt, "--kv-heads", "2")


def test_cli_deinterleaves_virtual_stages(tmp_path, capsys):
    ckpt = _train(tmp_path, "v2", "--pp", "2", "--virtual-stages", "2",
                  "--schedule", "1f1b", "--microbatches", "2")
    with pytest.raises(SystemExit, match="pass --pp-stages equal to the "
                                         "training stage count"):
        _cli(ckpt)
    capsys.readouterr()
    tokens = _cli(ckpt, "--pp-stages", "2")
    assert "de-interleaved blocks (virtual_stages=2, S=2)" in (
        capsys.readouterr().err)
    assert tokens == _jax_tokens(ckpt, deinterleave=(2, 2))


def test_cli_tensor_parallel_and_moe(tmp_path, capsys):
    """``--tp 2`` over two gloo ranks prints the one-rank engine's greedy
    tokens; ``--moe-experts 4`` decodes random MoE weights through
    ``generate`` (noted on stderr), as ``generate`` does on them."""
    none = str(tmp_path / "none")
    assert _cli(none, "--tp", "2") == _cli(none)
    capsys.readouterr()
    tokens = _cli(none, "--moe-experts", "4", "--seed", "3")
    assert "decoding via models.transformer.generate" in (
        capsys.readouterr().err)
    cfg = ttfm.TransformerConfig(**CFG, moe_experts=4, moe_top_k=2)
    want = ttfm.generate(ttfm.init_params(cfg, seed=3, device="cpu"), cfg,
                         [PROMPT], STEPS, seed=4)
    assert tokens == want[0].tolist()
