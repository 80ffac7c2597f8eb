"""Checkpoint/resume of the port's LM trainer through the pipeline and
MoE: at 4 gloo ranks on ``MeshConfig(stage=2, expert=2)`` — a top-2 MoE
over 4 experts cut over the expert axis, interleaved 1F1B at
``virtual_stages=2``, 2 microbatches — a fit preempted by a
``step_hook`` at step 3 of epoch 0 and finished by ``LMTrainer(resume=
True)`` equals the uninterrupted fit bit for bit (per-step losses, the
parameters and optimizer state, the global step, the history), and the
checkpoint's blocks are in the interleaved storage order. The
uninterrupted history (train and held-out loss, the epoch's MoE drop
rate) equals the JAX ``LMTrainer``'s on the same mesh from the same
weights within 1e-4. A resume at ``virtual_stages=1`` is refused in the
JAX trainer's words. ``train_lm`` runs the same mesh from its flags."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_port_util import SHAPES, run_dirs
from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu.parallel import spmd_pipeline as jsp
from distributed_model_parallel_tpu.train import lm_trainer as jlm
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.parallel import spmd_pipeline as tsp
from distributed_model_parallel_tpu_torch.parallel import workers
from distributed_model_parallel_tpu_torch.train import lm_trainer as tlm
from distributed_model_parallel_tpu_torch.train import train_lm

pytestmark = pytest.mark.torch_port

ATOL = 1e-4
PREEMPT_AT = (0, 3)
LAYERS, S, V, M = 4, 2, 2, 2
MODEL = dict(SHAPES["mha"], n_layers=LAYERS, moe_experts=4, moe_top_k=2,
             ep_axis="expert")
MESH = dict(stage=2, expert=2)
COMMON = dict(batch_size=4, seq_len=16, steps_per_epoch=4, epochs=2,
              n_tokens=2000, eval_batches=2, num_microbatches=M,
              pipeline_schedule="1f1b", virtual_stages=V)


def _port_configs(root):
    make = lambda name, **kw: tlm.LMTrainConfig(
        model=ttfm.TransformerConfig(**MODEL),
        mesh=tconfig.MeshConfig(**MESH), device="cpu",
        **run_dirs(root, name), **{**COMMON, **kw})
    return {"full": make("full"), "cut": make("cut")}, {
        "virtual_stages_1": dataclasses.replace(
            make("cut", virtual_stages=1), pipeline_schedule="1f1b")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runs"))
    jt = jlm.LMTrainer(jlm.LMTrainConfig(
        model=jtfm.TransformerConfig(**MODEL),
        mesh=jconfig.MeshConfig(**MESH), **run_dirs(root, "jax"), **COMMON))
    tree = jax.tree.map(np.asarray, jt.params)          # storage order
    tree["blocks"] = jsp.deinterleave_block_rows(tree["blocks"], LAYERS, S,
                                                 V)
    configs, refused = _port_configs(root)
    out = tmesh.spawn(workers.on_meshes, 4, [
        (configs["full"].mesh, "lm_preempt_resume",
         (configs, tree, PREEMPT_AT, None, refused))],
        device="cpu", threads=1, timeout_s=300,
        store_dir=str(tmp_path_factory.mktemp("store")))
    return dict(port=[r[0] for r in out], jax_history=jt.fit(), tree=tree)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_resume_is_bitwise_at_four_ranks(runs):
    for rank in runs["port"]:
        full, cut = rank["full"], rank["cut"]
        assert rank["preempted_after"] == 0
        assert cut["steps"] == full["steps"]
        assert cut["global_step"] == full["global_step"] == 8
        for a, b in ((full["params"], cut["params"]),
                     (full["opt_state"], cut["opt_state"])):
            got = dict(_leaves(b))
            assert set(got) == set(dict(_leaves(a)))
            for key, leaf in _leaves(a):
                np.testing.assert_array_equal(got[key], leaf, err_msg=key)
        fh, ch = full["history"], cut["history"]
        assert [h["epoch"] for h in ch] == [h["epoch"] for h in fh] == [0, 1]
        assert [h["loss_val"] for h in ch] == [h["loss_val"] for h in fh]
        assert ch[1]["loss_train"] == fh[1]["loss_train"]
        assert ch[1]["moe_drop_rate"] == fh[1]["moe_drop_rate"]


def test_checkpoint_blocks_in_storage_order(runs):
    """The optimizer state and the checkpoint hold the blocks in the
    interleaved storage order: the canonical export interleaved is the
    storage tree, row for row."""
    full = runs["port"][0]["full"]
    canon = {k: torch.from_numpy(v) for k, v in
             full["params"]["blocks"].items()}
    stored = tsp.interleave_block_rows(canon, LAYERS, S, V)
    for key, leaf in full["storage"]["blocks"].items():
        np.testing.assert_array_equal(stored[key].numpy(), leaf,
                                      err_msg=key)
    assert not np.array_equal(full["storage"]["blocks"]["wo"],
                              full["params"]["blocks"]["wo"])


def test_history_matches_jax_trainer(runs):
    port = runs["port"][0]["full"]["history"]
    jax_h = runs["jax_history"]
    assert [h["epoch"] for h in port] == [h["epoch"] for h in jax_h]
    for a, b in zip(port, jax_h):
        np.testing.assert_allclose(
            [a["loss_train"], a["loss_val"], a["moe_drop_rate"]],
            [b["loss_train"], b["loss_val"], b["moe_drop_rate"]],
            atol=ATOL, rtol=0)


def test_resume_with_other_virtual_stages_raises(runs):
    for rank in runs["port"]:
        msg = rank["refused"]["virtual_stages_1"]
        assert msg is not None
        assert ("checkpoint was written with virtual_stages=2" in msg
                and "this run has virtual_stages=1" in msg)


def test_cli_runs_pipeline_and_moe(capsys, tmp_path):
    dirs = run_dirs(tmp_path)
    train_lm.main(["--device", "cpu", "--pp", "2", "--ep", "2",
                   "--moe-experts", "4", "--microbatches", "2",
                   "--schedule", "1f1b", "--virtual-stages", "2",
                   "--vocab", "64", "--d-model", "32", "--heads", "2",
                   "--layers", "4", "--d-ff", "64", "--seq-len", "16",
                   "--batch-size", "4", "--steps", "2", "--rope",
                   "--log-dir", dirs["log_dir"], "--checkpoint-dir",
                   dirs["checkpoint_dir"]])
    with open(os.path.join(dirs["log_dir"], "lm.jsonl")) as fh:
        records = [r for r in map(json.loads, fh)
                   if r.get("kind") == "epoch"]
    assert records and np.isfinite(records[-1]["loss_train"])
    assert 0.0 <= records[-1]["moe_drop_rate"] <= 1.0
    for argv, match in ((["--pp", "3", "--layers", "4"], "--layers must be "
                         "divisible by --pp"),
                        (["--ep", "3", "--moe-experts", "4"],
                         "--moe-experts must be divisible by --ep"),
                        (["--moe-experts", "2", "--moe-top-k", "3"],
                         r"--moe-top-k must be in \[1, --moe-experts=2\]")):
        with pytest.raises(SystemExit, match=match):
            train_lm.main(["--device", "cpu"] + argv)
