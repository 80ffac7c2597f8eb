"""The port's LM training slice against the JAX package on the same f32
inputs and weights: ``lm_loss`` and its gradients (learned positions,
RoPE, GQA, window through the flash path), SGD steps against
``make_spmd_train_step`` on a one-device mesh, the lr schedule against
optax, the token stream and batch draws bit for bit, and
``LMTrainer.fit`` against the JAX trainer's losses. atol 1e-4 (f32 sums
in another order through two layers and the optimizer)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import (
    SHAPES,
    both_params,
    configs,
    numpy_params,
    run_dirs,
    t,
)
from distributed_model_parallel_tpu import config as jconfig
from distributed_model_parallel_tpu.mesh import make_mesh
from distributed_model_parallel_tpu.models import transformer as jtfm
from distributed_model_parallel_tpu.parallel.spmd_pipeline import (
    make_spmd_train_step,
    shard_params,
)
from distributed_model_parallel_tpu.train import lm_trainer as jlm
from distributed_model_parallel_tpu.train import optim as joptim
from distributed_model_parallel_tpu.utils.profiling import (
    lm_model_flops as j_lm_model_flops,
)
from distributed_model_parallel_tpu_torch import config as tconfig
from distributed_model_parallel_tpu_torch import mesh as tmesh
from distributed_model_parallel_tpu_torch.models import transformer as ttfm
from distributed_model_parallel_tpu_torch.parallel import spmd_lm
from distributed_model_parallel_tpu_torch.train import lm_trainer as tlm
from distributed_model_parallel_tpu_torch.train import optim as toptim
from distributed_model_parallel_tpu_torch.train import train_lm
from distributed_model_parallel_tpu_torch.utils.profiling import (
    lm_model_flops as t_lm_model_flops,
)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ATOL = 1e-4
# kind -> config overrides: the window model runs the flash path in both.
KINDS = {"learned": {}, "mha": {}, "gqa": {},
         "window": dict(attn_impl="flash")}


def _tokens(seed, b=2, t_len=24, vocab=64):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, t_len + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _flat(tree):
    """{"name": leaf} with blocks flattened to "blocks.x"."""
    out = {}
    for k, v in tree.items():
        if k == "blocks":
            out.update({f"blocks.{bk}": bv for bk, bv in v.items()})
        else:
            out[k] = v
    return out


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, ref, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(ref), atol=atol, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("kind", list(KINDS))
def test_lm_loss_and_grads_match_jax(kind):
    jcfg, tcfg, jp, tp = both_params(kind, **KINDS[kind])
    toks, tgts = _tokens(0)
    loss_ref, g_ref = jax.value_and_grad(jtfm.lm_loss)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg)
    leaves = _flat(tp)
    for v in leaves.values():
        v.requires_grad_(True)
    loss = ttfm.lm_loss(tp, t(toks).long(), t(tgts).long(), tcfg)
    loss.backward()
    _close(loss, loss_ref)
    for name, ref in _flat(g_ref).items():
        _close(leaves[name].grad, ref, what=name)


def test_xla_impl_matches_flash_impl_and_window_needs_flash():
    _, tcfg, _, tp = both_params("mha")
    toks, tgts = (t(x).long() for x in _tokens(1))
    losses = [ttfm.lm_loss(tp, toks, tgts, dataclasses.replace(
        tcfg, attn_impl=impl)) for impl in ("auto", "flash", "xla")]
    for x in losses[1:]:
        _close(x, losses[0], atol=1e-5)
    _, wcfg, _, wp = both_params("window")
    with pytest.raises(ValueError, match="attn_impl='flash'"):
        ttfm.lm_loss(wp, toks, tgts, wcfg)
    with pytest.raises(ValueError, match="attn impl"):
        ttfm.TransformerConfig(attn_impl="pallas")


OPTIMIZERS = {
    "momentum_nesterov_wd_clip": dict(learning_rate=0.05, momentum=0.9,
                                      nesterov=True, weight_decay=1e-2,
                                      grad_clip_norm=0.5, warmup_steps=1),
    "lm_default": dict(learning_rate=0.1, weight_decay=0.0),
    "no_momentum": dict(learning_rate=0.1, momentum=0.0, weight_decay=1e-3,
                        grad_clip_norm=100.0),
}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_sgd_steps_match_jax_spmd_train_step(opt):
    """Two steps (the second reads the momentum buffer) against the JAX
    step on a one-device mesh: losses and updated parameters."""
    jcfg, tcfg, _, tp = both_params("gqa")
    tree = numpy_params(tcfg)
    jopt = jconfig.OptimizerConfig(**OPTIMIZERS[opt])
    spec = make_mesh(jconfig.MeshConfig(data=1))
    tx = joptim.make_optimizer(jopt, 5, 1)
    jp = shard_params(jax.tree.map(jnp.asarray, tree), jcfg, spec)
    opt_state = tx.init(jp)
    jstep = make_spmd_train_step(jcfg, spec, tx)
    leaves = _flat(tp)
    for v in leaves.values():
        v.requires_grad_(True)
    optimizer = toptim.make_optimizer(
        tconfig.OptimizerConfig(**OPTIMIZERS[opt]), 5, 1, leaves.values())
    tstep = spmd_lm.make_spmd_train_step(
        tcfg, tmesh.make_mesh(tconfig.MeshConfig(), "cpu"), optimizer,
        list(leaves.values()))
    for seed in (2, 3):
        toks, tgts = _tokens(seed)
        jp, opt_state, jm = jstep(jp, opt_state, jnp.asarray(toks),
                                  jnp.asarray(tgts))
        tm = tstep(tp, t(toks).long(), t(tgts).long())
        _close(tm["loss"], jm["loss"])
    for name, ref in _flat(jp).items():
        _close(leaves[name], ref, what=name)


@pytest.mark.parametrize("warmup, decay", [(0, None), (5, None), (5, 12)])
def test_schedule_matches_optax(warmup, decay):
    kw = dict(learning_rate=0.3, warmup_steps=warmup,
              cosine_decay_steps=decay)
    ref = joptim.make_schedule(jconfig.OptimizerConfig(**kw), 10, 2)
    got = toptim.make_schedule(tconfig.OptimizerConfig(**kw), 10, 2)
    np.testing.assert_allclose([got(n) for n in range(30)],
                               [float(ref(n)) for n in range(30)],
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("bad,match", [
    (dict(fused=True, name="adamw"), "fused implements the sgd recipe"),
    (dict(ema_decay=0.999), "ema_decay is implemented by the data-parallel"),
])
def test_unported_optimizer_options_raise(bad, match):
    """What the JAX package refuses, in its words: ``fused`` with another
    optimizer (make_optimizer) and EMA on the LM trainer. adamw and
    accumulation run (test_fit_with_optimizer_matches_jax)."""
    with pytest.raises(ValueError, match=match):
        if "ema_decay" in bad:
            _, tcfg = configs("mha")
            tlm.LMTrainer(tlm.LMTrainConfig(
                model=tcfg, device="cpu", n_tokens=500,
                optimizer=tconfig.OptimizerConfig(**bad)))
        toptim.make_optimizer(tconfig.OptimizerConfig(**bad), 5, 1,
                              [torch.zeros(2, requires_grad=True)])


def _lm_configs(tmp_path, kind="mha", **kw):
    """(JAX LMTrainConfig on a one-device mesh, port LMTrainConfig)."""
    jcfg, tcfg = configs(kind)
    common = {**dict(batch_size=4, seq_len=16, steps_per_epoch=3, epochs=2,
                     n_tokens=2000, eval_batches=2), **kw}
    jc = jlm.LMTrainConfig(
        model=jcfg, mesh=jconfig.MeshConfig(data=1),
        log_dir=os.path.join(str(tmp_path), "log"),
        checkpoint_dir=os.path.join(str(tmp_path), "ckpt"), **common)
    return jc, tlm.LMTrainConfig(model=tcfg, device="cpu",
                                 **run_dirs(tmp_path, "port"), **common)


def test_token_stream_and_batches_are_bitwise_equal(tmp_path):
    np.testing.assert_array_equal(tlm.make_token_stream(64, 3000, seed=5),
                                  jlm.make_token_stream(64, 3000, seed=5))
    jc, tc = _lm_configs(tmp_path)
    jt, tt = jlm.LMTrainer(jc), tlm.LMTrainer(tc)
    for epoch, step in ((0, 0), (1, 2), (7, 11)):
        for a, b in zip(tt.sample_batch(epoch, step),
                        jt.sample_batch(epoch, step)):
            np.testing.assert_array_equal(a, b)
    for (ta, tb), (ja, jb) in zip(tt.eval_batches(), jt.eval_batches()):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("kw, eval_on", [
    (dict(eval_batches=None), True),
    (dict(eval_batches=None, n_tokens=150), False),
    (dict(eval_batches=0), False),
])
def test_eval_rule_matches_jax(tmp_path, kw, eval_on):
    jc, tc = _lm_configs(tmp_path, **kw)
    jt, tt = jlm.LMTrainer(jc), tlm.LMTrainer(tc)
    assert tt.eval_enabled == (jt._eval_loss is not None) == eval_on
    assert (tt._n_train, tt._n_eval_batches) == (jt._n_train,
                                                 jt._n_eval_batches)


def test_fit_matches_jax_trainer(tmp_path):
    """2 epochs x 3 steps from the JAX trainer's initial parameters:
    per-step losses, loss_train and loss_val within 1e-4."""
    jc, tc = _lm_configs(tmp_path)
    jt = jlm.LMTrainer(jc)
    tree = jax.tree.map(np.asarray, jt.params)     # before the donating fit
    tt = tlm.LMTrainer(tc, params=ttfm.params_from_jax(tree, tc.model,
                                                       "cpu"))
    jhist, thist = jt.fit(), tt.fit()
    with open(jt.logger.jsonl_path) as fh:
        jsteps = [r for r in map(json.loads, fh) if r.get("kind") == "step"]
    assert [(r["epoch"], r["step"]) for r in jsteps] == [
        (r["epoch"], r["step"]) for r in tt.step_log]
    _close([r["loss"] for r in tt.step_log], [r["loss"] for r in jsteps])
    assert len(thist) == len(jhist) == 2
    for a, b in zip(thist, jhist):
        assert set(a) == {"epoch", "loss_train", "loss_val",
                          "time_per_batch", "time_load_per_batch",
                          "tokens_per_s"} <= set(b)
        _close([a["loss_train"], a["loss_val"]],
               [b["loss_train"], b["loss_val"]])


@pytest.mark.parametrize("opt", [
    dict(name="adamw", learning_rate=0.01, weight_decay=1e-2),
    dict(accum_steps=2),
])
def test_fit_with_optimizer_matches_jax(tmp_path, opt):
    """adamw, and SGD under accum_steps 2 (the schedule in update
    units), through the LM trainer from the JAX trainer's initial
    parameters: losses per step and per epoch within 1e-4."""
    common = dict(optimizer=jconfig.OptimizerConfig(**opt))
    jc, tc = _lm_configs(tmp_path, **common)
    tc = dataclasses.replace(tc, optimizer=tconfig.OptimizerConfig(**opt))
    jt = jlm.LMTrainer(jc)
    tree = jax.tree.map(np.asarray, jt.params)
    tt = tlm.LMTrainer(tc, params=ttfm.params_from_jax(tree, tc.model,
                                                       "cpu"))
    jhist, thist = jt.fit(), tt.fit()
    with open(jt.logger.jsonl_path) as fh:
        jsteps = [r for r in map(json.loads, fh) if r.get("kind") == "step"]
    _close([r["loss"] for r in tt.step_log], [r["loss"] for r in jsteps])
    for a, b in zip(thist, jhist):
        _close([a["loss_train"], a["loss_val"]],
               [b["loss_train"], b["loss_val"]])


# remat, loss_chunk, sp_axis, sp_impl and tp_axis are ported: their cases
# moved to test_formerly_refused_options_train below (the mesh runs are
# tests/test_torch_lm_mesh.py). MoE is ported too: its two cases, which
# raised, now train.
@pytest.mark.parametrize("bad", [dict(moe_experts=4), dict(ep_axis="expert")])
def test_unported_model_options_raise(tmp_path, bad):
    """The model options that raised run now (the expert axis's meshes are
    tests/test_torch_lm_moe_mesh.py): on a one-device mesh from the JAX
    trainer's weights, the per-step losses, and for MoE the router's stats
    and each epoch's drop rate, equal the JAX LMTrainer's within 1e-4."""
    jc, tc = _lm_configs(tmp_path)
    jc = dataclasses.replace(jc, model=dataclasses.replace(jc.model, **bad))
    tc = dataclasses.replace(tc, model=dataclasses.replace(tc.model, **bad))
    jt = jlm.LMTrainer(jc)
    tt = tlm.LMTrainer(tc, params=ttfm.params_from_jax(
        jax.tree.map(np.asarray, jt.params), tc.model, "cpu"))
    jhist, thist = jt.fit(), tt.fit()
    with open(jt.logger.jsonl_path) as fh:
        jsteps = [r for r in map(json.loads, fh) if r.get("kind") == "step"]
    _close([r["loss"] for r in tt.step_log], [r["loss"] for r in jsteps])
    if bad.get("moe_experts"):
        assert all({"moe_balance", "moe_z", "moe_drop"} <= set(r)
                   for r in tt.step_log)
        _close([h["moe_drop_rate"] for h in thist],
               [h["moe_drop_rate"] for h in jhist])
    else:
        assert "moe_drop_rate" not in thist[0]


@pytest.mark.parametrize("kw", [
    dict(remat=True), dict(loss_chunk=8), dict(sp_axis="seq"),
    dict(sp_impl="ulysses"), dict(tp_axis="model"),
])
def test_formerly_refused_options_train(tmp_path, kw):
    """Options the one-device slice refused run now: on a one-device mesh
    (seq and model axes of size 1) two steps from the same weights give
    the plain model's losses within 1e-5."""
    _, base = configs("mha")
    losses = []
    for cfg in (base, dataclasses.replace(base, **kw)):
        tree = numpy_params(base)        # the trainer updates it in place
        tt = tlm.LMTrainer(
            tlm.LMTrainConfig(model=cfg, device="cpu", batch_size=2,
                              seq_len=16, steps_per_epoch=2, n_tokens=500,
                              eval_batches=0,
                              **run_dirs(tmp_path, str(len(losses)))),
            params=ttfm.params_from_jax(tree, cfg, "cpu"))
        tt.fit()
        losses.append([r["loss"] for r in tt.step_log])
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-5, rtol=0)


def test_generate_refused_by_name():
    """``generate`` is ported (tests/test_torch_generate.py); what it still
    refuses, it refuses by the JAX package's words, before touching the
    params."""
    _, tcfg = configs("mha")
    params = {"embed": torch.zeros(1)}
    with pytest.raises(ValueError, match="steps must be >= 1"):
        ttfm.generate(params, tcfg, [[1, 2]], 0)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        ttfm.generate(params, tcfg, [[1, 2]], tcfg.max_seq_len)
    with pytest.raises(ValueError, match="not divisible by prefill_chunk"):
        ttfm.generate(params, tcfg, [[1, 2, 3]], 3, prefill_chunk=2)
    moe = dataclasses.replace(tcfg, moe_experts=4, ep_axis="expert")
    with pytest.raises(ValueError, match="expert-parallel decode is not "
                                         "implemented"):
        ttfm.generate_sharded(params, moe, [[1, 2]], 3, None)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    _, tcfg = configs("mha")
    with pytest.raises(RuntimeError, match="cuda"):
        tlm.LMTrainer(tlm.LMTrainConfig(model=tcfg, n_tokens=500))


@pytest.mark.parametrize("kind", list(KINDS))
def test_lm_model_flops_matches_jax(kind):
    jcfg, tcfg = configs(kind)
    assert t_lm_model_flops(tcfg, 3, 40) == j_lm_model_flops(jcfg, 3, 40)


def test_cli_trains_on_cpu_and_refuses_unported_flags(capsys, tmp_path):
    dirs = run_dirs(tmp_path)
    train_lm.main(["--device", "cpu", "--vocab", "64", "--d-model", "32",
                   "--heads", "2", "--layers", "1", "--d-ff", "64",
                   "--seq-len", "16", "--batch-size", "2", "--steps", "2",
                   "--rope", "--log-dir", dirs["log_dir"],
                   "--checkpoint-dir", dirs["checkpoint_dir"]])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["epoch"] == 0 and np.isfinite(record["loss_train"])
    # --resume, --pp and --ep are ported (tests/test_torch_lm_resume.py,
    # test_torch_lm_pipeline_resume.py); so are the resilience flags.
    cfg = train_lm.build_config(train_lm.parse_args(
        ["--device", "cpu", "--emergency-every", "2", "--elastic",
         "--consistency-every", "3", "--recovery-retries", "1"]))
    assert (cfg.emergency_every, cfg.elastic, cfg.consistency_every,
            cfg.recovery.max_retries) == (2, True, 3, 1)
