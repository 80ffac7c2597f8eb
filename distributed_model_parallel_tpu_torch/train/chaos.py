"""Chaos drills: injected faults must be detected, repaired and survived —
the port's counterpart of ``scripts/dmp_chaos.py``.

    python -m distributed_model_parallel_tpu_torch.train.chaos --scenario nan
    python -m distributed_model_parallel_tpu_torch.train.chaos \\
        --scenario bitflip --device cpu

``--device`` defaults to ``cuda``; ``--device cpu`` runs the drill on the
CPU.

Each scenario runs a tiny data-parallel CNN fit (tinycnn, synthetic data,
batch 32 over 96 rows: 3 steps an epoch) with a deterministic fault plan
(``utils/faults.py``) and checks that the detection and recovery closed
the loop (``train/resilience.py``, ``train/consistency.py``). It prints
the run's failure/recovery/consistency records and ONE JSON summary line
with the JAX drill's keys, and exits 1 when the fault was not injected,
not detected or not recovered (2 for a flag the scenario does not read).

Scenarios (``--scenario``):

* ``nan`` (default) — an injected NaN loss: the guards detect it, the
  supervisor restores the last good checkpoint, shrinks the LR and
  retries; training completes.
* ``bitflip`` — silent corruption: one bit of one data replica's
  parameters flipped (4 ranks). The sentinel detects it within one
  cadence and repairs it by broadcast from the good majority; the final
  parameters equal an uninjected run's bit for bit.
* ``desync`` — drift on 2 replicas: both finite, they disagree, so there
  is no quorum; the good-slot restore takes over and the run completes.
* ``overhead`` — no faults: the sentinel's cost at a cadence of 10 steps,
  from its own ``consistency_check_s`` timings against the run's step
  time (2 ranks; an off/on pair of step times rides along as a
  diagnostic).
* ``preempt`` — a run at 4 ranks preempted mid-epoch (an injected
  ``preempt`` fault), restarted at 4 ranks (bitwise the uninterrupted
  run) and at 2 (the exact global step, nothing replayed or skipped,
  through the resharded restore).

Ranks are processes of ``mesh.spawn``: gloo on the CPU; on the card
NCCL with a card a rank when there are enough cards, else gloo sharing
one. The rank functions return numpy.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

TRAIN_ROWS, BATCH = 96, 32
STEPS_PER_EPOCH = TRAIN_ROWS // BATCH


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenario", default="nan",
                   choices=["nan", "bitflip", "desync", "overhead",
                            "preempt"])
    p.add_argument("--epochs", default=None, type=int,
                   help="epochs per drill run (default 2; overhead pins 1)")
    p.add_argument("--faults", default=None,
                   help="override the scenario's fault plan (nan, bitflip, "
                        "desync)")
    p.add_argument("--retries", default=None, type=int,
                   help="recovery retry budget (default 2)")
    p.add_argument("--lr-shrink", default=None, type=float,
                   help="LR shrink on non-finite recovery (nan only; "
                        "default 0.5)")
    p.add_argument("--consistency-every", default=None, type=int,
                   help="sentinel cadence for bitflip/desync (default 1)")
    p.add_argument("--workdir", default=None,
                   help="log/checkpoint root (default: a fresh temp dir)")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    return p.parse_args(argv)


def _config(workdir: str, name: str, device: str, **kw):
    from distributed_model_parallel_tpu_torch.config import (
        DataConfig,
        MeshConfig,
        ModelConfig,
        OptimizerConfig,
        TrainConfig,
    )

    defaults = dict(
        model=ModelConfig(name="tinycnn"),
        data=DataConfig(name="synthetic", batch_size=BATCH,
                        eval_batch_size=BATCH,
                        synthetic_train_size=TRAIN_ROWS,
                        synthetic_eval_size=32),
        optimizer=OptimizerConfig(learning_rate=0.1, warmup_steps=2),
        mesh=MeshConfig(data=1),
        log_dir=os.path.join(workdir, "log"),
        checkpoint_dir=os.path.join(workdir, f"ckpt_{name}"),
        log_every_n_steps=1000, device=device)
    defaults.update(kw)
    defaults["log_name"] = name
    return TrainConfig(**defaults)


def _records(path: str | None) -> list[dict]:
    if not path or not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _events(records):
    return ([r for r in records if r.get("kind") == "failure"],
            [r for r in records if r.get("kind") == "recovery"],
            [r for r in records if r.get("kind") == "consistency"])


def _report(records) -> None:
    """The resilience timeline, one line a record, to standard error."""
    for r in records:
        if r.get("kind") in ("fault", "failure", "recovery", "consistency",
                             "resume"):
            fields = {k: v for k, v in r.items()
                      if k not in ("kind", "run", "time")}
            print(f"  {r['kind']:<11} {json.dumps(fields)}", file=sys.stderr)


def _params(trainer) -> list:
    return [p.detach().cpu().numpy().copy()
            for p in trainer.model.parameters()]


def _spawn(fn, nproc: int, args, *payload):
    from distributed_model_parallel_tpu_torch import mesh
    from distributed_model_parallel_tpu_torch.config import MeshConfig

    import torch

    backend = ("nccl" if args.device == "cuda"
               and torch.cuda.device_count() >= nproc else "gloo")
    return mesh.spawn(fn, nproc, *payload, device=args.device,
                      backend=backend, config=MeshConfig(data=nproc),
                      timeout_s=600, threads=1, store_dir=args.workdir)


# -- rank functions (module level: the spawned ranks import this module) ---

def drill_rank(spec, runs: list) -> list:
    """Fit each ``(config, keep_params)`` of ``runs`` in order on this rank;
    per run its history, global step, (rank 0) telemetry records, fired
    faults, sentinel repairs, emergency saves, loader position before
    the fit, whether every parameter is still the tensor it was (a fused
    optimizer's bucket view stays one through repairs and restores),
    whether the final parameters are bitwise the same on every rank
    (``guards.assert_replicated``; under a data-parallel strategy) and
    (``keep_params``) the final parameters."""
    from distributed_model_parallel_tpu_torch.train.guards import (
        ReplicaDivergenceError,
        assert_replicated,
    )
    from distributed_model_parallel_tpu_torch.train.trainer import Trainer

    def replicated(t) -> bool | None:
        if t.config.strategy not in ("gspmd", "ddp"):
            return None
        try:
            assert_replicated(list(t.model.parameters()), t.spec.group,
                              name="params")
        except ReplicaDivergenceError:
            return False
        return True

    out = []
    for config, keep in runs:
        t = Trainer(config, spec=spec)
        pos = dict(epoch=t.train_loader.epoch, cursor=t.train_loader.cursor,
                   global_step=t.global_step)
        views = [p.data_ptr() for p in t.model.parameters()]
        history = t.fit()
        out.append(dict(
            history=history, global_step=t.global_step, position=pos,
            loader=t.train_loader.state_dict(),
            records=_records(t.logger.jsonl_path) if t.logger else [],
            jsonl=t.logger.jsonl_path if t.logger else None,
            fired=[s.kind for s in t.faults.fired],
            repairs=t.sentinel.repairs, saves=t.emergency.saves,
            retries_left=t.resilience.retries_left,
            lr=t.config.optimizer.learning_rate,
            views_kept=views == [p.data_ptr() for p in t.model.parameters()],
            replicated=replicated(t),
            params=_params(t) if keep else None))
    return out


# -- scenarios ---------------------------------------------------------------

def scenario_nan(args, workdir) -> tuple[dict, bool]:
    """Injected NaN -> guards detect -> restore + LR shrink -> finish."""
    from distributed_model_parallel_tpu_torch.config import RecoveryConfig
    from distributed_model_parallel_tpu_torch.utils.faults import (
        parse_faults,
    )

    config = _config(
        workdir, "chaos_nan", args.device, epochs=args.epochs,
        check_finite_every=1,
        recovery=RecoveryConfig(max_retries=args.retries,
                                lr_shrink=args.lr_shrink,
                                faults=parse_faults(args.faults
                                                    or "nan_loss@1")))
    (run,) = drill_rank(_lone(args), [(config, False)])
    _report(run["records"])
    failures, recoveries, _ = _events(run["records"])
    summary = {
        "chaos": "injected-nan-recovers",
        "epochs_completed": len(run["history"]),
        "faults_injected": run["fired"],
        "failures_recorded": len(failures),
        "recoveries_recorded": len(recoveries),
        "retries_used": args.retries - run["retries_left"],
        "final_lr": run["lr"],
        "telemetry": run["jsonl"],
    }
    ok = bool(len(run["history"]) == args.epochs and run["fired"]
              and failures and recoveries)
    return summary, ok


def _lone(args):
    from distributed_model_parallel_tpu_torch import mesh

    return mesh.make_mesh(device=args.device)


def scenario_bitflip(args, workdir) -> tuple[dict, bool]:
    """A silent bitflip in one of 4 replicas -> the sentinel detects it
    within one cadence -> repaired by broadcast -> final parameters equal
    an uninjected run's bit for bit."""
    from distributed_model_parallel_tpu_torch.config import (
        MeshConfig,
        RecoveryConfig,
    )
    from distributed_model_parallel_tpu_torch.utils.faults import (
        parse_faults,
    )

    kw = dict(epochs=args.epochs, mesh=MeshConfig(data=4),
              consistency_every=(1 if args.consistency_every is None
                                 else args.consistency_every),
              # Drain every step: the sentinel sees the corruption before
              # the next step's all-reduce spreads it (bitwise parity).
              max_inflight_steps=1, log_every_n_steps=1)
    clean = _config(workdir, "chaos_bitflip_clean", args.device,
                    recovery=RecoveryConfig(max_retries=1), **kw)
    injected = _config(
        workdir, "chaos_bitflip", args.device,
        recovery=RecoveryConfig(max_retries=args.retries,
                                faults=parse_faults(args.faults
                                                    or "bitflip@1")), **kw)
    ranks = _spawn(drill_rank, 4, args, [(clean, True), (injected, True)])
    parity = all(all(np.array_equal(a, b) for a, b in
                     zip(r[0]["params"], r[1]["params"])) for r in ranks)
    run = ranks[0][1]
    _report(run["records"])
    failures, recoveries, consistency = _events(run["records"])
    statuses = [c.get("status") for c in consistency]
    summary = {
        "chaos": "bitflip-detected-repaired-parity",
        "epochs_completed": len(run["history"]),
        "faults_injected": run["fired"],
        "consistency": statuses,
        "repairs": run["repairs"],
        "recoveries": [r.get("action") for r in recoveries],
        "bitwise_parity_with_clean_run": parity,
        "telemetry": run["jsonl"],
    }
    ok = bool(len(run["history"]) == args.epochs and run["fired"]
              and "divergence" in statuses and "repaired" in statuses
              and "replica-rebroadcast" in summary["recoveries"]
              and parity)
    return summary, ok


def scenario_desync(args, workdir) -> tuple[dict, bool]:
    """Finite 1-vs-1 drift -> no quorum -> good-slot restore -> finish."""
    from distributed_model_parallel_tpu_torch.config import (
        MeshConfig,
        RecoveryConfig,
    )
    from distributed_model_parallel_tpu_torch.utils.faults import (
        parse_faults,
    )

    config = _config(
        workdir, "chaos_desync", args.device,
        epochs=args.epochs, mesh=MeshConfig(data=2),
        consistency_every=(1 if args.consistency_every is None
                           else args.consistency_every),
        max_inflight_steps=1, log_every_n_steps=1,
        recovery=RecoveryConfig(max_retries=args.retries,
                                faults=parse_faults(args.faults
                                                    or "desync@1")))
    run = _spawn(drill_rank, 2, args, [(config, False)])[0][0]
    _report(run["records"])
    failures, recoveries, consistency = _events(run["records"])
    statuses = [c.get("status") for c in consistency]
    summary = {
        "chaos": "desync-no-quorum-good-slot-restore",
        "epochs_completed": len(run["history"]),
        "faults_injected": run["fired"],
        "consistency": statuses,
        "failures": [f.get("error") for f in failures],
        "recoveries": [r.get("action") for r in recoveries],
        "telemetry": run["jsonl"],
    }
    ok = bool(len(run["history"]) == args.epochs and run["fired"]
              and "no-quorum" in statuses
              and "replica-divergence" in summary["failures"]
              and "restored" in summary["recoveries"])
    return summary, ok


def overhead_rank(spec, runs: list) -> list:
    """Per ``(config, every)``: the run's per-window step times (the first
    dropped) and the sentinel's check seconds and count over the fit (a
    check before it builds its state, outside the window)."""
    from distributed_model_parallel_tpu_torch.train.trainer import Trainer
    from distributed_model_parallel_tpu_torch.utils.telemetry import (
        registry,
    )

    out = []
    for config, every in runs:
        t = Trainer(config.replace(consistency_every=every), spec=spec)
        if every:
            t.sentinel.check(t._sentinel_leaves())
        hist = registry().histogram("consistency_check_s")
        pre_sum, pre_count = hist.sum, hist.count
        t.fit()
        times = [r["step_time_s"] for r in t.step_log][1:]
        out.append(dict(times=times, check_s=hist.sum - pre_sum,
                        checks=hist.count - pre_count))
    return out


def scenario_overhead(args, workdir) -> tuple[dict, bool]:
    """The sentinel's step-time cost at cadence 10, against off."""
    from distributed_model_parallel_tpu_torch.config import (
        DataConfig,
        MeshConfig,
        RecoveryConfig,
    )

    data = DataConfig(name="synthetic", batch_size=BATCH,
                      eval_batch_size=BATCH, synthetic_train_size=1024,
                      synthetic_eval_size=32)
    base = dict(epochs=1, mesh=MeshConfig(data=2), data=data,
                max_inflight_steps=1, log_every_n_steps=1,
                recovery=RecoveryConfig())
    off = _config(workdir, "chaos_overhead_off", args.device, **base)
    on = _config(workdir, "chaos_overhead_on", args.device, **base)
    res = _spawn(overhead_rank, 2, args, [(off, 0), (on, 10)])[0]
    (r_off, r_on) = res
    mean = lambda xs: sum(xs) / max(len(xs), 1)
    mean_off, mean_on = mean(r_off["times"]), mean(r_on["times"])
    total_on = mean_on * len(r_on["times"])
    check_s, n_checks = r_on["check_s"], r_on["checks"]
    overhead_pct = check_s / max(total_on - check_s, 1e-12) * 100.0
    ab_pct = (mean_on - mean_off) / max(mean_off, 1e-12) * 100.0
    summary = {
        "chaos": "sentinel-overhead",
        "cadence": 10,
        "steps_measured": [len(r_off["times"]), len(r_on["times"])],
        "consistency_checks": n_checks,
        "check_time_s": {"total": check_s,
                         "mean": check_s / max(n_checks, 1)},
        "overhead_pct": round(overhead_pct, 2),
        "target_pct": 5.0,
        "within_target": overhead_pct < 5.0,
        "step_time_mean_s_ab_diagnostic": {"sentinel_off": mean_off,
                                           "sentinel_on": mean_on,
                                           "delta_pct": round(ab_pct, 2)},
    }
    # A measurement: reported, never gated on the wall clock.
    return summary, bool(r_off["times"] and r_on["times"] and n_checks)


def scenario_preempt(args, workdir) -> tuple[dict, bool]:
    """Kill mid-epoch at 4 ranks -> resume at 4 (bitwise the uninterrupted
    run) and at 2 (the exact global step, through the resharded
    restore)."""
    from distributed_model_parallel_tpu_torch.config import (
        MeshConfig,
        RecoveryConfig,
    )
    from distributed_model_parallel_tpu_torch.utils.faults import (
        parse_faults,
    )

    total_steps = args.epochs * STEPS_PER_EPOCH
    # Fire after the 2nd step of the final epoch: unambiguously mid-epoch.
    kill_at = STEPS_PER_EPOCH * (args.epochs - 1) + 1
    kw = dict(epochs=args.epochs, mesh=MeshConfig(data=4),
              max_inflight_steps=1, log_every_n_steps=1, emergency_every=2)
    baseline = _config(workdir, "chaos_preempt_base", args.device,
                       recovery=RecoveryConfig(), **kw)
    plan = parse_faults(args.faults or f"preempt@{kill_at}")
    killed = _config(workdir, "chaos_preempt_kill", args.device,
                     recovery=RecoveryConfig(faults=plan), **kw)
    ck_dir = killed.checkpoint_dir
    r1_cfg = _config(workdir, "chaos_preempt_resume", args.device,
                     recovery=RecoveryConfig(), checkpoint_dir=ck_dir,
                     resume=True, **kw)
    four = _spawn(drill_rank, 4, args,
                  [(baseline, True), (killed, False)])
    base, kill = four[0]
    half_dir = ck_dir + "_half"
    shutil.copytree(ck_dir, half_dir)   # the same-mesh restart moves slots
    r1 = _spawn(drill_rank, 4, args, [(r1_cfg, True)])
    r2_cfg = _config(workdir, "chaos_preempt_resume_half", args.device,
                     recovery=RecoveryConfig(),
                     checkpoint_dir=half_dir, resume=True,
                     **{**kw, "mesh": MeshConfig(data=2)})
    r2 = _spawn(drill_rank, 2, args, [(r2_cfg, False)])[0][0]
    r1 = r1[0][0]
    parity = (all(np.array_equal(a, b)
                  for a, b in zip(base["params"], r1["params"]))
              and r1["global_step"] == total_steps)
    r1_pos, r2_pos = r1["position"], r2["position"]
    half_ok = (r2_pos == r1_pos and r2["global_step"] == total_steps
               and r2["global_step"] - r2_pos["global_step"]
               == total_steps - kill["global_step"])
    _report(r1["records"])
    resume_recs = [r for r in r1["records"] if r.get("kind") == "resume"]
    summary = {
        "chaos": "preempt-exact-resume",
        "faults_injected": kill["fired"],
        "killed_at": {"global_step": kill["global_step"], **kill["loader"]},
        "emergency_saves": kill["saves"],
        "resumed_at_same_mesh": r1_pos,
        "resumed_at_half_dp": r2_pos,
        "resume_records": [r.get("slot") for r in resume_recs],
        "bitwise_parity_with_uninterrupted": parity,
        "half_dp_exact_continuation": half_ok,
        "telemetry": r1["jsonl"],
    }
    ok = bool(kill["fired"]
              and kill["global_step"] == kill_at + 1
              and kill["loader"]["batch_cursor"] != 0
              and r1_pos["global_step"] == kill["global_step"]
              and r1_pos["cursor"] == kill["loader"]["batch_cursor"]
              and resume_recs and parity and half_ok)
    return summary, ok


SCENARIOS = {
    "nan": scenario_nan,
    "bitflip": scenario_bitflip,
    "desync": scenario_desync,
    "overhead": scenario_overhead,
    "preempt": scenario_preempt,
}


def main(argv=None) -> int:
    args = parse_args(argv)
    # No silent ignores: reject overrides the chosen scenario never reads.
    unread = {
        "overhead": [("--faults", args.faults),
                     ("--consistency-every", args.consistency_every),
                     ("--epochs", args.epochs), ("--retries", args.retries),
                     ("--lr-shrink", args.lr_shrink)],
        "nan": [("--consistency-every", args.consistency_every)],
        "bitflip": [("--lr-shrink", args.lr_shrink)],
        "desync": [("--lr-shrink", args.lr_shrink)],
        "preempt": [("--consistency-every", args.consistency_every),
                    ("--retries", args.retries),
                    ("--lr-shrink", args.lr_shrink)],
    }[args.scenario]
    bad = [flag for flag, value in unread if value is not None]
    if bad:
        print(f"{', '.join(bad)} has no effect on the {args.scenario} "
              f"scenario (see --help for which flags each scenario reads)",
              file=sys.stderr)
        return 2
    if args.scenario == "bitflip" and (args.consistency_every or 0) > 1:
        # The steps between the corruption and the next check fold the bad
        # replica's gradients into everyone: bitwise parity cannot hold.
        print("--consistency-every > 1 cannot satisfy the bitflip drill's "
              "bitwise-parity gate (corrupted gradients reach the allreduce "
              "before the next check); use the default cadence 1, or the "
              "overhead scenario to measure cadence cost", file=sys.stderr)
        return 2
    if args.scenario == "desync" and args.retries is not None \
            and args.retries < 1:
        print("--retries 0 disables recovery, but the desync drill exists "
              "to demonstrate the no-quorum -> good-slot-restore fallback; "
              "use the trainers directly to observe the fail-fast path",
              file=sys.stderr)
        return 2
    args.epochs = 2 if args.epochs is None else args.epochs
    args.retries = 2 if args.retries is None else args.retries
    args.lr_shrink = 0.5 if args.lr_shrink is None else args.lr_shrink
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="dmp_chaos_")
    os.makedirs(args.workdir, exist_ok=True)
    summary, ok = SCENARIOS[args.scenario](args, args.workdir)
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
