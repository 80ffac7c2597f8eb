"""Tenant lifecycle: one training job co-resident on the shared pool.

The counterpart of ``distributed_model_parallel_tpu/orchestrator/
tenants.py``. A :class:`Tenant` wraps one trainer (CNN
``train/trainer.Trainer``, LM/MoE ``train/lm_trainer.LMTrainer`` or
``train/pipeline_trainer.PipelineTrainer``) and runs its unmodified
``fit()``, gated step by step through the trainers' ``step_hook``: the
hook parks the trainer at every train-step boundary until the
orchestrator grants the next step (a baton, not a time slice), so one
tenant computes at a time, every scheduling decision sees settled state,
and a fixed submission order and fixed seeds replay the same campaign.

The JAX package runs every tenant on a thread of its one process. A
trainer of several ranks in the port needs a process group of one rank a
process, so a tenant runs one of two ways, behind the same interface (the
orchestrator cannot tell them apart):

* **on a thread**, as in JAX: a ``cnn`` or ``lm`` tenant granted one slot
  (its trainer on the slot's ``torch.device``, a one-device mesh), and a
  ``pipeline`` tenant, whose runner places chunk ``c`` on the ``c % S``-th
  granted slot in one process;
* **as a rank group**: a ``cnn`` or ``lm`` tenant granted ``n > 1`` slots
  runs ``n`` ranks (``mesh.RankGroup``), rank r on slot r's device, over
  gloo where slots share a card and NCCL with a card a rank. The baton
  crosses the process boundary on ``multiprocessing`` primitives of the
  ``spawn`` context: each rank's hook reports at every boundary (rank 0
  with the global step and the step timings its trainer fed the health
  monitor) and waits on its own event; a grant wakes every rank for one
  step and waits until all of them park again. A preemption request is a
  shared flag each rank's hook turns into ``trainer.preemption.request()``
  before it returns, so every rank stops at the same step. At the end of
  an attempt rank 0 sends back the outcome, the history, the fired
  faults, its counter deltas and the final weights; every rank sends a
  digest of its state (the replicas' agreement). A rank that raises or
  dies fails the tenant (:class:`RankGroupError`, its traceback as the
  message, the flight recorder's ``tenant-failed-<name>`` bundle); the
  other ranks are killed after a bounded wait, so a peer stuck in a
  collective cannot wedge the orchestrator. Nothing falls back to a
  thread or to the CPU.

Preemption is the trainers' own path: the flag is honoured at the next
granted boundary, the trainer writes its preempt checkpoint (exact
position, budgets, topology stamp) and ``fit()`` returns. A re-admission
builds a fresh trainer with ``resume=True`` on whatever slice the
scheduler granted: ``fit_mesh_to_devices`` refits the data axis and the
resharded restore lands the checkpoint on the new mesh, so a tenant
preempted off two slots continues at the exact global step on one.

:attr:`TenantSpec.init` carries weights across packages: a ``(params,
state)`` numpy tree in the JAX layout that the first construction loads
(later admissions resume from the checkpoint). It is how a port tenant and
a JAX tenant start from the same weights, and changes no scheduling.

Trainer construction and the whole fit run inside
``telemetry.tenant_scope(name)``, so every record the trainer writes
carries the tenant tag.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import queue
import threading
import time
from typing import Any

import torch

from distributed_model_parallel_tpu_torch.utils.telemetry import tenant_scope

__all__ = ["RankGroupError", "Tenant", "TenantSpec", "TenantState"]

WORKLOADS = ("cnn", "lm", "pipeline")

# How long the surviving ranks of a failed rank group may take to exit on
# their own before they are killed (one may be stuck in a collective).
RANK_GRACE_S = 5.0


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One job submission: which trainer drives it, its full config, its
    scheduling priority (higher preempts lower) and, optionally, the
    weights its first construction starts from (``init``: ``(params,
    state)`` numpy trees in the JAX package's layout; for ``"lm"`` the
    parameter tree, ``state`` None).

    ``workload`` selects the trainer: ``"cnn"`` = ``train/trainer.Trainer``
    (TrainConfig), ``"lm"`` = ``train/lm_trainer.LMTrainer``
    (LMTrainConfig; a MoE tenant is an LM config with
    ``model.moe_experts > 0``), ``"pipeline"`` =
    ``train/pipeline_trainer.PipelineTrainer`` (TrainConfig with
    ``mesh.stage`` stages; the stage axis is not elastic, so this tenant
    needs exactly that many slots).

    The config's ``mesh`` is a ceiling, not a demand: on every admission
    the data axis is refit to the granted slice, so ``mesh.data`` is the
    largest dp the tenant will use. ``checkpoint_dir`` / ``log_dir`` must
    be tenant-unique (the orchestrator rejects collisions at submit)."""

    name: str
    workload: str
    config: Any                 # TrainConfig (cnn/pipeline) | LMTrainConfig
    priority: int = 0
    init: Any = None

    def __post_init__(self):
        if self.workload not in WORKLOADS:
            raise ValueError(f"unknown workload {self.workload!r}; known: "
                             f"{WORKLOADS}")
        if self.workload == "pipeline" and self.config.mesh.stage < 2:
            raise ValueError(
                f"pipeline tenant {self.name!r} needs mesh.stage >= 2, "
                f"got {self.config.mesh.stage}")

    @property
    def epochs(self) -> int:
        return int(self.config.epochs)

    @property
    def batch_size(self) -> int:
        cfg = self.config
        return int(cfg.batch_size if hasattr(cfg, "batch_size")
                   else cfg.data.batch_size)

    def requested_devices(self) -> int:
        """The slice this tenant asked for: the full config mesh (the
        admission ceiling). A tenant granted less is below request, and
        the orchestrator's grow-back pass expands it once slots free up."""
        if self.workload == "pipeline":
            return self.config.mesh.stage
        return self.config.mesh.num_devices

    def min_devices(self) -> int:
        """Smallest slice this tenant can run on at all: the non-data mesh
        axes (not elastic), times two replicas when the fault plan injects
        silent corruption (the trainers refuse a dp=1 corruption plan, so
        the scheduler must not grant one)."""
        mesh = self.config.mesh
        if self.workload == "pipeline":
            return mesh.stage
        other = mesh.stage * mesh.model * mesh.seq * mesh.expert
        from distributed_model_parallel_tpu_torch.utils.faults import (
            CORRUPTION_KINDS,
            parse_faults,
        )

        min_dp = 1
        for f in self.config.recovery.faults or ():
            kind = f.kind if hasattr(f, "kind") else parse_faults(f)[0].kind
            if kind in CORRUPTION_KINDS:
                min_dp = 2
        return other * min_dp


class TenantState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTING = "preempting"     # preemption requested, draining to save
    COMPLETED = "completed"
    FAILED = "failed"             # unrecovered error
    CANCELLED = "cancelled"


class RankGroupError(RuntimeError):
    """A rank of a rank-group tenant raised or died; the message carries
    the rank's traceback (or its exit code)."""


# -- building a trainer (on the tenant's thread, or in each rank) -------------

def attempt_config(spec: TenantSpec, attempts: int, n_devices: int,
                   device):
    """The config of one admission: resume on after the first, the data
    axis refit to the granted slice, the fault plan stripped on resumes
    (an injector's occurrence counters are per construction: replaying
    the plan would re-inject every fault on every resume), and the
    granted slots' device."""
    cfg = spec.config
    resume = attempts > 1
    kw: dict[str, Any] = {"resume": resume,
                          "device": torch.device(device).type}
    if resume and (cfg.recovery.faults or ()):
        kw["recovery"] = dataclasses.replace(cfg.recovery, faults=())
    if spec.workload != "pipeline":
        from distributed_model_parallel_tpu_torch.train.elastic import (
            fit_mesh_to_devices,
        )

        mesh_cfg, _ = fit_mesh_to_devices(cfg.mesh, n_devices,
                                          batch_size=spec.batch_size)
        if mesh_cfg.num_devices != n_devices:
            raise ValueError(
                f"tenant {spec.name!r}: granted {n_devices} devices "
                f"but the mesh resolves to {mesh_cfg.num_devices} — "
                f"the scheduler must grant exactly the resolved slice")
        kw["mesh"] = mesh_cfg
    return dataclasses.replace(cfg, **kw)


def build_trainer(workload: str, cfg, *, mesh_spec=None, devices=None,
                  init=None):
    """The tenant's trainer: a ``PipelineTrainer`` over ``devices`` (pool
    slots), else a ``Trainer`` / ``LMTrainer`` on ``mesh_spec``, from
    ``init`` (the JAX layout) when given."""
    params, state = init if init is not None else (None, None)
    if workload == "pipeline":
        from distributed_model_parallel_tpu_torch.train.pipeline_trainer import (  # noqa: E501
            PipelineTrainer,
        )

        return PipelineTrainer(cfg, devices=list(devices), params=params,
                               state=state)
    if workload == "lm":
        from distributed_model_parallel_tpu_torch.models import (
            transformer as tfm,
        )
        from distributed_model_parallel_tpu_torch.train.lm_trainer import (
            LMTrainer,
        )

        if params is not None:
            params = tfm.params_from_jax(params, cfg.model, mesh_spec.device)
        return LMTrainer(cfg, params=params, spec=mesh_spec)
    from distributed_model_parallel_tpu_torch.train.trainer import Trainer

    return Trainer(cfg, params=params, state=state, spec=mesh_spec)


def final_weights(workload: str, trainer):
    """The trainer's weights in the JAX layout as numpy: ``(params,
    state)`` of a CNN or pipeline, ``(params, None)`` of the LM (every
    rank of an LM mesh must call: the slices are gathered)."""
    from distributed_model_parallel_tpu_torch.models import params_to_jax

    if workload == "lm":
        whole = trainer.whole_params()
        return _tree_np(whole), None
    model = trainer.runner.model if workload == "pipeline" else trainer.model
    with torch.no_grad():
        return params_to_jax(model)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def state_digest(trainer) -> str:
    """sha256 over this rank's parameters and buffers (or LM slices), bit
    for bit: equal across ranks that hold the same copies."""
    h = hashlib.sha256()
    model = getattr(trainer, "model", None)
    tensors = (list(model.parameters()) + list(model.buffers())
               if model is not None else list(trainer.leaves))
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _completed(total_epochs: int, trainer, history) -> bool:
    if any(h.get("epoch") == total_epochs - 1 for h in history or ()):
        return True
    # Zero-work resume (preempted exactly at the final epoch boundary):
    # the restored position already sits past the last epoch.
    return int(getattr(trainer, "start_epoch", 0)) >= total_epochs


def _counters(name: str) -> dict:
    from distributed_model_parallel_tpu_torch.utils.telemetry import (
        registry,
    )

    return {k: v for k, v in registry().snapshot(tenant=name).get(
        "counters", {}).items() if v}


# -- the baton ----------------------------------------------------------------

class _Baton:
    """Step-boundary handoff between the orchestrator and a tenant on a
    thread: the tenant parks in :meth:`hook` at every boundary; a grant
    wakes it for exactly one step."""

    def __init__(self):
        self.at_boundary = threading.Event()
        self.go = threading.Event()

    def hook(self, _trainer) -> None:          # runs on the tenant thread
        self.at_boundary.set()
        self.go.wait()
        self.go.clear()


class _ForwardMonitor:
    """Rank 0's stand-in for the orchestrator's health monitor: the
    observations its trainer makes, kept until the next park message
    carries them to the orchestrator's process."""

    def __init__(self):
        self.pending: list = []

    def observe(self, signal, device_ids, value, n=1) -> None:
        self.pending.append(("observe", signal, tuple(device_ids),
                             float(value), int(n)))

    def observe_stall(self, device_ids, blocked_s) -> None:
        self.pending.append(("stall", tuple(device_ids), float(blocked_s)))

    def take(self) -> list:
        out, self.pending = self.pending, []
        return out


def _replay_observations(obs: list) -> None:
    """Feed a rank's forwarded observations to this process's monitor."""
    from distributed_model_parallel_tpu_torch.utils import health

    monitor = health.installed()
    if monitor is None:
        return
    for o in obs:
        if o[0] == "observe":
            monitor.observe(o[1], o[2], o[3], o[4])
        else:
            monitor.observe_stall(o[1], o[2])


class _RankBaton:
    """The baton inside one rank of a rank-group tenant."""

    def __init__(self, rank: int, ctl: dict, monitor):
        self.rank = rank
        self.go = ctl["go"][rank]
        self.parks = ctl["parks"]
        self.preempt = ctl["preempt"]
        self.step = ctl["step"]
        self.monitor = monitor
        self._woke = None

    def hook(self, trainer) -> None:
        step = int(trainer.global_step)
        if self.rank == 0:
            self.step.value = step
        # The seconds this rank worked since the last grant woke it.
        busy = (time.perf_counter() - self._woke
                if self._woke is not None else None)
        self.parks.put(("park", self.rank, step,
                        (self.monitor.take() if self.monitor else [], busy)))
        self.go.wait()
        self.go.clear()
        self._woke = time.perf_counter()
        if self.preempt.is_set():
            trainer.preemption.request()


def tenant_rank(spec, name: str, workload: str, cfg, init, slot_ids,
                total_epochs: int, ctl: dict) -> dict:
    """One rank of a rank-group tenant (a ``mesh.RankGroup`` function):
    the trainer on this rank's slot, its fit gated by the baton. Rank 0
    reports what it built, then the attempt's outcome; every rank returns
    its state digest."""
    from distributed_model_parallel_tpu_torch.utils import health

    spec = dataclasses.replace(spec, device_ids=tuple(slot_ids))
    monitor = None
    if spec.rank == 0:
        monitor = health.install(_ForwardMonitor())
    with tenant_scope(name):
        trainer = build_trainer(workload, cfg, mesh_spec=spec, init=init)
        if spec.rank == 0:
            fallback = bool(trainer.resilience._fallback_reported)
            ctl["step"].value = int(trainer.global_step)
            ctl["parks"].put(("built", 0, int(trainer.global_step),
                              dict(fallback=fallback,
                                   jsonl_path=trainer.logger.jsonl_path)))
        trainer.step_hook = _RankBaton(spec.rank, ctl, monitor).hook
        history = trainer.fit()
        weights = final_weights(workload, trainer)
    out = {"digest": state_digest(trainer)}
    if spec.rank == 0:
        ctl["step"].value = int(trainer.global_step)
        out.update(
            outcome=("completed" if _completed(total_epochs, trainer,
                                               history) else "preempted"),
            history=history, global_step=int(trainer.global_step),
            fired=list(trainer.faults.fired), counters=_counters(name),
            weights=weights, observations=monitor.take())
        health.uninstall()
    return out


# -- the tenant ---------------------------------------------------------------

class Tenant:
    """Runtime state of one submitted job across admissions."""

    def __init__(self, spec: TenantSpec, seq: int):
        self.spec = spec
        self.seq = seq                  # submission order (FIFO tie-break)
        self.state = TenantState.QUEUED
        self.devices: tuple = ()        # granted slots while RUNNING
        self.admit_seq = -1             # order of the last admission
        self.attempts = 0               # trainer constructions (1 + resumes)
        self.preemptions = 0
        self.grow_backs = 0             # below-request expansions granted
        # Slice size before a pending grow-back preemption; the next
        # admission compares its grant against it and clears it.
        self._grow_back_from: int | None = None
        # This tenant's registry counter totals (telemetry attributes
        # counter increments to the tenant_scope), captured at the end of
        # every attempt.
        self.counter_deltas: dict = {}
        self.preempted_at_step: int | None = None   # step when last preempted
        self.resume_exact: list[bool] = []          # per-resume step parity
        # Resumes that could not land at the exact step because the newest
        # checkpoint was torn and the restore fell back to an older one.
        self.resume_fallbacks = 0
        self.trainer = None             # on a thread: the live trainer
        self.error: BaseException | None = None
        self.outcome: str | None = None     # completed | preempted | failed
        self.jsonl_path: str | None = None
        # Faults fired across all attempts (the trainer and its injector
        # are rebuilt on every admission).
        self.fired_faults: list = []
        # The last attempt's weights in the JAX layout, and (rank group)
        # every rank's state digest.
        self.weights = None
        self.replica_digests: list[str] = []
        # Grant round trips of the last rank-group attempt (s): a grant to
        # every rank parked again, and of it the part no rank spent working
        # (the baton's own cost: the messages and wake-ups); and the
        # seconds from the last admission's start to its first boundary
        # (the trainer built; a rank group's processes started and joined).
        self.grant_s: list[float] = []
        self.grant_overhead_s: list[float] = []
        self._busy = 0.0
        self.admit_s: float | None = None
        self._t_start = 0.0
        self._cancel_on_reap = False
        self._thread: threading.Thread | None = None
        self._baton = _Baton()
        self._group = None
        self._ctl: dict | None = None
        self._parked: set = set()
        self._results: dict = {}
        self._finished = True

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def priority(self) -> int:
        return self.spec.priority

    @property
    def rank_group(self) -> bool:
        """Whether the current admission runs as a group of ranks."""
        return self._group is not None

    @property
    def global_step(self) -> int:
        if self._ctl is not None:
            return int(self._ctl["step"].value)
        t = self.trainer
        return int(getattr(t, "global_step", 0)) if t is not None else 0

    def _runs_as_ranks(self, n: int) -> bool:
        return self.spec.workload != "pipeline" and n > 1

    def _check_resume(self, step: int, fallback: bool) -> None:
        """The acceptance gate: a resumed tenant continues at the exact
        global step it was preempted at, unless the restore fell back from
        a torn checkpoint."""
        if self.attempts > 1 and self.preempted_at_step is not None:
            exact = step == self.preempted_at_step
            if not exact and fallback:
                self.resume_fallbacks += 1
            else:
                self.resume_exact.append(exact)

    # -- a tenant on a thread ---------------------------------------------------
    def _run(self, devices) -> None:
        # Drop the previous attempt's trainer before building the new one:
        # a failed re-admission must not re-append its fired faults.
        self.trainer = None
        try:
            with tenant_scope(self.name):
                trainer = self._build_here(devices)
                self.trainer = trainer
                self.jsonl_path = trainer.logger.jsonl_path
                self._check_resume(
                    trainer.global_step,
                    bool(trainer.resilience._fallback_reported))
                trainer.step_hook = self._baton.hook
                history = trainer.fit()
                self.weights = final_weights(self.spec.workload, trainer)
                self.outcome = ("completed"
                                if _completed(self.spec.epochs, trainer,
                                              history)
                                else "preempted")
        except BaseException as e:  # noqa: BLE001 - ledger, not crash
            self.error = e
            self.outcome = "failed"
            # The postmortem on the failing thread, while its traceback is
            # live (no-op without an installed flight recorder).
            from distributed_model_parallel_tpu_torch.utils import flightrec

            t = self.trainer
            flightrec.dump(f"tenant-failed-{self.name}",
                           telemetry_run=(t.logger.telemetry
                                          if t is not None else None),
                           error=e)
        finally:
            faults = getattr(self.trainer, "faults", None)
            if faults is not None:
                self.fired_faults.extend(faults.fired)
            self.counter_deltas = _counters(self.name)
            # A reaped tenant must not keep its trainer on /statusz.
            from distributed_model_parallel_tpu_torch.utils import statusz

            statusz.unregister(self.name)
            # The thread's end is the completion signal.
            self._baton.at_boundary.set()

    def _build_here(self, slots):
        from distributed_model_parallel_tpu_torch.mesh import make_mesh

        spec = self.spec
        cfg = attempt_config(spec, self.attempts, len(slots),
                             slots[0].device)
        init = spec.init if self.attempts == 1 else None
        if spec.workload == "pipeline":
            return build_trainer("pipeline", cfg, devices=slots, init=init)
        mesh_spec = dataclasses.replace(
            make_mesh(cfg.mesh, slots[0].device),
            device_ids=tuple(s.id for s in slots))
        return build_trainer(spec.workload, cfg, mesh_spec=mesh_spec,
                             init=init)

    # -- a tenant as a rank group ------------------------------------------------
    def _start_ranks(self, slots) -> None:
        from distributed_model_parallel_tpu_torch.mesh import RankGroup

        spec = self.spec
        devs = [s.device for s in slots]
        cfg = attempt_config(spec, self.attempts, len(slots), devs[0])
        cards = {(d.type, d.index) for d in devs}
        backend = ("nccl" if devs[0].type == "cuda"
                   and len(cards) == len(devs) else "gloo")
        ctx = torch.multiprocessing.get_context("spawn")
        self._ctl = dict(go=[ctx.Event() for _ in slots],
                         parks=ctx.Queue(), preempt=ctx.Event(),
                         step=ctx.Value("q", 0))
        self._parked = set()
        self._results = {}
        self._finished = False
        self.grant_s, self.grant_overhead_s = [], []
        self._group = RankGroup(
            tenant_rank, len(slots), spec.name, spec.workload, cfg,
            spec.init if self.attempts == 1 else None,
            tuple(s.id for s in slots), spec.epochs, self._ctl,
            config=cfg.mesh, backend=backend, devices=[str(d) for d in devs],
            threads=1 if devs[0].type == "cpu" else None)

    def _pump(self, timeout: float) -> None:
        """Take the ranks' messages: parks (with rank 0's forwarded health
        observations), rank 0's build report, and the ranks' results or
        failures. Waits up to ``timeout`` s for the first message."""
        wait = timeout
        while True:
            try:
                kind, rank, step, info = self._ctl["parks"].get(
                    timeout=wait) if wait else self._ctl["parks"].get_nowait()
            except queue.Empty:
                break
            wait = 0
            if kind == "built":
                self.jsonl_path = info["jsonl_path"]
                self._check_resume(step, info["fallback"])
            else:
                obs, busy = info
                self._parked.add(rank)
                if busy is not None:
                    self._busy = max(self._busy, busy)
                _replay_observations(obs)
        if self._finished:
            return
        got = self._group.poll(0.0)
        while got is not None:
            rank, ok, value = got
            if not ok:
                self._fail(RankGroupError(
                    f"rank {rank} of tenant {self.name!r} failed:\n{value}"))
                return
            self._results[rank] = value
            got = self._group.poll(0.0)
        dead = self._group.failed(self._results)
        if dead:
            codes = [self._group.procs[r].exitcode for r in dead]
            self._fail(RankGroupError(
                f"rank(s) {dead} of tenant {self.name!r} exited with code(s) "
                f"{codes} and no result"))
            return
        if len(self._results) == self._group.nproc:
            self._finish_ranks()

    def _finish_ranks(self) -> None:
        res = self._results[0]
        _replay_observations(res["observations"])
        self.outcome = res["outcome"]
        self.fired_faults.extend(res["fired"])
        self.counter_deltas = res["counters"]
        self.weights = res["weights"]
        self.replica_digests = [self._results[r]["digest"]
                                for r in sorted(self._results)]
        self._group.join(60.0)
        self._close_group()

    def _fail(self, error: BaseException) -> None:
        """The tenant fails: the other ranks get a bounded wait to exit,
        then are killed, and the flight recorder writes its bundle."""
        self.error = error
        self.outcome = "failed"
        if self._group is not None:
            self._group.join(RANK_GRACE_S)
            self._close_group()
        self._finished = True
        from distributed_model_parallel_tpu_torch.utils import flightrec

        flightrec.dump(f"tenant-failed-{self.name}", error=error)

    def _close_group(self) -> None:
        self._finished = True
        self._group.close()           # kills the ranks still alive
        self._ctl["parks"].close()

    # -- orchestrator-side controls ---------------------------------------------
    def start(self, devices, admit_seq: int) -> None:
        assert not self.alive
        self.devices = tuple(devices)
        self.admit_seq = admit_seq
        self.attempts += 1
        self.state = TenantState.RUNNING
        self.outcome = None
        self.weights = None
        self.replica_digests = []
        self.admit_s = None
        self._t_start = time.perf_counter()
        self._group = None
        self._ctl = None
        if self._runs_as_ranks(len(self.devices)):
            self.trainer = None
            try:
                self._start_ranks(self.devices)
            except BaseException as e:  # noqa: BLE001 - ledger, not crash
                self._fail(e)
            return
        self._baton = _Baton()
        self._thread = threading.Thread(
            target=self._run, args=(self.devices,), daemon=True,
            name=f"tenant-{self.name}")
        self._thread.start()

    @property
    def alive(self) -> bool:
        if self._ctl is not None or self.rank_group:
            return not self._finished
        return self._thread is not None and self._thread.is_alive()

    def wait_boundary(self, poll_s: float = 0.01) -> bool:
        """Block until the tenant parks at a step boundary (every rank of a
        rank group), or until it finishes: False then (a thread's end sets
        the flag too, so callers never wedge here; they check
        ``alive``)."""
        if self._ctl is not None:
            while not self._finished:
                self._pump(poll_s)
                if len(self._parked) == self._group.nproc:
                    return self._settled()
            return False
        while not self._baton.at_boundary.wait(poll_s):
            if not self.alive:
                return False
        return self._settled()

    def _settled(self) -> bool:
        if self.admit_s is None:
            self.admit_s = time.perf_counter() - self._t_start
        return True

    def _grant_one(self) -> None:
        if self._ctl is not None:
            self._parked.clear()
            for ev in self._ctl["go"]:
                ev.set()
        else:
            self._baton.at_boundary.clear()
            self._baton.go.set()

    def grant_steps(self, n: int) -> bool:
        """Advance the tenant by up to ``n`` steps, synchronously: each
        grant waits for the tenant to park again (or finish) before the
        next, so one tenant computes at a time and control returns with
        the tenant settled. Returns False once the tenant has finished."""
        for _ in range(n):
            if not self.wait_boundary() or not self.alive:
                return False
            t0 = time.perf_counter()
            self._busy = 0.0
            self._grant_one()
            if self._ctl is not None and self.wait_boundary():
                dt = time.perf_counter() - t0
                self.grant_s.append(dt)
                self.grant_overhead_s.append(dt - self._busy)
        self.wait_boundary()
        return self.alive

    def request_preemption(self) -> None:
        """Set the trainer's cooperative stop flag (every rank's, at its
        next boundary). The tenant honours it at the next granted boundary
        and exits through its preempt checkpoint."""
        if self._ctl is not None:
            self._ctl["preempt"].set()
        elif self.trainer is not None:
            self.trainer.preemption.request()
        self.state = TenantState.PREEMPTING

    def drain(self, max_steps: int = 10_000) -> None:
        """Grant steps until the tenant finishes (after a preemption
        request: the trainer needs one boundary to see the flag, then runs
        its checkpoint-and-exit path)."""
        for _ in range(max_steps):
            if not self.alive:
                break
            if not self.wait_boundary():
                break
            self._grant_one()
        self.join()

    def join(self) -> None:
        if self._ctl is not None:
            while not self._finished:
                self._pump(0.05)
            return
        if self._thread is not None:
            self._thread.join(timeout=300)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"tenant {self.name!r} thread failed to exit")
