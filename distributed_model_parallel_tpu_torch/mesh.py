"""Process group and ``(data, stage)`` mesh — the port of
``distributed_model_parallel_tpu/mesh.py``.

The JAX package lays its devices out as a named ``jax.sharding.Mesh`` in
one process; the port runs one process per rank, joined by a
``torch.distributed`` process group: NCCL on the card, gloo on the CPU.
The ranks form JAX's device grid over ``(data, stage)``, row-major: rank
``r`` of ``D·S`` sits at ``data = r // S``, ``stage = r % S``. Each rank
belongs to two sub-groups: the ranks of its stage across the data rows
(gradients and BatchNorm statistics are pooled there) and the ranks of
its data row across the stages (the pipeline's point-to-point ring). With
``stage == 1`` the data sub-group is the whole world. The data axis
splits every global batch of ``B`` rows: data row ``d`` holds rows
``[d·B/D, (d+1)·B/D)``, in the order JAX shards the data axis.

* :func:`init_process_group` joins this process to the group, from
  torchrun's environment (``env://``, ``LOCAL_RANK`` picks the card) or
  from an explicit ``(rank, world, init_method)``, and returns its
  :class:`MeshSpec`;
* :func:`make_mesh` is the :class:`MeshSpec` of an already joined
  process (or of a lone process at ``data=1``);
* :func:`spawn` starts ``N`` ranks as fresh processes (start method
  ``spawn``, a ``file://`` store in a temporary directory), runs a
  function on each and returns their results in rank order;
* :func:`process_rows` is this process's data row's rows of a global
  batch, from the mesh it joined (``BatchLoader(shard_by_process=True)``);
* :func:`local_batch_slice`, :func:`barrier_with_timeout` and
  :func:`best_effort_distributed_init` keep the JAX package's contracts.

The backend is never switched behind the caller's back: a CUDA rank runs
NCCL, one rank per card, unless the caller asks for gloo (several ranks
sharing one card), and a rank that finds no card raises instead of
running on the CPU. Not ported yet, and refused by name: ``dcn_data > 1``
(the two-level data axis across hosts, ROADMAP A6) and the ``model``,
``seq`` and ``expert`` axes (A9).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist

from distributed_model_parallel_tpu_torch.config import MeshConfig

# Mesh axes the port does not run, and the ROADMAP item that ports each.
_OTHER_AXES = (("model", "A9: tensor parallelism"),
               ("seq", "A9: sequence parallelism"),
               ("expert", "A9: mixture of experts"))


# The mesh this process's group was last laid out as (process_rows).
_joined: dict = {}


def check_mesh_config(config: MeshConfig) -> None:
    """Raise, naming the ROADMAP item, for a mesh the port does not run:
    anything beyond the ``data`` and ``stage`` axes."""
    if config.dcn_data != 1:
        raise ValueError(f"MeshConfig(dcn_data={config.dcn_data}): the "
                         f"two-level data axis across hosts (hierarchical "
                         f"all-reduce) is not ported yet (ROADMAP A6, "
                         f"multi-node)")
    for axis, item in _OTHER_AXES:
        if getattr(config, axis) != 1:
            raise ValueError(f"MeshConfig({axis}={getattr(config, axis)}) "
                             f"is not ported yet (ROADMAP {item}); the port "
                             f"runs the data and stage axes")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """One rank's view of the ``(data, stage)`` mesh: the mesh config, this
    rank, its device, the backend of its process group (None: a lone
    process with no group, world 1) and its two sub-groups (None at
    ``stage == 1``, where the data axis is the whole world and there is
    no ring)."""

    config: MeshConfig
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: str | None = None
    data_group: object = None
    stage_group: object = None

    @property
    def num_data(self) -> int:
        return self.config.data

    @property
    def num_stages(self) -> int:
        return self.config.stage

    @property
    def data_axis(self) -> str:
        return self.config.data_axis

    @property
    def stage_axis(self) -> str:
        return self.config.stage_axis

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's ``(data, stage)`` position in JAX's device grid."""
        return divmod(self.rank, self.num_stages)

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def stage_index(self) -> int:
        return self.coords[1]

    @property
    def group(self):
        """The process group of the data axis — this rank's stage across
        the data rows (None without a process group)."""
        if self.backend is None:
            return None
        return self.data_group if self.data_group is not None else \
            dist.group.WORLD

    def stage_rank(self, stage: int) -> int:
        """The global rank of ``stage`` in this rank's data row."""
        return self.data_index * self.num_stages + stage

    def rows(self, global_batch: int) -> slice:
        """This rank's data row's rows of a global batch."""
        local = local_batch_slice(global_batch, self)
        return slice(self.data_index * local, (self.data_index + 1) * local)


def mesh_groups(data: int, stage: int) -> tuple[list, list]:
    """The global ranks of every data sub-group (one per stage: the ranks
    of that stage across the data rows) and of every stage ring (one per
    data row), in the order :func:`init_process_group` creates them."""
    return ([[d * stage + s for d in range(data)] for s in range(stage)],
            [[d * stage + s for s in range(stage)] for d in range(data)])


def _sub_groups(config: MeshConfig, rank: int) -> dict:
    """Create every sub-group of the mesh (each rank must create all of
    them, in the same order) and return this rank's two; nothing at
    ``stage == 1``."""
    if config.stage == 1:
        return {}
    data_ranks, stage_ranks = mesh_groups(config.data, config.stage)
    d, s = divmod(rank, config.stage)
    data_groups = [dist.new_group(r) for r in data_ranks]
    stage_groups = [dist.new_group(r) for r in stage_ranks]
    return {"data_group": data_groups[s], "stage_group": stage_groups[d]}


def local_batch_slice(global_batch: int, spec: MeshSpec) -> int:
    """Rows per data row; raises on an uneven split."""
    d = spec.num_data
    if global_batch % d:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data={d}")
    return global_batch // d


def _rank_device(device, local_rank: int, backend: str) -> torch.device:
    kind = torch.device(device).type
    if kind == "cpu":
        if backend != "gloo":
            raise ValueError(f"a CPU rank runs gloo, not {backend!r}")
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"unknown device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    n = torch.cuda.device_count()
    if local_rank >= n and backend != "gloo":
        raise ValueError(f"local rank {local_rank} needs cuda:{local_rank} "
                         f"but {n} card(s) are visible; NCCL runs one rank "
                         f"per card (pass backend='gloo' to share cards)")
    dev = torch.device("cuda", local_rank % n)
    torch.cuda.set_device(dev)
    return dev


def init_process_group(config: MeshConfig | None = None, *,
                       rank: int | None = None, world: int | None = None,
                       init_method: str | None = None, device="cuda",
                       backend: str | None = None) -> MeshSpec:
    """Join this process to the mesh's process group and return its
    :class:`MeshSpec`. With ``rank`` None the group comes from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; ``env://``);
    otherwise from ``rank``, ``world`` and ``init_method``. A CUDA rank
    takes ``cuda:LOCAL_RANK`` (``cuda:rank`` when spawned); ``backend``
    defaults to ``nccl`` on the card and ``gloo`` on the CPU."""
    if rank is None:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init_method = "env://"
    else:
        local_rank = rank
        if world is None or init_method is None:
            raise ValueError("an explicit rank needs world and init_method")
    config = config or MeshConfig(data=world)
    _check_world(config, world)
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dev = _rank_device(device, local_rank, backend)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    _joined["config"] = config
    return MeshSpec(config, rank, dev, backend, **_sub_groups(config, rank))


def process_rows(global_batch: int) -> slice:
    """This process's data row's rows of a global batch, by its place on
    the data axis of the mesh it joined (:func:`init_process_group`,
    :func:`make_mesh`): the ranks of one data row share their rows. A
    process group joined otherwise is all data axis; without one, every
    row."""
    if not dist.is_initialized():
        return slice(None)
    world = dist.get_world_size()
    config = _joined.get("config")
    if config is None or config.data * config.stage != world:
        config = MeshConfig(data=world)
    return MeshSpec(config, dist.get_rank()).rows(global_batch)


def _check_world(config: MeshConfig, world: int) -> None:
    check_mesh_config(config)
    if config.data * config.stage != world:
        raise ValueError(f"MeshConfig(data={config.data}, stage="
                         f"{config.stage}) needs {config.data * config.stage}"
                         f" rank(s) but the process group has {world}")


def make_mesh(config: MeshConfig | None = None, device="cuda") -> MeshSpec:
    """This process's :class:`MeshSpec`: from its process group when it has
    joined one (``config`` defaults to ``data=world``; every rank must
    call, since a ``stage > 1`` mesh creates its sub-groups here), else a
    lone process at ``data=1, stage=1`` on ``device``. A mesh of another
    size than the group raises."""
    from distributed_model_parallel_tpu_torch.models.transformer import (
        resolve_device,
    )

    if not dist.is_initialized():
        config = config or MeshConfig()
        check_mesh_config(config)
        n = config.data * config.stage
        if n != 1:
            raise ValueError(
                f"MeshConfig(data={config.data}, stage={config.stage}) needs "
                f"a process group of {n} ranks: start them with mesh.spawn, "
                f"train_cnn / train_model_parallel --nproc, or torchrun")
        return MeshSpec(config, 0, torch.empty(
            0, device=resolve_device(device)).device, None)
    world = dist.get_world_size()
    config = config or MeshConfig(data=world)
    _check_world(config, world)
    kind = torch.device(device).type
    if kind == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(kind)
    rank = dist.get_rank()
    _joined["config"] = config
    return MeshSpec(config, rank, dev, dist.get_backend(),
                    **_sub_groups(config, rank))


def best_effort_distributed_init(device="cuda") -> bool:
    """Join the process group torchrun's environment describes, if any.
    Returns True when this process is one of several ranks."""
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        init_process_group(device=device)
    return dist.get_world_size() > 1


# -- the launcher --------------------------------------------------------------

def _rank_main(fn, rank, world, init_method, config, device, backend,
               threads, results, args) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        spec = init_process_group(config, rank=rank, world=world,
                                  init_method=init_method, device=device,
                                  backend=backend)
        try:
            out = fn(spec, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def spawn(fn, nproc: int, *args, device="cuda", backend: str | None = None,
          config: MeshConfig | None = None, timeout_s: float = 600.0,
          threads: int | None = None, store_dir: str | None = None) -> list:
    """Run ``fn(spec, *args)`` on ``nproc`` ranks, each a fresh process
    (start method ``spawn``) joined by a ``file://`` store in a temporary
    directory under ``store_dir``, and return the results in rank order.
    ``fn``, ``args`` and the results are pickled, so ``fn`` is a
    module-level function. A rank that raises fails the call with its
    traceback; when ``timeout_s`` runs out every rank still alive is
    killed and :class:`TimeoutError` is raised. ``threads``: torch's
    intra-op threads per rank (default: this process's count over
    ``nproc``)."""
    if torch.device(device).type == "cuda" and backend != "gloo":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is "
                               "available; pass device='cpu' for the CPU")
        if nproc > torch.cuda.device_count():
            raise ValueError(f"{nproc} ranks over NCCL need {nproc} cards, "
                             f"{torch.cuda.device_count()} are visible "
                             f"(backend='gloo' shares cards)")
    if threads is None:
        threads = max(1, torch.get_num_threads() // nproc)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, nproc, init_method, config, device, backend, threads,
            results, args)) for r in range(nproc)]
        try:
            for p in procs:
                p.start()
            out: dict = {}
            while len(out) < nproc:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"spawn: {nproc - len(out)} rank(s) "
                                       f"did not finish in {timeout_s} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in out
                            and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"spawn: rank(s) {dead} exited "
                                           f"with no result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            if alive:
                raise TimeoutError(f"spawn: rank(s) {alive} did not exit")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
            results.close()
    return [out[r] for r in range(nproc)]


# -- straggler budget ----------------------------------------------------------

class StragglerTimeoutError(RuntimeError):
    """A barrier or collective did not complete within its budget: a rank
    is wedged or gone."""


def barrier_with_timeout(fn, timeout_s: float, *, what: str = "barrier",
                         on_timeout=None):
    """Run the blocking rendezvous ``fn()`` (e.g.
    ``ops.collectives.mesh_barrier``) on a daemon thread with a wall-clock
    budget: its result, or its exception re-raised; on timeout
    ``on_timeout(what, timeout_s)`` and :class:`StragglerTimeoutError`.
    The wedged call itself is not cancelled (its thread stays blocked,
    daemonized); the caller gets control back to report the straggler."""
    box: dict = {}
    done = threading.Event()

    def _run():
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller
            box["error"] = e
        finally:
            done.set()

    threading.Thread(target=_run, daemon=True,
                     name=f"dmp-barrier-{what}").start()
    if not done.wait(timeout_s):
        if on_timeout is not None:
            on_timeout(what, timeout_s)
        raise StragglerTimeoutError(
            f"{what} did not complete within {timeout_s:.1f}s — a "
            f"participant is wedged or missing (straggler)")
    if "error" in box:
        raise box["error"]
    return box.get("result")
