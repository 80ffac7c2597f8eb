"""Process group and ``(data, stage, model, seq, expert)`` mesh — the port
of ``distributed_model_parallel_tpu/mesh.py``.

The JAX package lays its devices out as a named ``jax.sharding.Mesh`` in
one process; the port runs one process per rank, joined by a
``torch.distributed`` process group: NCCL on the card, gloo on the CPU.
The ranks form JAX's device grid over ``(data, stage, model, seq,
expert)``, row-major, as ``make_mesh`` reshapes its devices: rank ``r``
of ``D·S·M·Q·E`` sits at ``data = r // (S·M·Q·E)``, ``stage = r //
(M·Q·E) % S``, ``model = r // (Q·E) % M``, ``seq = r // E % Q``, ``expert
= r % E``; the expert axis is the innermost, so a mesh with ``expert ==
1`` keeps the ranks of the four-axis grid. Each rank belongs to a
sub-group per axis: the ranks that differ from it only along that axis.
The data group pools gradients and BatchNorm statistics, the stage group
is the pipeline's point-to-point ring (the CNN engines' ring of a data
row; the LM's ring of a ``(data, model, seq, expert)`` coordinate), the
model group carries the Megatron all-reduces of tensor parallelism, the
seq group the ring or Ulysses exchanges of sequence parallelism, and the
expert group the all-to-alls of expert parallelism. A rank also belongs
to its replica
group, the ranks that differ from it along ``data`` and ``seq`` (the
ranks that hold the same parameter slices): the Transformer LM averages
every gradient there. With ``stage == model == seq == 1`` the data group
is the whole world. The data axis splits every global batch of ``B``
rows: data row ``d`` holds rows ``[d·B/D, (d+1)·B/D)``, in the order JAX
shards the data axis; the seq axis splits the tokens of a row the same
way.

``dcn_data = H > 1`` factors the data axis into ``H`` host rows of ``D/H``
ranks, host-major, as the JAX package lays out its ``("dcn", data)``
mesh: data index ``d`` sits in dcn row ``d // (D/H)`` at inner index ``d %
(D/H)``. Each rank then also belongs to its inner group (its dcn row:
the fast, within-host links) and its outer group (the ranks of its inner
index across the rows), the two levels ``ops/collectives.
hierarchical_psum`` reduces over; ``MeshConfig(data=4, dcn_data=2)`` is a
2 x 2 grid, ranks {0, 1} in row 0 and {2, 3} in row 1. There is one inner
and one outer group per ``(stage, model, seq, expert)`` coordinate, so the
two levels sit beside any other axis. Everything else runs over the whole
data group, as JAX runs it over ``("dcn", data)``: the Transformer LM's
replica group, and every reduction of the CNN trainers.

* :func:`init_process_group` joins this process to the group, from
  torchrun's environment (``env://``, ``LOCAL_RANK`` picks the card) or
  from an explicit ``(rank, world, init_method)``, and returns its
  :class:`MeshSpec`;
* :func:`make_mesh` is the :class:`MeshSpec` of an already joined
  process (or of a lone process at ``data=1``);
* :func:`spawn` starts ``N`` ranks as fresh processes (start method
  ``spawn``, a ``file://`` store in a temporary directory), runs a
  function on each and returns their results in rank order;
  :class:`RankGroup` is the same launch without blocking (the
  orchestrator's rank-group tenants), and :func:`spawn` waits on one;
* :func:`process_rows` is this process's data row's rows of a global
  batch, from the mesh it joined (``BatchLoader(shard_by_process=True)``);
* :func:`local_batch_slice`, :func:`barrier_with_timeout` and
  :func:`best_effort_distributed_init` keep the JAX package's contracts.

The backend is never switched behind the caller's back: a CUDA rank runs
NCCL, one rank per card, unless the caller asks for gloo (several ranks
sharing one card), and a rank that finds no card raises instead of
running on the CPU.
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

# The mesh this process's group was last laid out as (process_rows).
_joined: dict = {}


# The name of the cross-host factor of the data axis (the JAX package's).
DCN_AXIS = "dcn"


def check_mesh_config(config: MeshConfig) -> None:
    """Raise, in the JAX package's words, on a ``dcn_data`` that does not
    divide ``data``."""
    if config.dcn_data < 1:
        raise ValueError(f"dcn_data must be >= 1, got {config.dcn_data}")
    if config.data % config.dcn_data:
        raise ValueError(f"dcn_data={config.dcn_data} must divide "
                         f"data={config.data}")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """One rank's view of the ``(data, stage, model, seq, expert)`` mesh:
    the mesh config, this rank, its device, the backend of its process
    group (None: a lone process with no group, world 1), its sub-groups
    and, at ``dcn_data > 1``, the inner and outer groups of its two-level
    data axis (None otherwise). ``data_group`` is None when the data axis
    is the whole world (``stage == model == seq == expert == 1``);
    ``stage_group``, ``model_group``, ``seq_group`` and ``expert_group``
    are None where their axis has size 1; ``replica_group`` (data x seq)
    is None at ``seq == 1``, where it is the data group. ``device_ids``:
    the ids the device-health monitor scores this mesh's devices under
    (an orchestrator's pool slot ids; None: this rank's number)."""

    config: MeshConfig
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: str | None = None
    data_group: object = None
    stage_group: object = None
    inner_group: object = None
    outer_group: object = None
    model_group: object = None
    seq_group: object = None
    expert_group: object = None
    replica_group: object = None
    device_ids: tuple | None = None

    @property
    def num_data(self) -> int:
        return self.config.data

    @property
    def num_stages(self) -> int:
        return self.config.stage

    @property
    def num_model(self) -> int:
        return self.config.model

    @property
    def num_seq(self) -> int:
        return self.config.seq

    @property
    def num_expert(self) -> int:
        return self.config.expert

    @property
    def data_axis(self) -> str:
        return self.config.data_axis

    @property
    def stage_axis(self) -> str:
        return self.config.stage_axis

    @property
    def model_axis(self) -> str:
        return self.config.model_axis

    @property
    def seq_axis(self) -> str:
        return self.config.seq_axis

    @property
    def expert_axis(self) -> str:
        return self.config.expert_axis

    @property
    def dcn_axis(self) -> str | None:
        """The cross-host factor of the data axis (None on one host)."""
        return DCN_AXIS if self.config.dcn_data > 1 else None

    @property
    def ici_data_axis(self) -> str:
        """The within-host factor of the data axis."""
        return self.config.data_axis

    @property
    def hierarchy(self) -> tuple | None:
        """``(inner_group, outer_group)`` of a two-level data axis (None
        without a process group or at ``dcn_data == 1``)."""
        if self.backend is None or self.dcn_axis is None:
            return None
        return self.inner_group, self.outer_group

    @property
    def health_ids(self) -> tuple:
        """The device ids a trainer's health observations carry."""
        return (tuple(self.device_ids) if self.device_ids is not None
                else (self.rank,))

    @property
    def grid(self) -> tuple[int, int, int, int, int]:
        """This rank's ``(data, stage, model, seq, expert)`` position in
        JAX's device grid."""
        return rank_coords(self.rank, self.config)

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's ``(data, stage)`` position in JAX's device grid."""
        return self.grid[:2]

    @property
    def data_index(self) -> int:
        return self.grid[0]

    @property
    def stage_index(self) -> int:
        return self.grid[1]

    @property
    def model_index(self) -> int:
        return self.grid[2]

    @property
    def seq_index(self) -> int:
        return self.grid[3]

    @property
    def expert_index(self) -> int:
        return self.grid[4]

    @property
    def copy_index(self) -> int:
        """This rank's row-major index over the model, seq and expert axes:
        which copy of its (data, stage) position it is where a trainer
        replicates over those axes (the CNN trainers)."""
        return ((self.model_index * self.num_seq + self.seq_index)
                * self.num_expert + self.expert_index)

    @property
    def group(self):
        """The process group of the data axis — this rank's stage, model
        and seq position across the data rows (None without a process
        group)."""
        if self.backend is None:
            return None
        return self.data_group if self.data_group is not None else \
            dist.group.WORLD

    @property
    def mesh_group(self):
        """The process group of every rank of this mesh: its data group
        where the mesh is that axis alone (a mesh laid over a sub-group of
        the world included), else the world (``None``)."""
        return (self.group if self.config.num_devices == self.num_data
                else None)

    @property
    def replicas(self):
        """The process group over which the Transformer LM averages its
        gradients: the ranks holding the same parameter slices (data x
        seq; None without a process group)."""
        if self.replica_group is not None:
            return self.replica_group
        return self.group

    def stage_rank(self, stage: int) -> int:
        """The global rank of ``stage`` on this rank's stage ring (its data
        row, at its model, seq and expert position)."""
        c = list(self.grid)
        c[1] = stage
        return grid_rank(c, self.config)

    def rows(self, global_batch: int) -> slice:
        """This rank's data row's rows of a global batch."""
        local = local_batch_slice(global_batch, self)
        return slice(self.data_index * local, (self.data_index + 1) * local)


def _shape(config: MeshConfig) -> tuple[int, int, int, int, int]:
    return config.data, config.stage, config.model, config.seq, config.expert


def rank_coords(rank: int, config: MeshConfig
                ) -> tuple[int, int, int, int, int]:
    """``(data, stage, model, seq, expert)`` of global ``rank``,
    row-major."""
    out = []
    for n in reversed(_shape(config)):
        rank, i = divmod(rank, n)
        out.append(i)
    return tuple(reversed(out))


def grid_rank(coords, config: MeshConfig) -> int:
    """The global rank at ``(data, stage, model, seq, expert)``
    (row-major)."""
    rank = 0
    for i, n in zip(coords, _shape(config)):
        rank = rank * n + i
    return rank


def axis_groups(config: MeshConfig, axes: tuple[int, ...]) -> list[list]:
    """The global ranks of every sub-group that varies along ``axes``
    (indices into ``(data, stage, model, seq, expert)``), the other
    coordinates
    fixed: groups in row-major order of the fixed coordinates, ranks in
    row-major order of the varying ones."""
    import itertools

    shape = _shape(config)
    fixed = [a for a in range(len(shape)) if a not in axes]
    out = []
    for f in itertools.product(*(range(shape[a]) for a in fixed)):
        ranks = []
        for v in itertools.product(*(range(shape[a]) for a in axes)):
            c = [0] * len(shape)
            for a, i in zip(fixed, f):
                c[a] = i
            for a, i in zip(axes, v):
                c[a] = i
            ranks.append(grid_rank(c, config))
        out.append(ranks)
    return out


def mesh_groups(data: int, stage: int) -> tuple[list, list]:
    """The global ranks of every data sub-group (one per stage: the ranks
    of that stage across the data rows) and of every stage ring (one per
    data row) of a ``(data, stage)`` mesh, in the order
    :func:`init_process_group` creates them."""
    config = MeshConfig(data=data, stage=stage)
    return axis_groups(config, (0,)), axis_groups(config, (1,))


def dcn_groups(data: int, stage: int, dcn: int,
               rest: int = 1) -> tuple[list, list]:
    """The global ranks of every inner group (per ``(stage, rest)``
    coordinate, per dcn row: the row's data indices) and of every outer
    group (per coordinate, per inner index: that index across the rows) of
    a two-level data axis, in the order :func:`init_process_group` creates
    them. ``rest`` is ``model * seq * expert``: the coordinates of those
    axes, row-major, inside each stage."""
    inner = data // dcn
    at = lambda row, j, s, x: ((row * inner + j) * stage + s) * rest + x
    return ([[at(row, j, s, x) for j in range(inner)]
             for s in range(stage) for x in range(rest)
             for row in range(dcn)],
            [[at(row, j, s, x) for row in range(dcn)]
             for s in range(stage) for x in range(rest)
             for j in range(inner)])


def _mine(rank: int, groups: list[list]):
    """Create one process group per rank list (every rank creates all of
    them, in the same order) and return the one holding ``rank``."""
    made = [dist.new_group(r) for r in groups]
    return next(g for g, r in zip(made, groups) if rank in r)


def _sub_groups(config: MeshConfig, rank: int) -> dict:
    """Create every sub-group of the mesh (each rank must create all of
    them, in the same order: data, stage, model, seq, expert, replica,
    then the two levels of the data axis) and return this rank's. An axis
    of size 1 has none; the data axis has none when it is the whole
    world."""
    out = {}
    spread = config.stage * config.model * config.seq * config.expert
    if spread > 1:
        out["data_group"] = _mine(rank, axis_groups(config, (0,)))
    for name, axis, n in (("stage_group", 1, config.stage),
                          ("model_group", 2, config.model),
                          ("seq_group", 3, config.seq),
                          ("expert_group", 4, config.expert)):
        if n > 1:
            out[name] = _mine(rank, axis_groups(config, (axis,)))
    if config.seq > 1 and config.data > 1:
        out["replica_group"] = _mine(rank, axis_groups(config, (0, 3)))
    elif config.seq > 1:
        out["replica_group"] = out["seq_group"]
    if config.dcn_data > 1:
        inner_ranks, outer_ranks = dcn_groups(
            config.data, config.stage, config.dcn_data,
            config.model * config.seq * config.expert)
        out.update(inner_group=_mine(rank, inner_ranks),
                   outer_group=_mine(rank, outer_ranks))
    return out


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
    index = torch.device(device).index
    if index is not None:
        # The caller placed this rank (an orchestrator's slot).
        if index >= n:
            raise ValueError(f"{device} is not visible ({n} card(s))")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
        return dev
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
    if config is None or config.num_devices != world:
        config = MeshConfig(data=world)
    return MeshSpec(config, dist.get_rank()).rows(global_batch)


def _check_world(config: MeshConfig, world: int) -> None:
    check_mesh_config(config)
    if config.num_devices != world:
        raise ValueError(f"{_describe(config)} needs {config.num_devices} "
                         f"rank(s) but the process group has {world}")


def _describe(config: MeshConfig) -> str:
    sizes = ", ".join(f"{k}={v}" for k, v in config.axis_sizes().items()
                      if v != 1 or k == config.data_axis)
    return f"MeshConfig({sizes})"


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
        n = config.num_devices
        if n != 1:
            raise ValueError(
                f"{_describe(config)} needs a process group of {n} ranks: "
                f"start them with mesh.spawn, train_cnn / "
                f"train_model_parallel / train_lm --nproc, or torchrun")
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

def _run_rank(fn, rank, world, init_method, config, device, backend,
              args):
    """``fn(spec, *args)`` as ``rank`` of a group this process joins and
    then leaves."""
    spec = init_process_group(config, rank=rank, world=world,
                              init_method=init_method, device=device,
                              backend=backend)
    try:
        return fn(spec, *args)
    finally:
        dist.destroy_process_group()


def _rank_main(fn, rank, world, init_method, config, device, backend,
               threads, results, args) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        out = _run_rank(fn, rank, world, init_method, config, device,
                        backend, args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def run_here(fn, *args, device="cuda", backend: str | None = None,
             config: MeshConfig | None = None,
             store_dir: str | None = None):
    """``fn(spec, *args)`` on a group of one rank that this process joins
    and then leaves: :func:`spawn`'s one rank without a process start,
    sharing this process's device context and caches (cuDNN's autotuner
    results, built kernels)."""
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        return _run_rank(fn, 0, 1, "file://" + os.path.join(tmp, "store"),
                         config, device, backend, args)


class RankGroup:
    """``fn(spec, *args)`` on ``nproc`` ranks, each a fresh process (start
    method ``spawn``) joined by a ``file://`` store in a temporary
    directory under ``store_dir``, started without blocking: :meth:`poll`
    takes the ranks' results as they come, :meth:`failed` names the ranks
    that exited with no result, :meth:`close` kills what is still alive.
    ``fn``, ``args`` and the results are pickled, so ``fn`` is a
    module-level function; ``args`` may hold ``multiprocessing``
    primitives of the ``spawn`` context. ``devices`` (optional, one per
    rank) places rank r on ``devices[r]``, else on ``device`` (a CUDA rank
    on ``cuda:r``). ``threads``: torch's intra-op threads per rank
    (default: this process's count over ``nproc``)."""

    def __init__(self, fn, nproc: int, *args, device="cuda",
                 backend: str | None = None,
                 config: MeshConfig | None = None,
                 threads: int | None = None, store_dir: str | None = None,
                 devices=None):
        kinds = {torch.device(d).type for d in (devices or [device])}
        if "cuda" in kinds and backend != "gloo":
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' but no CUDA device is "
                                   "available; pass device='cpu' for the "
                                   "CPU")
            if devices is None and nproc > torch.cuda.device_count():
                raise ValueError(f"{nproc} ranks over NCCL need {nproc} "
                                 f"cards, {torch.cuda.device_count()} are "
                                 f"visible (backend='gloo' shares cards)")
        if devices is not None and len(devices) != nproc:
            raise ValueError(f"{len(devices)} devices for {nproc} ranks")
        if threads is None:
            threads = max(1, torch.get_num_threads() // nproc)
        self.nproc = nproc
        ctx = torch.multiprocessing.get_context("spawn")
        self.results = ctx.Queue()
        self._tmp = tempfile.TemporaryDirectory(dir=store_dir)
        init_method = "file://" + os.path.join(self._tmp.name, "store")
        self.procs = [ctx.Process(target=_rank_main, args=(
            fn, r, nproc, init_method, config,
            devices[r] if devices is not None else device, backend,
            threads, self.results, args)) for r in range(nproc)]
        for p in self.procs:
            p.start()

    def poll(self, timeout: float) -> tuple | None:
        """One ``(rank, ok, value)`` — ``value`` the rank's result, or its
        traceback when ``ok`` is False — or None after ``timeout`` s."""
        try:
            return self.results.get(timeout=timeout)
        except queue.Empty:
            return None

    def failed(self, done) -> list[int]:
        """The ranks, not in ``done``, that exited with no result."""
        return [r for r, p in enumerate(self.procs) if r not in done
                and p.exitcode not in (None, 0)]

    def alive(self) -> list[int]:
        return [r for r, p in enumerate(self.procs) if p.is_alive()]

    def join(self, timeout: float) -> list[int]:
        """Wait up to ``timeout`` s in all for the ranks to exit; the ranks
        still alive."""
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        return self.alive()

    def close(self) -> None:
        """Kill every rank still alive and remove the store."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        self.results.close()
        self._tmp.cleanup()


def spawn(fn, nproc: int, *args, device="cuda", backend: str | None = None,
          config: MeshConfig | None = None, timeout_s: float = 600.0,
          threads: int | None = None, store_dir: str | None = None) -> list:
    """Run ``fn(spec, *args)`` on ``nproc`` ranks (a :class:`RankGroup`)
    and return the results in rank order. A rank that raises fails the
    call with its traceback; when ``timeout_s`` runs out every rank still
    alive is killed and :class:`TimeoutError` is raised."""
    deadline = time.monotonic() + timeout_s
    group = RankGroup(fn, nproc, *args, device=device, backend=backend,
                      config=config, threads=threads, store_dir=store_dir)
    try:
        out: dict = {}
        while len(out) < nproc:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {nproc - len(out)} rank(s) "
                                   f"did not finish in {timeout_s} s")
            got = group.poll(min(left, 1.0))
            if got is None:
                dead = group.failed(out)
                if dead:
                    raise RuntimeError(f"spawn: rank(s) {dead} exited "
                                       f"with no result")
                continue
            rank, ok, value = got
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
            out[rank] = value
        alive = group.join(max(deadline - time.monotonic(), 1.0))
        if alive:
            raise TimeoutError(f"spawn: rank(s) {alive} did not exit")
    finally:
        group.close()
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
