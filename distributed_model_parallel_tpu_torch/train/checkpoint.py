"""Checkpoint / resume — the port of ``distributed_model_parallel_tpu/
train/checkpoint.py``: the reference's best-accuracy save ``{net, acc,
epoch}`` and ``--resume`` (``data_parallel.py:80-87,143-155``), with the
JAX package's crash safety and integrity checks.

A checkpoint is one tree of float32/int numpy arrays (the trainer's:
parameters, BN statistics and momentum in the JAX package's layout, the
update count, best accuracy, epoch and the exact-continuation subtree),
stored with ``numpy.savez`` (no pickle) under flattened key paths
(``params/3/conv0/kernel``). The JAX package's own copies of the
framework-free parts are kept here (the port imports nothing of it):

* versioned slots ``{name}-{v}``: a save writes a temporary directory and
  commits it by an atomic rename; the newest ``keep`` versions are kept
  per slot, older ones pruned only at the next save, after the newer one
  committed — there is never a moment with no committed version;
* ``dmp_manifest.json`` in each committed version: size and crc32 of every
  file and a ``meta`` stamp (:func:`write_manifest`,
  :func:`verify_manifest`, :func:`read_manifest_meta`);
* ``restore(..., allow_fallback=True)`` skips a torn or corrupt newest
  version (or one without a manifest that fails to load) for the one
  before and raises :class:`CheckpointIntegrityError` when none survives;
  a verified version that does not fit the template is a structure
  problem and raises at once;
* ``save(..., wait=False)`` copies the tree to host memory before it
  returns and writes on one background thread; the manifest is written
  at :meth:`Checkpointer.wait_until_finished`, as the JAX package's is.

* ``restore_resharded`` restores a checkpoint written on any mesh: every
  leaf is whole in the file and every rank cuts its own slices, so a
  restore onto another split needs only the global shapes to agree. They
  are checked first (:meth:`Checkpointer._check_topology`, from the
  ``.npy`` headers, no payload read): state that encodes the saving
  topology (ddp's per-replica BN statistics, stacked over the replicas)
  raises :class:`TopologyMismatchError` naming both shapes, through the
  fallback loop, since every version of the run shares the conflict;
* ``injector`` (``utils/faults.FaultInjector``) serves the ``save``
  site's faults: ``save_fail`` leaves a torn version directory and
  raises ``InjectedFaultError``, ``tear_save`` commits and then
  truncates the files.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import time
import uuid
import zipfile
import zlib
from typing import Any, Callable

import numpy as np

MANIFEST_FILENAME = "dmp_manifest.json"
PAYLOAD_FILENAME = "state.npz"


class CheckpointIntegrityError(RuntimeError):
    """No committed checkpoint version survived verification/restore."""


class TopologyMismatchError(RuntimeError):
    """A checkpoint's *global* array shapes conflict with the restore
    target's — state that depends on the saving topology (ddp's
    per-replica BatchNorm statistics carry a leading replica axis) cannot
    be resharded onto a mesh of another degree. ``conflicts`` lists
    ``(key, saved shape, target shape)``; deliberately NOT a
    ``ValueError``, so template-layout retries let it through."""

    def __init__(self, conflicts: list, *, saved_mesh=None,
                 current_mesh=None):
        self.conflicts = list(conflicts)
        self.saved_mesh = saved_mesh
        self.current_mesh = current_mesh
        detail = "; ".join(
            f"{path}: checkpoint {tuple(saved)} vs target {tuple(want)}"
            for path, saved, want in self.conflicts[:8])
        mesh = ""
        if saved_mesh or current_mesh:
            mesh = (f" (saved on mesh {saved_mesh}, restoring on "
                    f"{current_mesh})")
        super().__init__(
            f"checkpoint global shapes conflict with the restore target on "
            f"{len(self.conflicts)} leaves{mesh}: {detail}")


def _file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def write_manifest(path: str, meta: dict | None = None) -> str:
    """Write the integrity manifest for a committed checkpoint directory
    (atomic: temp file + rename). ``meta`` is the caller's stamp; it is
    recorded verbatim and never participates in verification. Returns
    the manifest path."""
    entries: dict[str, dict] = {}
    for root, _dirs, files in os.walk(path):
        for fn in files:
            if fn == MANIFEST_FILENAME:
                continue
            p = os.path.join(root, fn)
            rel = os.path.relpath(p, path)
            entries[rel] = {"size": os.path.getsize(p),
                            "crc32": _file_crc32(p)}
    out = os.path.join(path, MANIFEST_FILENAME)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"created": time.time(), "files": entries,
                   "meta": dict(meta or {})}, f)
    os.replace(tmp, out)
    return out


def read_manifest_meta(path: str) -> dict:
    """The ``meta`` stamp of one checkpoint version directory; ``{}`` when
    there is no manifest or no stamp."""
    try:
        with open(os.path.join(path, MANIFEST_FILENAME)) as f:
            return dict(json.load(f).get("meta") or {})
    except (OSError, json.JSONDecodeError, ValueError, TypeError):
        return {}


def verify_manifest(path: str) -> str | None:
    """Check a checkpoint directory against its manifest: ``None`` when
    every recorded file matches (size + crc32), ``"missing"`` when there
    is no manifest (unverifiable, not necessarily bad), else a reason."""
    mpath = os.path.join(path, MANIFEST_FILENAME)
    if not os.path.exists(mpath):
        return "missing"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (json.JSONDecodeError, KeyError, OSError) as e:
        return f"unreadable manifest: {type(e).__name__}"
    for rel, want in files.items():
        p = os.path.join(path, rel)
        if not os.path.exists(p):
            return f"missing file {rel}"
        size = os.path.getsize(p)
        if size != want["size"]:
            return (f"size mismatch on {rel} "
                    f"({size} != {want['size']} bytes)")
        if _file_crc32(p) != want["crc32"]:
            return f"checksum mismatch on {rel}"
    return None


# -- trees <-> flat key paths -----------------------------------------------

def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """``{"a/0/b": array}`` for every leaf of nested dicts/tuples/lists;
    each leaf a host copy (``np.array``), so the caller may go on
    changing the tensors it came from."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: np.array(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in items:
        if "/" in k:
            raise ValueError(f"checkpoint key {k!r} contains '/'")
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else k))
    return out


def unflatten_like(template: Any, flat: dict, prefix: str = "") -> Any:
    """``template``'s structure with the leaves of ``flat``; the keys
    must be exactly the template's and each shape the template leaf's
    (``ValueError`` otherwise)."""
    if prefix == "":
        want = set(flatten_tree(template))
        if want != set(flat):
            raise ValueError(
                f"checkpoint keys differ from the template: missing "
                f"{sorted(want - set(flat))[:8]}, extra "
                f"{sorted(set(flat) - want)[:8]}")
    join = (lambda k: f"{prefix}/{k}" if prefix else str(k))
    if isinstance(template, dict):
        return {k: unflatten_like(v, flat, join(k))
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(unflatten_like(v, flat, join(i))
                              for i, v in enumerate(template))
    got = flat[prefix]
    if np.shape(got) != np.shape(template):
        raise ValueError(f"checkpoint leaf {prefix}: shape "
                         f"{np.shape(got)}, the template's "
                         f"{np.shape(template)}")
    return got


def _payload_shapes(path: str) -> dict[str, tuple]:
    """``{key: shape}`` of a version's payload from the ``.npy`` headers
    inside the ``.npz`` (no array is read)."""
    out = {}
    with zipfile.ZipFile(os.path.join(path, PAYLOAD_FILENAME)) as z:
        for name in z.namelist():
            with z.open(name) as f:
                fmt = np.lib.format
                read = (fmt.read_array_header_1_0
                        if fmt.read_magic(f) == (1, 0)
                        else fmt.read_array_header_2_0)
                shape, _, _ = read(f)
            out[name[:-4] if name.endswith(".npy") else name] = tuple(shape)
    return out


def _read_payload(path: str) -> dict[str, np.ndarray]:
    with np.load(os.path.join(path, PAYLOAD_FILENAME),
                 allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _write_payload(path: str, flat: dict) -> None:
    """Write ``flat`` into a temporary directory beside ``path`` and
    rename it to ``path`` (atomic); raises FileExistsError if ``path``
    was committed meanwhile."""
    tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    try:
        with open(os.path.join(tmp, PAYLOAD_FILENAME), "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.rename(tmp, path)
        except OSError as e:
            raise FileExistsError(path) from e
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _manifest_if_kept(path: str, stamp: dict) -> None:
    """The manifest of a version just committed, unless another writer
    sharing the directory pruned it meanwhile."""
    try:
        write_manifest(path, meta=stamp)
    except FileNotFoundError:
        if os.path.isdir(path):
            raise


class Checkpointer:
    """Versioned, integrity-checked checkpoints of numpy trees in
    ``directory`` (see the module docstring). ``meta_fn`` stamps every
    committed version's manifest (captured at :meth:`save` time).
    ``last_restored_path`` is the version directory the last restore
    read (an older one than the newest after a fallback)."""

    def __init__(self, directory: str, *, keep: int = 2,
                 meta_fn: Callable[[], dict] | None = None,
                 injector=None):
        self.directory = os.path.abspath(directory)
        self.keep = max(1, int(keep))
        os.makedirs(self.directory, exist_ok=True)
        self.meta_fn = meta_fn
        self._injector = injector
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._futures: list = []
        self._pending_manifest: list[tuple[str, dict]] = []
        self.last_restored_path: str | None = None

    def _path(self, name: str, version: int | None = None) -> str:
        leaf = name if version is None else f"{name}-{version}"
        return os.path.join(self.directory, leaf)

    def _versions(self, name: str) -> list[int]:
        """Committed version numbers for ``name``, ascending; temporary
        directories (``{name}-{v}.tmp-...``) never match."""
        pat = re.compile(re.escape(name) + r"-(\d+)$")
        out = []
        for entry in os.listdir(self.directory):
            m = pat.match(entry)
            if m and os.path.isdir(os.path.join(self.directory, entry)):
                out.append(int(m.group(1)))
        return sorted(out)

    def _latest_path(self, name: str) -> str | None:
        versions = self._versions(name)
        if versions:
            return self._path(name, versions[-1])
        legacy = self._path(name)
        return legacy if os.path.exists(legacy) else None

    def _candidate_paths(self, name: str) -> list[str]:
        """Restore candidates, newest committed version first, a bare
        legacy directory last."""
        out = [self._path(name, v)
               for v in sorted(self._versions(name), reverse=True)]
        legacy = self._path(name)
        if os.path.exists(legacy):
            out.append(legacy)
        return out

    def save(self, tree: Any, name: str = "ckpt", *, wait: bool = True,
             keep: int | None = None, meta: dict | None = None) -> str:
        """Commit ``tree`` as the next version of slot ``name`` and return
        its directory. ``wait=False`` returns once the tree is copied to
        host memory; the write runs on the background thread."""
        self.wait_until_finished()          # the previous save committed...
        versions = self._versions(name)
        keep_n = max(1, int(keep)) if keep is not None else self.keep
        for v in versions[:-keep_n]:        # ...keep the newest K, prune older
            shutil.rmtree(self._path(name, v), ignore_errors=True)
        if versions and os.path.exists(self._path(name)):
            shutil.rmtree(self._path(name), ignore_errors=True)
        flat = flatten_tree(tree)
        stamp = dict(self.meta_fn() or {}) if self.meta_fn is not None else {}
        if meta:
            stamp.update(meta)
        first = versions[-1] + 1 if versions else 0
        path = self._path(name, first)
        faults = (self._injector.poll("save")
                  if self._injector is not None else [])
        if any(f.kind == "save_fail" for f in faults):
            # Die "mid-write": a version directory the scan sees as
            # committed, holding no restorable checkpoint.
            from distributed_model_parallel_tpu_torch.utils.faults import (
                InjectedFaultError,
            )

            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "_DMP_TORN"), "w") as f:
                f.write("injected save failure\n")
            raise InjectedFaultError(f"injected save failure for {path}")
        if any(f.kind == "tear_save" for f in faults):
            wait = True

        def commit() -> str:
            v = first
            while True:                     # another writer took v: next
                target = self._path(name, v)
                try:
                    _write_payload(target, flat)
                    return target
                except FileExistsError:
                    v += 1

        if wait:
            path = commit()
            _manifest_if_kept(path, stamp)
            if any(f.kind == "tear_save" for f in faults):
                from distributed_model_parallel_tpu_torch.utils.faults import (
                    tear_checkpoint,
                )

                tear_checkpoint(path)
            return path
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="dmp-checkpoint")
        self._futures.append((self._pool.submit(commit), stamp))
        return path

    def wait_until_finished(self) -> None:
        """Block until any background save has committed, then write the
        manifests of the newly committed versions; the writer thread
        ends here."""
        while self._futures:
            future, stamp = self._futures.pop(0)
            _manifest_if_kept(future.result(), stamp)
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def manifest_meta(self, name: str = "ckpt") -> dict:
        """The newest committed version's manifest ``meta`` stamp; ``{}``
        when absent."""
        self.wait_until_finished()
        path = self._latest_path(name)
        return read_manifest_meta(path) if path is not None else {}

    def restore(self, target: Any, name: str = "ckpt", *,
                allow_fallback: bool = False,
                on_fallback: Callable[[str, str], None] | None = None
                ) -> Any:
        """The newest committed version of ``name`` in ``target``'s
        structure (numpy leaves; ``target`` gives keys and shapes).
        FileNotFoundError if absent. With ``allow_fallback`` each
        candidate is verified first and a torn one skipped
        (``on_fallback(path, reason)`` sees each rejection)."""
        return self._restore(target, name, allow_fallback, on_fallback,
                             None, topology=False)

    def _check_topology(self, path: str, target: Any) -> None:
        """Raise :class:`TopologyMismatchError` when the version's global
        leaf shapes conflict with ``target``'s. Missing or extra keys are
        left to the restore (a template-layout problem, not a topology
        one); an unreadable payload is left to the fallback."""
        try:
            saved = _payload_shapes(path)
        except Exception:  # noqa: BLE001 - a torn version: the restore sees it
            return
        want = {k: tuple(np.shape(v)) for k, v in flatten_tree(target).items()}
        conflicts = [(k, saved[k], want[k]) for k in sorted(want)
                     if k in saved and tuple(saved[k]) != want[k]]
        if conflicts:
            raise TopologyMismatchError(
                conflicts, saved_mesh=read_manifest_meta(path).get("mesh"))

    def restore_resharded(self, target: Any, name: str = "ckpt", *,
                          allow_fallback: bool = True,
                          on_fallback: Callable[[str, str], None] | None = None,
                          verify_memo: dict | None = None) -> Any:
        """:meth:`restore` onto this run's mesh, whatever mesh the version
        was written on (the leaves are whole; the caller cuts its
        slices). Global shapes are checked first and a conflict raises
        :class:`TopologyMismatchError` through the fallback loop. Torn
        versions fall back as in :meth:`restore`. ``verify_memo`` caches
        each path's manifest check (a crc32 sweep of the files) across
        calls: an elastic resume tries several templates on one slot."""
        return self._restore(target, name, allow_fallback, on_fallback,
                             verify_memo, topology=True)

    def _restore(self, target: Any, name: str, allow_fallback: bool,
                 on_fallback: Callable[[str, str], None] | None,
                 verify_memo: dict | None, *, topology: bool) -> Any:
        self.wait_until_finished()
        candidates = self._candidate_paths(name)
        if not candidates:
            raise FileNotFoundError(self._path(name))

        def verify(path):
            if verify_memo is None:
                return verify_manifest(path)
            if path not in verify_memo:
                verify_memo[path] = verify_manifest(path)
            return verify_memo[path]

        def load(path):
            if topology:
                self._check_topology(path, target)
            out = unflatten_like(target, _read_payload(path))
            self.last_restored_path = path
            return out

        if not allow_fallback:
            return load(candidates[0])
        rejected: list[tuple[str, str]] = []
        for path in candidates:
            reason = verify(path)
            if reason is None:
                # Verified intact: a failure here is a template problem,
                # which an older version of the same run cannot fix.
                return load(path)
            if reason != "missing":
                rejected.append((path, reason))
                if on_fallback is not None:
                    on_fallback(path, reason)
                continue
            if topology:
                self._check_topology(path, target)
            try:
                return load(path)
            except Exception as e:  # noqa: BLE001 - unverifiable version
                detail = f"restore failed: {type(e).__name__}: {e}"
                rejected.append((path, detail))
                if on_fallback is not None:
                    on_fallback(path, detail)
        raise CheckpointIntegrityError(
            f"no restorable version of {name!r} in {self.directory}: "
            + "; ".join(f"{os.path.basename(p)} ({r[:160]})"
                        for p, r in rejected))

    def restore_subtree(self, target: Any, name: str = "ckpt") -> Any:
        """The leaves of ``target``'s keys from the newest committed version
        of ``name`` (numpy leaves; the rest of the checkpoint is not read
        into the result): JAX's partial restore, e.g. the params of an LM
        checkpoint for decoding. A key the checkpoint lacks, or a shape
        that differs, raises ``ValueError``; FileNotFoundError if absent."""
        self.wait_until_finished()
        path = self._latest_path(name)
        if path is None:
            raise FileNotFoundError(self._path(name))
        flat = _read_payload(path)
        want = flatten_tree(target)
        missing = sorted(set(want) - set(flat))
        if missing:
            raise ValueError(f"checkpoint {path} lacks {missing[:8]}")
        self.last_restored_path = path
        return unflatten_like(target, {k: flat[k] for k in want})

    def exists(self, name: str = "ckpt") -> bool:
        self.wait_until_finished()
        return self._latest_path(name) is not None

    def names_by_recency(self, names: tuple[str, ...]) -> list[str]:
        """The subset of ``names`` with a committed version, newest first
        by the latest version's mtime."""
        self.wait_until_finished()
        stamped = []
        for name in names:
            path = self._latest_path(name)
            if path is not None:
                stamped.append((os.path.getmtime(path), name))
        return [name for _, name in sorted(stamped, reverse=True)]

    def newest_name(self, names: tuple[str, ...]) -> str | None:
        """The name whose latest committed version is most recent."""
        ordered = self.names_by_recency(names)
        return ordered[0] if ordered else None


# -- the exact-continuation subtree (the JAX package's train/elastic.py) ----

def build_resume_tree(epoch: int, cursor: int, epoch_len: int,
                      global_step: int, budgets: dict) -> dict:
    """The subtree every trainer checkpoint carries: the loader position,
    normalized (a fully consumed epoch is the start of the next), the
    global step and the recovery supervisor's live budgets
    (``retries_left``, ``lr_scale``: ``RecoverySupervisor.budgets()``)."""
    ep, cur = int(epoch), int(cursor)
    if cur >= epoch_len:
        ep, cur = ep + 1, 0
    return {"loader_epoch": np.asarray(ep, np.int32),
            "batch_cursor": np.asarray(cur, np.int32),
            "global_step": np.asarray(global_step, np.int32),
            "retries_left": np.asarray(budgets["retries_left"], np.int32),
            "lr_scale": np.asarray(budgets["lr_scale"], np.float32)}


def unpack_resume_tree(ri: dict) -> tuple[int, int, int, int, float]:
    """``(epoch, cursor, global_step, retries_left, lr_scale)`` from a
    restored resume subtree."""
    return (int(ri["loader_epoch"]), int(ri["batch_cursor"]),
            int(ri["global_step"]), int(ri["retries_left"]),
            float(ri["lr_scale"]))


# -- what both CNN trainers do around a resume ------------------------------

def manifest_stamp(workload: str, mesh, n_devices: int, global_step: int,
                   **extra) -> dict:
    """The ``meta`` of every committed version: the saving topology and
    the exact position, readable without a restore."""
    return {"workload": workload, **extra,
            "mesh": {**mesh.axis_sizes(), "dcn_data": mesh.dcn_data},
            "n_devices": int(n_devices), "global_step": int(global_step)}


def resume_subtree(loader, pos: tuple[int, int], global_step: int,
                   budgets: dict) -> dict:
    """The exact-continuation subtree of a trainer that stands at ``pos``
    (epoch, batches consumed: the trainer's count, which a prefetch
    worker running ahead cannot move) with the supervisor's ``budgets``;
    ``loader`` is re-synced to it."""
    tree = build_resume_tree(*pos, len(loader), global_step, budgets)
    loader.position(int(tree["loader_epoch"]), int(tree["batch_cursor"]))
    return tree


def fallback_note(log_line: Callable[[str], None]) -> Callable:
    """The ``on_fallback`` of a resume: one log line per rejected
    version."""
    return lambda path, reason: log_line(
        f"checkpoint fallback: {os.path.basename(path)} rejected ({reason})")


def resume_position(slot: str, restored: dict, loader,
                    log_line: Callable[[str], None]) -> tuple[int, int]:
    """Put ``loader`` where the run restored from ``slot`` stood, log the
    resume line and return ``(start_epoch, global_step)``. The
    best-accuracy slot's epoch lags when later epochs did not improve;
    the loader's position is where training stood."""
    ep, cur, gs, _, _ = unpack_resume_tree(restored["resume"])
    loader.load_state_dict({"epoch": ep, "batch_cursor": cur})
    start_epoch = max(int(restored["epoch"]), loader.epoch)
    log_line(f"resume: slot {slot!r} -> epoch {start_epoch} batch "
             f"{loader.cursor} (global step {gs})")
    return start_epoch, gs
