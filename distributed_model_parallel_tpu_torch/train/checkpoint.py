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

Resharded restore across world sizes and the topology check
(``restore_resharded``, ``_check_topology``) and the fault injector's
save sites are not ported yet (ROADMAP A11).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import time
import uuid
import zlib
from typing import Any, Callable

import numpy as np

MANIFEST_FILENAME = "dmp_manifest.json"
PAYLOAD_FILENAME = "state.npz"


class CheckpointIntegrityError(RuntimeError):
    """No committed checkpoint version survived verification/restore."""


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
                 meta_fn: Callable[[], dict] | None = None):
        self.directory = os.path.abspath(directory)
        self.keep = max(1, int(keep))
        os.makedirs(self.directory, exist_ok=True)
        self.meta_fn = meta_fn
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
        self.wait_until_finished()
        candidates = self._candidate_paths(name)
        if not candidates:
            raise FileNotFoundError(self._path(name))

        def load(path):
            out = unflatten_like(target, _read_payload(path))
            self.last_restored_path = path
            return out

        if not allow_fallback:
            return load(candidates[0])
        rejected: list[tuple[str, str]] = []
        for path in candidates:
            reason = verify_manifest(path)
            if reason is None:
                # Verified intact: a failure here is a template problem,
                # which an older version of the same run cannot fix.
                return load(path)
            if reason != "missing":
                rejected.append((path, reason))
                if on_fallback is not None:
                    on_fallback(path, reason)
                continue
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
    global step and the recovery budgets (``retries_left``, ``lr_scale``:
    0 and 1.0 until recovery is ported, ROADMAP A11, as the JAX package
    stores them without it)."""
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


def resume_subtree(loader, pos: tuple[int, int], global_step: int) -> dict:
    """The exact-continuation subtree of a trainer that stands at ``pos``
    (epoch, batches consumed: the trainer's count, which a prefetch
    worker running ahead cannot move); ``loader`` is re-synced to it."""
    tree = build_resume_tree(*pos, len(loader), global_step,
                             {"retries_left": 0, "lr_scale": 1.0})
    loader.position(int(tree["loader_epoch"]), int(tree["batch_cursor"]))
    return tree


def fallback_note(log_line: Callable[[str], None]) -> Callable:
    """The ``on_fallback`` of a resume: one log line per rejected
    version."""
    return lambda path, reason: log_line(
        f"checkpoint fallback: {os.path.basename(path)} rejected ({reason})")


def restore_newest(ckpt: Checkpointer, template: Any,
                   slots: tuple[str, ...],
                   log_line: Callable[[str], None]) -> tuple[str, Any]:
    """``(slot, tree)`` of the newest valid version among ``slots``: a
    torn version falls back to the one before, a slot with none left to
    the next slot, each logged; raises :class:`CheckpointIntegrityError`
    when none is restorable."""
    for name in ckpt.names_by_recency(slots):
        try:
            return name, ckpt.restore(template, name, allow_fallback=True,
                                      on_fallback=fallback_note(log_line))
        except CheckpointIntegrityError as e:
            log_line(f"resume: slot {name!r} unusable: {e}")
    raise CheckpointIntegrityError(
        f"resume: no restorable version of {slots} in {ckpt.directory}")


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
