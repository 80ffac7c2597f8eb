"""The port's ``train/checkpoint.Checkpointer`` held to the cases of
``tests/test_checkpoint_integrity.py``: the integrity manifest written
and verified; truncation, a bit flip and a missing file caught; a
leftover temporary directory skipped; a torn newest version falling back
to the one before (with and without its manifest); every version torn
raising; a verified version that does not fit the template failing
fast; keep-K and keep-1 retention; an asynchronous save's manifest
written at the wait; and the tree's flat key paths."""

import json
import os

import numpy as np
import pytest

from distributed_model_parallel_tpu_torch.train.checkpoint import (
    MANIFEST_FILENAME,
    PAYLOAD_FILENAME,
    CheckpointIntegrityError,
    Checkpointer,
    build_resume_tree,
    flatten_tree,
    unflatten_like,
    unpack_resume_tree,
    verify_manifest,
    write_manifest,
)

pytestmark = pytest.mark.torch_port


def _tree(v: float):
    return {"w": np.full((4, 4), v, np.float32),
            "step": np.asarray(int(v), np.int32),
            "units": ({"conv": {"kernel": np.full((3,), v, np.float32)}},
                      {})}


def _assert_w(restored, v: float):
    np.testing.assert_array_equal(restored["w"],
                                  np.full((4, 4), v, np.float32))
    assert int(restored["step"]) == int(v)


def _tear(path: str) -> None:
    """A torn write: every file cut to half its length."""
    for root, _dirs, files in os.walk(path):
        for fn in files:
            if fn != MANIFEST_FILENAME:
                p = os.path.join(root, fn)
                with open(p, "r+b") as f:
                    f.truncate(os.path.getsize(p) // 2)


def test_manifest_written_at_save_and_verifies(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    path = ckpt.save(_tree(1.0), "m")
    mpath = os.path.join(path, MANIFEST_FILENAME)
    assert os.path.exists(mpath)
    assert verify_manifest(path) is None
    manifest = json.load(open(mpath))
    assert set(manifest["files"]) == {PAYLOAD_FILENAME}
    _assert_w(ckpt.restore(_tree(0.0), "m"), 1.0)


def test_manifest_catches_truncation_and_missing_files(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    path = ckpt.save(_tree(1.0), "m")
    p = os.path.join(path, PAYLOAD_FILENAME)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 1)
    assert "mismatch" in verify_manifest(path)
    os.remove(p)
    assert "missing file" in verify_manifest(path)


def test_manifest_catches_bitflip(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    path = ckpt.save(_tree(1.0), "m")
    p = os.path.join(path, PAYLOAD_FILENAME)
    data = bytearray(open(p, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(p, "wb").write(bytes(data))
    assert "checksum" in verify_manifest(path)


def test_manifest_absent_reports_missing(tmp_path):
    os.makedirs(tmp_path / "bare")
    assert verify_manifest(str(tmp_path / "bare")) == "missing"
    write_manifest(str(tmp_path / "bare"), meta={"global_step": 3})
    assert verify_manifest(str(tmp_path / "bare")) is None


def test_leftover_tmp_dir_is_skipped(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(_tree(1.0), "ck")
    # A crashed writer's uncommitted directory with a higher version.
    os.makedirs(tmp_path / "ck-7.tmp-0123abcd")
    assert ckpt._versions("ck") == [0]
    assert ckpt.exists("ck")
    _assert_w(ckpt.restore(_tree(0.0), "ck"), 1.0)
    _assert_w(ckpt.restore(_tree(0.0), "ck", allow_fallback=True), 1.0)


@pytest.mark.parametrize("with_manifest", [True, False])
def test_torn_newest_falls_back_to_previous(tmp_path, with_manifest):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(_tree(1.0), "ck")
    newest = ckpt.save(_tree(2.0), "ck")
    if not with_manifest:
        os.remove(os.path.join(newest, MANIFEST_FILENAME))
    _tear(newest)
    seen = []
    restored = ckpt.restore(_tree(0.0), "ck", allow_fallback=True,
                            on_fallback=lambda p, r: seen.append((p, r)))
    _assert_w(restored, 1.0)
    assert ckpt.last_restored_path == ckpt._path("ck", 0)
    assert len(seen) == 1 and seen[0][0] == newest
    if with_manifest:
        assert "mismatch" in seen[0][1]
    with pytest.raises(Exception):
        ckpt.restore(_tree(0.0), "ck")


def test_all_versions_torn_raises_integrity_error(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    _tear(ckpt.save(_tree(1.0), "ck"))
    with pytest.raises(CheckpointIntegrityError, match="no restorable"):
        ckpt.restore(_tree(0.0), "ck", allow_fallback=True)


def test_intact_manifest_restore_error_fails_fast(tmp_path):
    """A verified version that does not fit the template is a structure
    problem: no fallback to older weights."""
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(_tree(1.0), "ck")
    ckpt.save(_tree(2.0), "ck")
    with pytest.raises(ValueError, match="keys differ") as ei:
        ckpt.restore({"different": {"layout": np.zeros(2)}}, "ck",
                     allow_fallback=True)
    assert not isinstance(ei.value, CheckpointIntegrityError)
    wrong_shape = {**_tree(0.0), "w": np.zeros((2, 8), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(wrong_shape, "ck", allow_fallback=True)


def test_keep_k_retention(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    for v in range(5):
        ckpt.save(_tree(float(v)), "ck")
    assert len(ckpt._versions("ck")) <= 3
    assert ckpt._versions("ck")[-1] == 4
    ckpt.save(_tree(5.0), "ck")
    assert ckpt._versions("ck")[-2:] == [4, 5]
    # Retention is per slot: another slot's versions are never pruned.
    ckpt.save(_tree(9.0), "preempt")
    for v in range(4):
        ckpt.save(_tree(float(v)), "ck")
    assert ckpt._versions("preempt") == [0]


def test_keep_1_matches_legacy_behavior(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=1)
    for v in range(4):
        ckpt.save(_tree(float(v)), "ck")
    assert len(ckpt._versions("ck")) <= 2
    _assert_w(ckpt.restore(_tree(0.0), "ck"), 3.0)


def test_async_save_manifest_written_at_wait(tmp_path):
    ckpt = Checkpointer(str(tmp_path),
                        meta_fn=lambda: {"global_step": 7})
    tree = _tree(1.0)
    path = ckpt.save(tree, "ck", wait=False)
    tree["w"][:] = 5.0          # the save copied the tree before returning
    ckpt.wait_until_finished()
    assert os.path.exists(os.path.join(path, MANIFEST_FILENAME))
    assert verify_manifest(path) is None
    assert ckpt.manifest_meta("ck") == {"global_step": 7}
    _assert_w(ckpt.restore(_tree(0.0), "ck"), 1.0)


def test_names_by_recency_and_missing_slot(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(_tree(0.0), "ck")
    assert ckpt.newest_name(("ck", "preempt")) is None
    ckpt.save(_tree(1.0), "ck")
    os.utime(ckpt._path("ck", 0), (1, 1))
    ckpt.save(_tree(2.0), "preempt")
    assert ckpt.names_by_recency(("ck", "preempt")) == ["preempt", "ck"]
    assert ckpt.newest_name(("ck", "preempt", "other")) == "preempt"


def test_flat_keys_and_resume_tree():
    tree = {"params": ({"conv0": {"kernel": np.ones((2, 2))}},),
            "resume": build_resume_tree(1, 3, 3, 9,
                                        {"retries_left": 0,
                                         "lr_scale": 1.0})}
    flat = flatten_tree(tree)
    assert set(flat) >= {"params/0/conv0/kernel", "resume/loader_epoch",
                         "resume/batch_cursor"}
    back = unflatten_like(tree, flat)
    # A fully consumed epoch is the start of the next one.
    assert unpack_resume_tree(back["resume"]) == (2, 0, 9, 0, 1.0)
    with pytest.raises(ValueError, match="contains '/'"):
        flatten_tree({"a/b": np.zeros(1)})
