"""Each kernel wrapper launches on its tensors' card: the flash kernels
(``ops/flash_attention._launch``), the paged decode
(``ops/paged_attention._call``) and the fused SGD
(``ops/fused_sgd._call``) enter ``torch.cuda.device`` with the tensors'
device around the launch and pass that card's current stream, so a tensor
on cuda:1 does not run on card 0 with card 1's pointers. On the CPU the
guard, the stream and the entry point are stand-ins that record what the
launch saw."""

import contextlib
import types

import pytest
import torch

from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
from distributed_model_parallel_tpu_torch.ops import flash_attention as fa
from distributed_model_parallel_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.torch_port

CARD = torch.device("cuda", 1)


@pytest.fixture()
def guard(monkeypatch):
    """Stand-ins for ``torch.cuda.device`` (records the device and
    whether a launch ran inside it) and ``current_stream``."""
    seen = {"entered": [], "inside": False, "launches": [], "streams": []}

    @contextlib.contextmanager
    def device(dev):
        seen["entered"].append(torch.device(dev))
        seen["inside"] = True
        try:
            yield
        finally:
            seen["inside"] = False

    def current_stream(dev=None):
        seen["streams"].append(dev)
        return types.SimpleNamespace(cuda_stream=1234)

    def entry(*args):
        seen["launches"].append((seen["inside"], args[-1]))
        return 0

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    seen["entry"] = entry
    return seen


def _launch_flash(seen, monkeypatch):
    monkeypatch.setattr(fa, "_entry", lambda name: seen["entry"])
    q = types.SimpleNamespace(shape=(1, 128, 2, 64), device=CARD)
    fa._launch("flash_fwd", (1, 2, 3), q, True, None)


def _launch_paged(seen, monkeypatch):
    pa._call(seen["entry"], (1, 2, 3), CARD)


def _launch_sgd(seen, monkeypatch):
    fs._call(seen["entry"], 1, None, 2, 8, 0.1, 0.9, 1e-4, 0, CARD)


@pytest.mark.parametrize("launch", [_launch_flash, _launch_paged,
                                    _launch_sgd],
                         ids=["flash", "paged_decode", "fused_sgd"])
def test_launch_runs_under_the_tensors_device(guard, monkeypatch, launch):
    launch(guard, monkeypatch)
    assert guard["entered"] == [CARD]
    assert guard["launches"] == [(True, 1234)]
    assert guard["streams"] == [CARD]
