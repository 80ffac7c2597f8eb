"""The port's chaos CLI (``python -m distributed_model_parallel_tpu_torch
.train.chaos``) beside the JAX package's ``scripts/dmp_chaos.py``, both
in-process on the CPU: for the ``nan`` and ``desync`` scenarios the
summary line carries the JAX drill's keys (read from the JAX script's
source) and, for ``desync``, run beside the JAX script, the same values
where they are not paths, and the ordered ``failure``, ``recovery`` and
``consistency`` records are equal (kind, what, epoch, ``retries_left``,
``lr_scale``; the no-quorum drill's ``replicas``, ``outliers`` and
check count too). The port's desync ranks are 2 gloo processes; flags a
scenario does not read exit 2, as JAX's do."""

import json
import os

import pytest
import torch

from distributed_model_parallel_tpu_torch.train import chaos

pytestmark = [pytest.mark.torch_port, pytest.mark.chaos]
torch.set_num_threads(1)

KEYS = ("kind", "error", "action", "status", "epoch", "retries_left",
        "lr_scale", "replicas", "outliers", "check")
PATHS = ("telemetry",)


def _run(main, argv, capsys) -> dict:
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _records(path) -> list[tuple]:
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [tuple(r.get(k) for k in KEYS) for r in recs
            if r.get("kind") in ("failure", "recovery", "consistency")]


def _jax_summary_keys(scenario: str) -> list[str]:
    """The keys of the summary dict ``scripts/dmp_chaos.py``'s scenario
    function builds, in order (read from its source: no JAX run)."""
    import ast

    from scripts import dmp_chaos

    with open(dmp_chaos.__file__) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == f"scenario_{scenario}")
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "summary"):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no summary dict in scenario_{scenario}")


@pytest.mark.parametrize("scenario", ["nan", "desync"])
def test_chaos_cli_matches_jax_drill(scenario, tmp_path, capsys):
    """``nan``: the JAX script's summary keys, the values a successful
    drill gives (test_torch_recovery_drills.py holds the records against
    the JAX trainer's); ``desync``: both CLIs run, same summary values
    and records."""
    epochs = ["--epochs", "1"] if scenario == "desync" else []
    got = _run(chaos.main, ["--scenario", scenario, "--device", "cpu",
                            "--workdir", str(tmp_path / "port"), *epochs],
               capsys)
    assert list(got) == _jax_summary_keys(scenario)
    assert os.path.exists(got["telemetry"])
    if scenario == "nan":
        assert {k: got[k] for k in list(got)[:6]} == {
            "chaos": "injected-nan-recovers", "epochs_completed": 2,
            "faults_injected": ["nan_loss"], "failures_recorded": 1,
            "recoveries_recorded": 1, "retries_used": 1}
        assert got["final_lr"] == 0.05
        return
    from scripts import dmp_chaos

    want = _run(dmp_chaos.main, ["--scenario", scenario, "--workdir",
                                 str(tmp_path / "jax"), *epochs], capsys)
    assert list(got) == list(want)
    for k in want:
        if k not in PATHS:
            assert got[k] == want[k], k
    assert _records(got["telemetry"]) == _records(want["telemetry"])


def test_chaos_cli_refuses_unread_flags(capsys):
    assert chaos.main(["--scenario", "overhead", "--epochs", "1"]) == 2
    assert chaos.main(["--scenario", "bitflip",
                       "--consistency-every", "2"]) == 2
    assert chaos.main(["--scenario", "desync", "--retries", "0"]) == 2
    assert "no effect" in capsys.readouterr().err
