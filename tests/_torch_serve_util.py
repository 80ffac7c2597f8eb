"""Drivers shared by the port's serving-plane tests: one engine geometry,
one numpy weight tree, the same requests and the same open-loop clocks
through the JAX package's engine and the port's, so that their decisions
(states, shed reasons, tokens, typed records) compare one to one.

Each engine takes the virtual clock of its own package (``SimClock``),
advanced to the test's clock before every iteration, so TTFTs, queue
waits and deadlines are the same numbers in both runs."""

import os

from _torch_port_util import both_params
from distributed_model_parallel_tpu.serve import Engine as JEngine
from distributed_model_parallel_tpu.serve import ServeConfig as JServe
from distributed_model_parallel_tpu.serve import journal as jjournal
from distributed_model_parallel_tpu.serve import traffic as jtraffic
from distributed_model_parallel_tpu.utils import telemetry as jtelemetry
from distributed_model_parallel_tpu_torch.serve import Engine, ServeConfig
from distributed_model_parallel_tpu_torch.serve import journal as tjournal
from distributed_model_parallel_tpu_torch.serve import traffic as ttraffic
from distributed_model_parallel_tpu_torch.utils import telemetry as ttelemetry

# tests/test_overload.py's geometry, prompts and budgets.
GEOMETRY = dict(n_slots=2, page_size=8, n_pages=32, max_seq_len=64,
                prefill_chunk=4)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13, 14, 15, 16],
           [3, 3, 3]]
GENS = [12, 18, 7, 10]


def model():
    """(jcfg, tcfg, JAX params, port params): the JAX serving tests'
    model (vocab 64, d 32, 4 heads, 2 layers, RoPE) in f32."""
    return both_params("mha")


def engines(model, *, tmp_path=None, name="run", sim=True,
            journal_every=None, **kw):
    """``(jax_engine, port_engine)`` over ``ServeConfig(**GEOMETRY,
    **serve_kw)``. ``tmp_path`` attaches a telemetry stream to each
    (``jax-<name>.jsonl`` / ``port-<name>.jsonl``), ``journal_every``
    a write-ahead journal with that watermark interval; ``sim`` gives
    each a ``SimClock``. Keys of ``kw`` that are engine arguments
    (``replica``, ``meter``, ``step_hook``) go to both engines; the rest
    are ``ServeConfig`` fields."""
    jcfg, tcfg, jp, tp = model
    eng_kw = {k: kw.pop(k) for k in ("replica", "meter", "step_hook")
              if k in kw}
    serve_kw = {**GEOMETRY, **kw}
    out = []
    for tag, E, S, cfg, p, tel, jr, clk, extra in (
            ("jax", JEngine, JServe, jcfg, jp, jtelemetry, jjournal,
             jtraffic, {}),
            ("port", Engine, ServeConfig, tcfg, tp, ttelemetry, tjournal,
             ttraffic, {"device": "cpu"})):
        args = dict(eng_kw, **extra)
        if tmp_path is not None:
            args["telemetry"] = tel.TelemetryRun(
                os.path.join(str(tmp_path), f"{tag}-{name}.jsonl"),
                run=name, track_compiles=False,
                device={"platform": "cpu"})
        if journal_every is not None:
            args["journal"] = jr.RequestJournal(
                os.path.join(str(tmp_path), f"{tag}-{name}.journal.jsonl"),
                watermark_every=journal_every)
        if sim:
            args["clock"] = clk.SimClock()
        out.append(E(p, cfg, S(**serve_kw), **args))
    return tuple(out)


def drive(engine, clocks) -> None:
    """Run one iteration at each open-loop clock (seconds; the engine's
    SimClock is moved there first, so its own timestamps agree)."""
    for now in clocks:
        adv = getattr(engine._clock, "advance_to", None)
        if adv is not None:
            adv(now)
        engine.step_once(now, 0.0)


def run_sim(engine, dt: float = 0.01, limit: int = 5000) -> None:
    """Iterate until idle, the SimClock advancing ``dt`` an iteration."""
    for _ in range(limit):
        if engine.sched.idle():
            return
        engine.step_once(engine._clock.tick(dt), 0.0)
    raise AssertionError(f"engine not idle after {limit} iterations")


def outcomes(reqs) -> list:
    """What a test compares per request across the packages."""
    return [(r.rid, r.state.value, r.shed_reason, list(r.generated),
             r.max_new_requested, r.migrations) for r in reqs]


def typed_records(engine, kinds=("shed", "brownout"),
                  keys=("kind", "request", "reason", "state", "level",
                        "previous", "direction", "applied")) -> list:
    """The engine stream's records of ``kinds``, cut to ``keys``."""
    engine.telemetry.finish()
    return [{k: r[k] for k in keys if k in r}
            for r in ttelemetry.read_records(engine.telemetry.path)
            if r.get("kind") in kinds]


# The fleets' packages side by side: (ServeFleet, ServeConfig, traffic,
# telemetry, journal) of the JAX package and of the port.
def _fleet_modules(tag):
    if tag == "jax":
        from distributed_model_parallel_tpu.serve import ServeFleet
        return ServeFleet, JServe, jtraffic, jtelemetry, jjournal
    from distributed_model_parallel_tpu_torch.serve import ServeFleet
    return ServeFleet, ServeConfig, ttraffic, ttelemetry, tjournal


def fleet(tag, model, n=2, *, n_devices=8, tmp_path=None, name="fleet",
          journal=None, sim=True, serve_kw=None, **kw):
    """A ``ServeFleet`` of package ``tag`` (``"jax"`` or ``"port"``) with
    ``n`` replicas over ``ServeConfig(**GEOMETRY, **serve_kw)`` on a
    ``SimClock(0.02)``. The JAX fleet's pool is ``n_devices`` of
    conftest's host devices (``n_devices`` stand-ins with an ``id`` past
    8); the port's is ``n_devices`` slots on the CPU, so both ledgers
    hold the same ids. ``tmp_path`` attaches a telemetry stream
    (``<tag>-<name>.jsonl``), ``journal`` a ``RequestJournal`` at that
    path. The rest of ``kw`` goes to the constructor."""
    jcfg, tcfg, jp, tp = model
    F, S, clk, tel, jr = _fleet_modules(tag)
    if tag == "jax":
        cfg, params = jcfg, jp
        if n_devices != 8:
            from distributed_model_parallel_tpu.orchestrator.scheduler import (
                DevicePool,
            )

            kw["pool"] = DevicePool([_Dev(i) for i in range(n_devices)])
    else:
        import torch

        cfg, params = tcfg, tp
        kw["devices"] = [torch.device("cpu")] * n_devices
    if tmp_path is not None:
        kw["telemetry"] = tel.TelemetryRun(
            os.path.join(str(tmp_path), f"{tag}-{name}.jsonl"), run=name,
            track_compiles=False, device={"platform": "cpu"})
    if journal is not None:
        kw["journal"] = jr.RequestJournal(journal)
    if sim:
        kw["clock"] = clk.SimClock(0.02)
    return F(params, cfg, S(**{**GEOMETRY, **(serve_kw or {})}), n, **kw)


class _Dev:
    """A JAX pool entry for fleets wider than conftest's 8 host devices
    (the JAX fleet reads only ``.id``)."""

    def __init__(self, i):
        self.id = i


def fleet_records(fleet, kinds, drop=("ts",)) -> list:
    """The fleet stream's records of ``kinds``, less ``drop`` keys (the
    stream is finished first)."""
    fleet.telemetry.finish()
    read = (ttelemetry.read_records
            if type(fleet).__module__.startswith(
                "distributed_model_parallel_tpu_torch")
            else jtelemetry.read_records)
    return [{k: v for k, v in r.items() if k not in drop}
            for r in read(fleet.telemetry.path) if r.get("kind") in kinds]
