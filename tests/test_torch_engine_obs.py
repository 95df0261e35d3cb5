"""Observability parity: what TorchConsensusEngine(device="cpu") reports
against what the JAX package's TpuConsensusEngine reports on the same
traces.

The traces are the scenarios of other parity files, replayed at their
seeds, in two groups. Here: the five of ``test_torch_engine`` (both
seeds), a timeout-driven trace on scopes with adaptive timeouts, and a WAL
recovery under replay mode. In ``test_torch_engine_obs_paths.py``, which
runs this file's machinery: a wire-columnar trace and its
``ingest_votes`` oracle (``test_torch_wire_columnar``), delivery (cache on
and off) and mixed proposals traces (``test_torch_proposals``) and the tier's policy
scenario (``test_torch_tiering``). Both packages mint the same ids (seeded
``generate_id`` entropy and ``os.urandom``).

The JAX engine runs in a subprocess (``python tests/test_torch_engine_obs.py
--reference GROUP``), so this process never feeds the JAX package's
process-wide registry, tracer, flight recorder or SLO engine. The
subprocess compiles at XLA's backend optimization level 0, which leaves
every result the same and keeps each file within its time. Each engine gets a private
``HealthMonitor(registry=MetricsRegistry())``; the package's default
registry, tracer and flight recorder are read as changes over the trace.

Compared with exact equality, per trace: the change of every counter of
the default registry (the JAX package's ``hashgraph_jax_*`` families, which
the port does not have, left out), the change of the count and of every
bucket count of the size histograms (``hashgraph_ingest_batch_size``,
``hashgraph_chain_suffix_length``) and of the counts of the decision-latency,
device-ingest and chain-kernel histograms; the tracer's counts (span call
counts included); each engine's ``health_report`` and its monitor's counters;
``explain_decision`` and ``proposal_timeline`` of every session left;
the flight recorder's notes (kind and fields); and ``adaptive_timeout`` of
every scope with the learner's snapshot.

Left out by name: the tracer's port-only span and counter names
(``PORT_ONLY_TRACER``: the hot calls' stage spans, the device batch's
phase spans, the timeout sweep's spans, the two pid-resolution counters,
the three counters of registration's deferred slot writes, the sweep's
reached and failed counters and the wire apply's walked-row and
skipped-card counters), which the JAX engine does not record.

Masked, because they are wall times, durations or generated ids: the
timelines' ``first_vote_latency_s`` and ``decision_latency_s`` (their
presence is kept), the ``traceparent``, ``trace_id`` and ``span_id`` of an
explained session's bound trace, the tracer's ``span.*.ns`` totals, the
``seconds`` and ``directory`` fields of the ``wal.recover`` note, and
``flight_dumps_total`` (the recorder allows one fault dump a second of
wall time, so how many of a trace's faults dump depends on its speed).

Two comparisons are narrower, for a difference the port's delivery path
has by design: ``deliver_proposals`` verifies a call's extension suffixes,
and with the cache on the chains of its unknown proposals, in one batch
(one device batch a call) where the JAX engine verifies each in turn. So
the verify-batch histogram's count and the tracer's
``span.engine.verify_batch.calls`` are not compared, and on a delivery
trace with the cache on the cache's hit and negative-hit counters are held
to at least the JAX engine's (the warmed chains are looked up once more);
its misses, and the signatures verified
(``hashgraph_verified_signatures_total``), stay exact.
"""

import importlib
import json
import os
import random
import sys
import tempfile
from types import SimpleNamespace

import pytest
import test_torch_engine as TE
import test_torch_proposals as TP
import test_torch_tiering as TT
import test_torch_wal_recovery as TR
import test_torch_wire_columnar as TW

NOW = TW.NOW
IGNORED_COUNTERS = ("hashgraph_jax_", "flight_dumps_total")
WARMED_COUNTERS = (
    "hashgraph_verify_cache_hits_total",
    "hashgraph_verify_cache_negative_hits_total",
)
# The tracer names only the port records (ROADMAP queue 3, "Port-only by
# design"): the spans of the hot calls' host stages, of the device
# signature batch's phases and of the timeout sweep, the two pid-resolution
# counters, the three counters of registration's deferred slot writes and
# the sweep's reached and failed counters. Listed one by one, so every
# other tracer count is still compared.
PORT_ONLY_SPANS = (
    "engine.ingest_proposals", "engine.proposals.admit", "engine.register",
    "engine.ingest_columnar", "engine.resolve", "engine.wire_verify_begin",
    "engine.wire.crypto", "engine.wire.apply", "engine.wire.rules", "engine.wire.guard",
    "engine.wire.intern", "engine.wire.retain", "engine.wire.chain",
    "engine.wire.admit_health", "engine.apply.events",
    "verify.submit", "verify.decompress.enqueue", "verify.hash.enqueue",
    "verify.decompress.wait", "verify.hash.wait", "verify.msm.scalars",
    "verify.msm.nibbles", "verify.msm.device", "verify.fallback",
    "engine.sweep", "engine.sweep.scan", "engine.sweep.timeout", "engine.sweep.emit",
    "engine.lifecycle_sweep",
)
PORT_ONLY_TRACER = tuple(f"span.{name}.calls" for name in PORT_ONLY_SPANS) + (
    "engine.pid_lookup_rebuilds", "engine.pid_tables_rebuilt",
    "engine.register.flushes", "engine.register.flushed_slots",
    "engine.register.forced_flushes", "engine.timeouts_reached", "engine.timeouts_failed",
    "engine.wire.walked_rows", "engine.wire.admit_cards_skipped",
)
SIZE_HISTOGRAMS = ("hashgraph_ingest_batch_size", "hashgraph_chain_suffix_length")
COUNTED_HISTOGRAMS = (
    "hashgraph_decision_latency_seconds",
    "hashgraph_device_ingest_seconds",
    "hashgraph_chain_kernel_seconds",
    "wal_recover_seconds",
)


def package_api(name):
    """One package's modules and an engine factory that gives every engine
    a private health monitor and records it."""
    pkg = importlib.import_module(name)
    obs = importlib.import_module(name + ".obs")
    tracing = importlib.import_module(name + ".tracing")
    events = importlib.import_module(name + ".events")
    engines = []

    def build(signer, capacity, voter_capacity, max_sessions, cache):
        bus = events.BroadcastEventBus(max_queued_events=1_000_000)
        monitor_registry = obs.MetricsRegistry()
        monitor = obs.HealthMonitor(registry=monitor_registry)
        if name == "hashgraph_tpu_torch":
            engine = pkg.TorchConsensusEngine(
                signer, capacity, voter_capacity, event_bus=bus,
                max_sessions_per_scope=max_sessions, device="cpu",
                verify_cache=cache, health_monitor=monitor,
            )
        else:
            from hashgraph_tpu.engine import TpuConsensusEngine

            engine = TpuConsensusEngine(
                signer, event_bus=bus, capacity=capacity, voter_capacity=voter_capacity,
                max_sessions_per_scope=max_sessions, verify_cache=cache,
                health_monitor=monitor,
            )
        engines.append((engine, monitor_registry))
        return engine

    return SimpleNamespace(name=name, pkg=pkg, obs=obs, tracing=tracing, build=build,
                           engines=engines)


def scenario_api(base, make_engine):
    """``base`` (a parity file's api namespace) with ``make_engine``, which
    goes through a package's ``build`` under the signature that file
    uses."""
    return SimpleNamespace(**{**vars(base), "make_engine": make_engine})


def te_api(side):
    base = TW.port_api() if side.name == "hashgraph_tpu_torch" else TW.reference_api()
    return scenario_api(base, lambda signer, capacity, voter_capacity,
                        max_sessions=10_000: side.build(signer, capacity, voter_capacity,
                                                        max_sessions, None))


def tw_api(side):
    base = TW.port_api() if side.name == "hashgraph_tpu_torch" else TW.reference_api()
    return scenario_api(base, lambda signer, capacity, voter_capacity,
                        max_sessions=10_000, verify_cache="default": side.build(
                            signer, capacity, voter_capacity, max_sessions, verify_cache))


def tp_api(side):
    base = TP.port_api() if side.name == "hashgraph_tpu_torch" else TP.reference_api()
    return scenario_api(base, lambda signer, cache, capacity=32,
                        voter_capacity=16, max_sessions=10_000: side.build(
                            signer, capacity, voter_capacity, max_sessions, cache))


# ── Traces of this file ───────────────────────────────────────────────


def scenario_adaptive(api):
    """Scopes with adaptive timeouts (and one without), driven only by
    timeouts: fired per-session timeouts, sweeps, a timeout on a decided
    session (not a firing) and a scope's bounds clamping the backoff."""
    pkg = api.pkg
    log = []
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 16, 8)
    engine.set_scope_config("a", pkg.ScopeConfig(default_timeout=10.0, timeout_min=5.0,
                                                 timeout_max=35.0))
    engine.set_scope_config("b", pkg.ScopeConfig(default_timeout=20.0, timeout_min=20.0,
                                                 timeout_max=400.0))
    engine.set_scope_config("c", pkg.ScopeConfig(default_timeout=30.0))
    pids = {s: [p.proposal_id for p in engine.create_proposals(
        s, [TW.request(api, i, 4, expiry=20 + 10 * i) for i in range(5)], NOW)]
        for s in "abc"}
    log.append({s: engine.adaptive_timeout(s) for s in "abcd"})
    signer = pkg.StubConsensusSigner(b"\x07" * 20)
    vote = pkg.build_vote(engine.get_proposal("a", pids["a"][0]), True, signer, NOW + 1)
    log.append(engine.ingest_votes([("a", vote)], NOW + 1, pre_validated=True).tolist())
    for scope in "ab":
        log.append(TW.call(engine.handle_consensus_timeout, scope, pids[scope][0], NOW + 25))
        log.append(engine.adaptive_timeout(scope))
    log.append(TW.call(engine.handle_consensus_timeout, "a", pids["a"][0], NOW + 26))
    for t in (35, 45, 70):
        log.append(sorted([list(x) for x in engine.sweep_timeouts(NOW + t)], key=repr))
        log.append({s: engine.adaptive_timeout(s) for s in "abc"})
    log.append(engine.adaptive_timeout_snapshot())
    return log


def scenario_recovery(api, root):
    """A durable engine takes a seeded mix of mutators and closes; a fresh
    engine recovers the log under replay mode. Only the recovery is
    observed (the caller resets the window before it): the decisions and
    timeouts counters must hold still, the recovery count one."""
    pkg = api.pkg
    wal_dir = os.path.join(root, "wal")
    durable = api.wal.DurableEngine(TR._fresh_engine(api, b"recovering-node"), wal_dir,
                                    fsync_policy="off")
    ops, pids = TR._run_workload(api, durable, random.Random(7), n_ops=80)
    durable.close()
    api.mark()
    recovered = api.wal.DurableEngine(TR._fresh_engine(api, b"recovering-node"), wal_dir,
                                      fsync_policy="off")
    stats = recovered.recover()
    out = [stats.records_applied, stats.errors, len(ops),
           TR._observable(api, recovered.engine, pids)]
    out.append(TW.canon(recovered.health_report()))
    recovered.close()
    return TW.canon(out)


def _traces():
    out = {}
    for name, fn in TE.SCENARIOS.items():
        for seed in TE.SEEDS:
            out[f"engine-{name}-{seed}"] = (te_api, lambda api, fn=fn, seed=seed: fn(api, seed),
                                           seed)
    out["wire-0"] = (tw_api, lambda api: TW.scenario_wire(api, 0), 0)
    out["object-0"] = (tw_api, lambda api: TW.scenario_wire(api, 0, oracle=True), 0)
    for name, seed, cache in (("deliver", 0, "default"), ("deliver", 0, None),
                              ("mixed", 3, "default")):
        fn = TP.SCENARIOS[name][0]
        out[f"proposals-{name}-{seed}-{cache}"] = (
            tp_api, lambda api, fn=fn, seed=seed, cache=cache: fn(TP.Side(api, cache), seed),
            10_000 + seed)
    out["tiering-policy"] = (tw_api, TT.policy_scenario, 4242)
    out["adaptive"] = (tw_api, scenario_adaptive, 5)
    out["recovery"] = (tw_api, None, 11)
    return out


TRACES = _traces()
PATH_PREFIXES = ("wire-", "object-", "proposals-", "tiering-")
GROUPS = {
    "engine": [k for k in TRACES if not k.startswith(PATH_PREFIXES)],
    "paths": [k for k in TRACES if k.startswith(PATH_PREFIXES)],
}


# ── The observation ───────────────────────────────────────────────────


def _mask_timeline(tl):
    if tl is None:
        return None
    tl = dict(tl)
    for key in ("first_vote_latency_s", "decision_latency_s"):
        if key in tl:
            tl[key] = "masked"
    return tl


def _session_reads(engine):
    """explain_decision and proposal_timeline of every session, in key
    order (last: explaining pages a demoted session back in)."""
    out = []
    for scope, pid in sorted(engine.session_keys(), key=repr):
        explain = engine.explain_decision(scope, pid)
        explain["timeline"] = _mask_timeline(explain["timeline"])
        if explain["trace"] is not None:
            explain["trace"] = dict.fromkeys(explain["trace"], "masked")
        out.append([repr(scope), pid, TW.canon(explain),
                    TW.canon(_mask_timeline(engine.proposal_timeline(scope, pid)))])
    return out


def _scopes(engine):
    scopes = {scope for scope, _ in engine.session_keys()}
    scopes.update(engine._scope_configs)
    return sorted(scopes, key=repr)


def observe(side, key):
    """Run one trace on one package and read every observable."""
    make_api, fn, seed = TRACES[key]
    api = make_api(side)
    obs, tracer = side.obs, side.tracing.tracer
    side.engines.clear()
    window = {}

    def mark():
        window["registry"] = obs.registry.export_state()
        window["flight"] = f"test.mark.{key}.{random.random()}"
        obs.flight_recorder.record(window["flight"])
        tracer.reset()

    api.mark = mark
    tracer.enable()
    try:
        with TW.seeded(api, seed):
            mark()
            if fn is None:
                with tempfile.TemporaryDirectory() as root:
                    log = scenario_recovery(api, root)
            else:
                log = TW.canon(fn(api))
        after = obs.registry.export_state()
        counts = tracer.counters()
    finally:
        tracer.disable()
        tracer.reset()
    before = window["registry"]
    counters = {
        name: value - before["counters"].get(name, 0)
        for name, value in after["counters"].items()
        if not name.startswith(IGNORED_COUNTERS)
        and value != before["counters"].get(name, 0)
    }
    histograms = {}
    for name in SIZE_HISTOGRAMS + COUNTED_HISTOGRAMS:
        a, b = after["histograms"][name], before["histograms"][name]
        entry = {"count": a["count"] - b["count"]}
        if name in SIZE_HISTOGRAMS:
            entry["buckets"] = [x - y for x, y in zip(a["counts"], b["counts"])]
        histograms[name] = entry
    events = obs.flight_recorder.events()
    start = max(i for i, (_, kind, _) in enumerate(events) if kind == window["flight"])
    flight = []
    for _, kind, attrs in events[start + 1:]:
        attrs = dict(attrs or {})
        if kind == "wal.recover":
            attrs["seconds"] = attrs["directory"] = "masked"
        flight.append([kind, TW.canon(attrs)])
    engines = []
    for engine, monitor_registry in side.engines:
        engines.append({
            "health": TW.canon(engine.health_report()),
            "monitor_counters": monitor_registry.snapshot()["counters"],
            "adaptive": [[repr(s), engine.adaptive_timeout(s)] for s in _scopes(engine)],
            "adaptive_snapshot": engine.adaptive_timeout_snapshot(),
            "sessions": _session_reads(engine),
        })
    return json.loads(json.dumps({
        "log": log,
        "counters": counters,
        "histograms": histograms,
        "tracer": {k: v for k, v in counts.items()
                   if not k.endswith(".ns") and k != "span.engine.verify_batch.calls"
                   and k not in PORT_ONLY_TRACER},
        "flight": flight,
        "engines": engines,
    }, default=repr))


def run_all(name, group):
    side = package_api(name)
    return {key: observe(side, key) for key in GROUPS[group]}


def reference_group(group):
    """The JAX engine's observations of one group, made in a fresh
    interpreter."""
    return TW.reference_run(__file__, group, timeout=900)


def port_group(group):
    with TW.one_torch_thread():
        return run_all("hashgraph_tpu_torch", group)


def assert_matches(reference, port, key):
    ref, got = reference[key], port[key]
    assert got["log"] == ref["log"], "the trace itself diverged"
    if key.startswith("proposals-deliver") and key.endswith("-default") or (
        key.startswith("proposals-mixed") and key.endswith("-default")
    ):
        for name in WARMED_COUNTERS:
            assert got["counters"].pop(name, 0) >= ref["counters"].pop(name, 0), name
    for part in ("counters", "histograms", "tracer", "flight"):
        assert got[part] == ref[part], part
    assert len(got["engines"]) == len(ref["engines"])
    for i, (a, b) in enumerate(zip(got["engines"], ref["engines"])):
        for part in ("health", "monitor_counters", "adaptive", "adaptive_snapshot"):
            assert a[part] == b[part], f"engine {i} {part}"
        assert len(a["sessions"]) == len(b["sessions"])
        for x, y in zip(a["sessions"], b["sessions"]):
            assert x == y, f"engine {i} session {x[:2]}"


def exercised(port, counters, needles):
    """Every counter of ``counters`` moved somewhere in ``port``'s traces
    (the recovery's left out), and every needle appears in them."""
    total = {}
    for key, obs in port.items():
        if key != "recovery":
            for name, value in obs["counters"].items():
                total[name] = total.get(name, 0) + value
    for name in counters:
        assert total.get(name, 0) > 0, name
    flat = json.dumps(port)
    for needle in needles:
        assert needle in flat, needle


@pytest.fixture(scope="module")
def reference():
    return reference_group("engine")


@pytest.fixture(scope="module")
def port():
    return port_group("engine")


@pytest.mark.parametrize("key", GROUPS["engine"])
def test_observability_matches_reference(reference, port, key):
    assert_matches(reference, port, key)


def test_traces_exercise_the_hooks(port):
    """The traces reach what the comparison is for: decisions with
    latencies, fired timeouts, signature verification, health scorecards
    with evidence, dangling-vote rejections, fresh dispatches, adaptive
    backoff, and a recovery that counts no decision."""
    exercised(port, ("hashgraph_decisions_total", "hashgraph_timeouts_fired_total",
                     "hashgraph_proposals_created_total", "hashgraph_votes_accepted_total",
                     "hashgraph_verified_signatures_total"),
              ('["kind", "equivocation"]', "engine.sweep", "engine.dangling_votes_rejected",
               "engine.fresh_dispatches", '"pre_decided", true'))
    assert sum(o["histograms"]["hashgraph_decision_latency_seconds"]["count"]
               for o in port.values()) > 0
    assert port["adaptive"]["engines"][0]["adaptive_snapshot"]["backoffs_total"] > 0
    recovery = port["recovery"]
    assert "hashgraph_decisions_total" not in recovery["counters"]
    assert "hashgraph_timeouts_fired_total" not in recovery["counters"]
    assert recovery["counters"]["hashgraph_votes_total"] > 0
    assert recovery["histograms"]["wal_recover_seconds"]["count"] == 1
    assert recovery["histograms"]["hashgraph_decision_latency_seconds"]["count"] == 0
    health = recovery["log"][-1]
    assert all(dict(card)["grade"] == "healthy" for _, card in dict(health)["peers"])
    assert dict(health)["evidence"] == []


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_backend_optimization_level=0"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(run_all("hashgraph_tpu", sys.argv[2])))
