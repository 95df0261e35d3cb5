"""The port's health and liveness layer against the JAX package's: the
phi-accrual core (``obs/accrual.py``), the health monitor's scorecards,
evidence log, watchdog and alert rules (``obs/health.py``), the SLO engine's
windows and burn rates (``obs/slo.py``), the adaptive timeout book
(``engine/adaptive.py``), the profiler's stack folding
(``obs/profiler.py``) and the attribution report (``obs/attribution.py``).

Module against module, in this process, on private instances (a
``HealthMonitor(registry=MetricsRegistry())``, an
``SloEngine(MetricsRegistry())`` with an injected clock, fresh books and
profilers) fed the same seeded inputs, numpy-made; every readout must be
equal, phi bit for bit (tolerance: exact). ``report_from_stage_totals``
reads the checked-in ``BENCH_r19.json`` (read only).

The JAX package's phi step at zero deviation is kept by the copy and
pinned here on both packages: ``x <= 0`` gives phi 0, any ``x > 0`` at
least ``-log10(0.5)``. At ``silence == mean`` the running sums of two
histories can differ in their last bit, so the tighter history of
``tests/test_property_phi.py``'s counterexample sits just below its mean
(phi 0.0) and the wider just above (phi 0.30103).
"""

import json
import math
import threading
from pathlib import Path

import numpy as np
import pytest

import hashgraph_tpu.engine.adaptive as ref_adaptive
import hashgraph_tpu.obs as ref_obs
import hashgraph_tpu.obs.accrual as ref_accrual
import hashgraph_tpu.obs.attribution as ref_attribution
import hashgraph_tpu.obs.health as ref_health
import hashgraph_tpu.obs.profiler as ref_profiler
import hashgraph_tpu.obs.slo as ref_slo
import hashgraph_tpu_torch.engine.adaptive as adaptive
import hashgraph_tpu_torch.obs as obs
import hashgraph_tpu_torch.obs.accrual as accrual
import hashgraph_tpu_torch.obs.attribution as attribution
import hashgraph_tpu_torch.obs.health as health
import hashgraph_tpu_torch.obs.profiler as profiler
import hashgraph_tpu_torch.obs.slo as slo
from hashgraph_tpu.scope_config import ScopeConfig as RefScopeConfig
from hashgraph_tpu_torch.scope_config import ScopeConfig

REPO = Path(__file__).resolve().parent.parent
SEEDS = range(6)
BOTH = [(ref_accrual, "reference"), (accrual, "port")]


# ── Phi accrual ───────────────────────────────────────────────────────


def test_phi_from_deviation_bit_equal():
    xs = np.concatenate([
        np.linspace(-5, 60, 2001), [0.0, 1e-300, 5e-324, 7.999999, 8.0, 37.5, 1e6],
        np.random.default_rng(0).normal(0, 20, 500),
    ])
    for x in xs.tolist():
        for cap in (64.0, 8.0):
            assert accrual.phi_from_deviation(x, cap) == ref_accrual.phi_from_deviation(x, cap)


@pytest.mark.parametrize("seed", SEEDS)
def test_phi_bit_equal_on_seeded_histories(seed):
    rng = np.random.default_rng(seed)
    gaps = rng.gamma(2.0, 5.0, 200).tolist()
    probes = rng.uniform(0, 200, 50).tolist()
    kwargs = dict(window=int(rng.integers(2, 70)), min_samples=int(rng.integers(2, 12)))
    readouts = []
    for module in (ref_accrual, accrual):
        acc = module.PhiAccrual(**kwargs)
        now, out = 0.0, []
        acc.heartbeat(now)
        for k, gap in enumerate(gaps):
            now += gap if k % 7 else 0.0  # same-tick arrivals coalesce
            acc.heartbeat(now)
            out.append((acc.sample_count, acc.mean(), acc.stddev(),
                        [acc.phi(now + p) for p in probes[:5]]))
        out.append([acc.phi(now + p) for p in probes])
        acc.reset()
        out.append((acc.sample_count, acc.phi(now + 1.0)))
        readouts.append(out)
    assert readouts[0] == readouts[1]


def _fed(module, history):
    acc = module.PhiAccrual()
    now = 0.0
    acc.heartbeat(now)
    for gap in history:
        now += gap
        acc.heartbeat(now)
    return acc, now


@pytest.mark.parametrize("module", [m for m, _ in BOTH], ids=[n for _, n in BOTH])
def test_pinned_fault_phi_step_at_zero_deviation(module):
    """The JAX package's step, pinned: ``phi_from_deviation`` jumps from 0
    at ``x == 0`` to ``-log10(0.5)`` just above it, and on the
    counterexample of ``test_phi_monotone_in_spread_at_equal_mean``
    (mean 21.72376631524171, spread 0.75, n 8, silence == mean) the wider
    history reads MORE suspicious than the tighter one."""
    step = -math.log10(0.5)
    assert module.phi_from_deviation(0.0) == 0.0
    assert module.phi_from_deviation(-1e-14) == 0.0
    assert module.phi_from_deviation(1e-14) == pytest.approx(step, abs=1e-12)
    mean, spread, n = 21.72376631524171, 0.75, 8
    d = spread * mean
    tight, _ = _fed(module, [mean] * (2 * n))
    wide, now = _fed(module, [mean - d, mean + d] * n)
    assert tight.phi(now + mean) == 0.0
    assert wide.phi(now + mean) == pytest.approx(step, abs=1e-12)


# ── The health monitor ────────────────────────────────────────────────


def drive_monitor(hmod, omod, seed):
    """A seeded sequence of admissions, rejections, truncations, forks,
    equivocations and ticks into a private monitor of one package; its
    readouts afterwards."""
    rng = np.random.default_rng(seed)
    reg = omod.MetricsRegistry()
    monitor = hmod.HealthMonitor(registry=reg, max_peers=12, max_evidence=6)
    monitor.register_gauges(reg)
    peers = [bytes([k + 1]) * 20 for k in range(16)]
    now = 1_000
    for step in range(160):
        now += int(rng.integers(0, 6))
        op = int(rng.integers(0, 8))
        peer = peers[int(rng.integers(0, len(peers)))]
        if op <= 2:
            counts = {peers[int(i)]: int(rng.integers(1, 4))
                      for i in rng.integers(0, 10, int(rng.integers(1, 5)))}
            monitor.note_admitted(counts, now, timeout_hint=float(rng.integers(0, 40)))
        elif op == 3:
            monitor.note_invalid_signature(peer, now)
        elif op == 4:
            monitor.note_expired(peer, now)
        elif op == 5:
            monitor.note_truncation(peer, int(rng.integers(1, 9)), now)
        elif op == 6:
            a, b = rng.bytes(40), rng.bytes(40)
            monitor.note_fork("s", int(rng.integers(1, 4)), a, b, peer, now)
        else:
            a = rng.bytes(40)
            monitor.note_equivocation("s", int(rng.integers(1, 4)), a, rng.bytes(40), peer,
                                      now)
            monitor.note_equivocation("s", 9, a, a, peer, now)  # a duplicate pair
        if step % 9 == 0:
            monitor.tick(now)
    return {
        "snapshot": monitor.snapshot(),
        "snapshot_later": monitor.snapshot(now + 500),
        "watchdog": monitor.watchdog(now + 100),
        "convicted": monitor.convicted_peers(),
        "alerts": monitor.evaluate_alerts(now + 10),
        "cards": [monitor.scorecard(p) for p in peers],
        "counts": (monitor.peer_count(), monitor.evidence_count(), monitor.stale_count(),
                   monitor.max_phi(), monitor.phi_suspect_count()),
        "registry": reg.export_state(),
    }


@pytest.mark.parametrize("seed", SEEDS)
def test_health_monitor_equal(seed):
    ours = drive_monitor(health, obs, seed)
    theirs = drive_monitor(ref_health, ref_obs, seed)
    assert json.loads(json.dumps(ours, default=repr)) == json.loads(
        json.dumps(theirs, default=repr))
    assert ours["snapshot"]["evidence"] and ours["snapshot"]["peers"]


def test_alert_rules_and_defaults_equal():
    assert [r.name for r in health.default_rules()] == [
        r.name for r in ref_health.default_rules()]
    for hmod, omod in ((health, obs), (ref_health, ref_obs)):
        reg = omod.MetricsRegistry()
        monitor = hmod.HealthMonitor(registry=reg, rules=[])
        monitor.add_rule(hmod.AlertRule.counter_above("spikes", "x_total", 2))
        reg.counter("x_total").inc(3)
        assert [a["rule"] for a in monitor.evaluate_alerts(5)] == ["spikes"]


# ── SLO windows and burn rates ────────────────────────────────────────


def drive_slo(smod, omod, seed):
    rng = np.random.default_rng(seed)
    clock = [1000.0]
    reg = omod.MetricsRegistry()
    engine = smod.SloEngine(reg, clock=lambda: clock[0], fast_window=60.0,
                            slow_window=600.0, slice_seconds=10.0, max_scopes=6)
    out = []
    for step in range(300):
        clock[0] += float(rng.integers(0, 3000)) / 1000
        scope = f"s{int(rng.integers(0, 9))}"
        objective = 0.05 if scope in ("s0", "s1") else None
        engine.observe(scope, float(rng.lognormal(-4, 1)), objective_s=objective,
                       shard=f"shard-{step % 2}" if step % 3 == 0 else None)
        if step % 50 == 0:
            out.append(engine.state())
            out.append([engine.observed_p99(f"s{k}") for k in range(9)])
    out.append(engine.state(clock[0] + 400))
    out.append(reg.export_state())
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("seed", SEEDS)
def test_slo_engine_equal(seed):
    assert drive_slo(slo, obs, seed) == drive_slo(ref_slo, ref_obs, seed)


def test_windowed_histogram_equal():
    outs = []
    for smod, omod in ((slo, obs), (ref_slo, ref_obs)):
        rng = np.random.default_rng(3)
        wh = smod.WindowedHistogram(omod.DEFAULT_TIME_BUCKETS, 5.0, 50.0)
        now, out = 0.0, []
        for k in range(200):
            now += float(rng.integers(0, 2000)) / 1000
            wh.observe(float(rng.exponential(0.02)), now, breaching=bool(k % 5 == 0))
            if k % 20 == 0:
                out.append([wh.window_counts(20.0, now), wh.quantile(0.99, 20.0, now),
                            wh.summary(50.0, now)])
        outs.append(json.loads(json.dumps(out)))
    assert outs[0] == outs[1]


# ── Adaptive timeouts ─────────────────────────────────────────────────


@pytest.mark.parametrize("seed", SEEDS)
def test_adaptive_book_equal(seed):
    rng = np.random.default_rng(seed)
    events = [(int(rng.integers(0, 5)), int(rng.integers(0, 3)),
               float(rng.choice([0.0, rng.exponential(3.0)]))) for _ in range(200)]
    outs = []
    for amod, cfg in ((adaptive, ScopeConfig), (ref_adaptive, RefScopeConfig)):
        configs = [cfg(default_timeout=10.0, timeout_min=2.0, timeout_max=80.0),
                   cfg(default_timeout=30.0, timeout_min=30.0, timeout_max=31.0),
                   cfg(default_timeout=20.0), None,
                   cfg(default_timeout=1.0, timeout_min=4.0, timeout_max=9.0)]
        book = amod.AdaptiveTimeoutBook(backoff=1.7, decay=0.3, headroom=1.2, max_scopes=3)
        out = []
        for scope, op, latency in events:
            c = configs[scope]
            if op == 0:
                out.append(book.on_timeout(scope, c))
            elif op == 1:
                out.append(book.on_decided(scope, c, latency))
            else:
                out.append(book.current(scope, c))
        out.append(book.snapshot())
        book.reset()
        out.append(book.snapshot())
        outs.append(out)
    assert outs[0] == outs[1]


def test_adaptive_book_rejects_bad_parameters():
    for kwargs in ({"backoff": 1.0}, {"decay": 0.0}, {"decay": 1.5}, {"headroom": 0.9}):
        with pytest.raises(ValueError):
            adaptive.AdaptiveTimeoutBook(**kwargs)


# ── Profiler folding and attribution ──────────────────────────────────


def _parked_worker(ready, release):
    ready.set()
    release.wait(10)


def test_profiler_folding_equal():
    """Both packages' samplers fold the same parked thread into the same
    stack (frames are module.qualname labels), and their collapsed text
    round-trips through parse_collapsed."""
    ready, release = threading.Event(), threading.Event()
    thread = threading.Thread(target=_parked_worker, args=(ready, release),
                              name="hashgraph-bridge-conn-7", daemon=True)
    thread.start()
    ready.wait(10)
    try:
        folded = []
        for pmod, omod in ((profiler, obs), (ref_profiler, ref_obs)):
            prof = pmod.ContinuousProfiler(omod.MetricsRegistry())
            for _ in range(3):
                prof.sample_once()
            snap = prof.snapshot()
            parked = [e for e in snap["stacks"] if "_parked_worker" in ";".join(e["frames"])]
            assert parked and parked[0]["samples"] == 3
            text = prof.collapsed()
            assert pmod.parse_collapsed(text) == {
                (e["role"], tuple(e["frames"])): e["samples"] for e in snap["stacks"]}
            folded.append((parked, pmod.thread_role(thread.name)))
        assert folded[0] == folded[1]
    finally:
        release.set()
        thread.join(10)
    assert not thread.is_alive()


def test_collapsed_parse_equal_on_text():
    text = "serial-lane;a.f;b.g 4\nother;x.y 2\n\nserial-lane;a.f;b.g 1\n"
    assert profiler.parse_collapsed(text) == ref_profiler.parse_collapsed(text)
    assert profiler.profiler_enabled(True) and not profiler.profiler_enabled(False)


def test_report_from_bench_r19_stage_totals():
    body = json.loads((REPO / "BENCH_r19.json").read_text())
    block = body["detail"]["reactor_ab"]
    for arm in ("off", "on"):
        totals = block["stage_totals"][arm]
        ours = attribution.report_from_stage_totals(totals)
        assert ours == ref_attribution.report_from_stage_totals(totals)
        assert ours["stages"]["device_apply"]["share"] == pytest.approx(
            block["device_apply_share"][arm], abs=1e-3)
        assert ours["device"]["votes_per_dispatch"] == pytest.approx(
            block["votes_per_dispatch"][arm], abs=0.01)
    assert attribution.report_from_stage_totals({}) == ref_attribution.report_from_stage_totals({})


def test_attribution_report_reads_the_ports_registry():
    state = {"counters": {obs.WIRE_DEVICE_DISPATCHES_TOTAL: 4.0,
                          obs.WIRE_APPLY_ROWS_TOTAL: 64.0,
                          obs.WIRE_APPLY_SECONDS_TOTAL: 2.0},
             "histograms": {}}
    ours = attribution.attribution_report(state=state, profiler=profiler.ContinuousProfiler())
    theirs = ref_attribution.attribution_report(
        state=state, profiler=ref_profiler.ContinuousProfiler())
    assert ours == theirs and ours["device"]["votes_per_dispatch"] == 16.0
    assert "stages" in attribution.attribution_report()


# ── The batched admission that builds only surviving cards ────────────


def _monitor_state(monitor, registry):
    cards = []
    for key, card in monitor._peers.items():
        acc = card.accrual
        cards.append((
            key, card.identity, card.first_seen, card.last_seen, card.votes_admitted,
            card.invalid_signatures, card.timeout_hint, type(card.timeout_hint).__name__,
            None if acc is None else (acc.last_heartbeat, list(acc._intervals), acc._sum,
                                      acc._sumsq),
        ))
    return {
        "cards": cards,
        "heartbeats": monitor._registry.counter(health.LIVENESS_HEARTBEATS_TOTAL).value,
        "labelled": sorted(monitor._phi_labelled),
        "gauges": sorted(registry.export_state()["gauges"]) if registry is not None else None,
    }


@pytest.mark.parametrize("seed", range(6))
def test_admission_without_evicted_cards_equals_the_loop(seed):
    """``note_admitted`` past the free room (cards only for what the call
    keeps) against the plain loop, on random caps, existing peers seen at
    mixed times (some after the call's tick), new and returning
    identities, int and float timeout hints, with and without phi
    registries: equal dict order, cards with their accruals, evictions,
    heartbeats and labelled phi gauges."""
    rng = np.random.default_rng(seed)
    for trial in range(60):
        cap = int(rng.choice([1, 2, 3, 7, 8, 9, 16, 33]))
        pool = [bytes([k % 250 + 1, k // 250 + 1]) * 16 for k in range(4 * cap + 12)]
        with_gauges = bool(rng.random() < 0.5)
        pair = []
        for _ in range(2):
            registry = obs.MetricsRegistry() if with_gauges else None
            monitor = health.HealthMonitor(max_peers=cap, registry=obs.MetricsRegistry())
            if registry is not None:
                monitor.register_gauges(registry)
            pair.append((monitor, registry))
        loop_monitor = pair[1][0]
        loop_monitor._admit_evicting_locked = lambda *args: None
        skipped = 0
        for _ in range(int(rng.integers(1, 6))):
            now = int(rng.integers(0, 40))
            seen = [(pool[int(i)], int(rng.integers(0, 60)))
                    for i in rng.integers(0, len(pool), int(rng.integers(0, cap + 2)))]
            counts = {pool[int(i)]: int(rng.integers(1, 4))
                      for i in rng.integers(0, len(pool), int(rng.integers(1, 3 * cap + 6)))}
            hint = [0.0, 12, 37.5, 60.0][int(rng.integers(0, 4))]
            for monitor, _ in pair:
                for identity, tick in seen:
                    monitor.note_invalid_signature(identity, tick)
                got = monitor.note_admitted(dict(counts), now, timeout_hint=hint)
                if monitor is not loop_monitor:
                    skipped += got
            assert _monitor_state(*pair[0]) == _monitor_state(*pair[1])
            assert len(pair[0][0]._peers) <= cap
    assert skipped >= 0


def test_admission_past_the_room_skips_evicted_cards():
    """A call admitting four caps' worth of new identities keeps the last
    cap's worth, in call order, and builds no card for the rest."""
    monitor = health.HealthMonitor(max_peers=8, registry=obs.MetricsRegistry())
    ids = [bytes([k + 1]) * 32 for k in range(32)]
    skipped = monitor.note_admitted({i: 1 for i in ids}, 5)
    assert list(monitor._peers) == ids[-monitor.peer_count():]
    assert skipped == 32 - monitor.peer_count() > 0
