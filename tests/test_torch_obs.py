"""The port's metrics layer (``hashgraph_tpu_torch.obs``) against the JAX
package's: the registry, Prometheus exposition, the flight recorder,
per-proposal timelines, the HTTP sidecar and the documented family table.

Module against module, in this process, on private instances only (a fresh
``MetricsRegistry``, ``FlightRecorder`` or ``TimelineStore`` of each
package), so neither package's process-wide objects are touched, with one
exception: the port's own default registry, read for the families it
installs. The same seeded operations go to both packages' instances; their
readouts must be equal (tolerance: exact). Prometheus text of identically
fed registries must be byte-equal. The flight dumps are compared line by
line with the header's and each event's wall-clock ``ts`` and the header's
``pid`` masked. The pinned fault (the dump throttle) holds on both
packages.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import hashgraph_tpu.obs as ref_obs
import hashgraph_tpu.obs.flight as ref_flight
import hashgraph_tpu.obs.prometheus as ref_prom
import hashgraph_tpu.obs.timeline as ref_timeline
import hashgraph_tpu_torch.obs as obs
import hashgraph_tpu_torch.obs.flight as flight
import hashgraph_tpu_torch.obs.prometheus as prom
import hashgraph_tpu_torch.obs.timeline as timeline

SEEDS = range(6)


def feed_registry(module, seed):
    """A seeded mix of counters (labelled variants too), gauges (set and
    provider-backed), histograms on time and size buckets, and an info
    family, into a fresh registry of ``module``."""
    rng = np.random.default_rng(seed)
    reg = module.MetricsRegistry()
    names = [f"fam_{k}_total" for k in range(4)]
    providers = []
    for _ in range(60):
        op = int(rng.integers(0, 6))
        if op == 0:
            reg.counter(names[int(rng.integers(0, 4))]).inc(int(rng.integers(1, 50)))
        elif op == 1:
            reg.counter(f'fam_0_total{{scheme="s{int(rng.integers(0, 3))}"}}').inc()
        elif op == 2:
            reg.gauge("level").set(float(rng.integers(-5, 500)) / 4)
        elif op == 3:
            value = int(rng.integers(0, 100))
            fn = (lambda v=value: v)
            providers.append(fn)
            reg.register_gauge("provided", fn, owner=fn)
        elif op == 4:
            reg.histogram("lat_seconds").observe(float(rng.exponential(0.01)))
        else:
            reg.histogram("batch_size", module.DEFAULT_SIZE_BUCKETS).observe(
                float(rng.integers(1, 5000)))
    reg.info("build_probe").set(version="1", backend=lambda: "x")
    return reg, providers


# ── Registry ──────────────────────────────────────────────────────────


@pytest.mark.parametrize("seed", SEEDS)
def test_registry_readouts_equal(seed):
    (ref, keep_r), (port, keep_p) = (feed_registry(m, seed) for m in (ref_obs, obs))
    assert port.snapshot() == ref.snapshot()
    assert port.export_state() == ref.export_state()


def test_buckets_and_quantiles_equal():
    assert obs.DEFAULT_TIME_BUCKETS == ref_obs.DEFAULT_TIME_BUCKETS
    assert obs.DEFAULT_SIZE_BUCKETS == ref_obs.DEFAULT_SIZE_BUCKETS
    for lo, hi, f in ((1e-6, 10.0, 2.0), (1.0, 65536.0, 4.0), (0.5, 0.75, 1.1)):
        assert obs.log_buckets(lo, hi, f) == ref_obs.log_buckets(lo, hi, f)
    rng = np.random.default_rng(7)
    values = rng.lognormal(-4, 2, 500).tolist()
    hists = []
    for module in (ref_obs, obs):
        h = module.MetricsRegistry().histogram("h")
        for v in values:
            h.observe(v)
        hists.append([h.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)] + h.buckets())
    assert hists[0] == hists[1]


def test_gauge_provider_dies_with_owner():
    reg = obs.MetricsRegistry()

    class Owner:
        pass

    owner = Owner()
    reg.register_gauge("g", lambda: 5, owner=owner)
    assert reg.gauge("g").value == 5
    del owner
    assert reg.gauge("g").value == 0


# ── Prometheus ────────────────────────────────────────────────────────


@pytest.mark.parametrize("seed", SEEDS)
def test_prometheus_text_byte_equal(seed):
    (ref, keep_r), (port, keep_p) = (feed_registry(m, seed) for m in (ref_obs, obs))
    assert port.render_prometheus() == ref.render_prometheus()
    assert prom.render_state(port.export_state()) == ref_prom.render_state(ref.export_state())


def _without(text, prefixes):
    """Exposition text without the lines of the named families."""
    return "\n".join(
        line for line in text.splitlines()
        if not any(p in line for p in prefixes)
    )


def test_well_known_families_render_equal_but_build_info():
    """Both packages' eagerly installed families, fed identically, render
    the same text but for ``hashgraph_build_info`` (its labels name the
    package and framework) and the JAX package's ``hashgraph_jax_*``
    families, which the port leaves out."""
    texts = []
    for module in (ref_obs, obs):
        reg = module.MetricsRegistry()
        module._install_well_known(reg)
        reg.counter(module.VOTES_TOTAL).inc(17)
        reg.histogram(module.INGEST_BATCH_SIZE, module.DEFAULT_SIZE_BUCKETS).observe(64)
        reg.histogram(module.DECISION_LATENCY).observe(0.25)
        texts.append(reg.render_prometheus())
    ref_text, port_text = texts
    assert "hashgraph_build_info" in port_text and "hashgraph_jax_" not in port_text
    assert _without(port_text, ["hashgraph_build_info"]) == _without(
        ref_text, ["hashgraph_build_info", "hashgraph_jax_"])


def test_build_info_labels():
    reg = obs.MetricsRegistry()
    obs._install_well_known(reg)
    labels = reg.info(obs.BUILD_INFO).labels()
    assert set(labels) == {"version", "torch", "backend"}
    import hashgraph_tpu_torch

    assert labels["version"] == hashgraph_tpu_torch.__version__
    assert labels["backend"] in ("not-loaded", "uninitialized", "cuda", "cpu")


def test_exemplars_equal_but_their_timestamps():
    parsed = []
    for module, p in ((ref_obs, ref_prom), (obs, prom)):
        reg = module.MetricsRegistry()
        h = reg.histogram("lat_seconds")
        h.observe(0.003, exemplar="ab" * 16)
        h.observe(2.0, exemplar="cd" * 16)
        found = p.parse_exemplars(reg.render_prometheus())
        parsed.append({k: [{f: v for f, v in e.items() if f != "ts"} for e in es]
                       for k, es in found.items()})
    assert parsed[0] == parsed[1] and parsed[0]


def test_sanitize_and_escape_equal():
    for name in ("wal.fsync-seconds", "engine.votes_in", "9lives", "a b/c", ""):
        assert prom.sanitize(name) == ref_prom.sanitize(name)
    for value in ('a"b', "x\\y", "line\nbreak", "plain"):
        assert prom._escape_label(value) == ref_prom._escape_label(value)


# ── Documented families ───────────────────────────────────────────────


def test_documented_families_are_the_references_but_jax():
    port = obs.documented_families()
    ref = ref_obs.documented_families()
    assert set(port) == {f for f in ref if not f.startswith("hashgraph_jax_")}
    assert not any("jax" in f for f in port)


def test_documented_families_are_installed():
    state = obs.registry.export_state()
    installed = set()
    for kind in ("counters", "gauges", "histograms", "infos"):
        installed.update(name.split("{", 1)[0] for name in state[kind])
    missing = [f for f in obs.documented_families() if f not in installed]
    assert not missing, missing


def test_obs_holds_the_ports_own_objects():
    for name in ("registry", "flight_recorder", "slo_engine", "default_profiler",
                 "health_monitor", "trace_store"):
        assert getattr(obs, name) is not getattr(ref_obs, name), name
    assert not hasattr(obs, "install_jax_telemetry")


def test_obs_modules_name_no_reference_string():
    """The strings check of the isolation scan, over the obs package."""
    from pathlib import Path

    from test_torch_isolation import reference_name_strings

    root = Path(obs.__file__).parent
    for path in sorted(root.glob("*.py")) + [root.parent / "tracing.py"]:
        assert reference_name_strings(path) == [], path.name


# ── Flight recorder ───────────────────────────────────────────────────


def _masked_dump(path):
    lines = [json.loads(line) for line in open(path).read().splitlines()]
    for entry in lines:
        entry.pop("ts", None)
        entry.pop("pid", None)
    return lines


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_flight_ring_and_dump_equal(seed, tmp_path):
    rng = np.random.default_rng(seed)
    events = [(f"kind.{int(rng.integers(0, 5))}",
               {"n": int(rng.integers(0, 99)), "s": "x" * int(rng.integers(0, 4))})
              for _ in range(40)]
    dumps = []
    for name, module in (("ref", ref_flight), ("port", flight)):
        recorder = module.FlightRecorder(capacity=16, dump_dir=str(tmp_path / name))
        for kind, attrs in events:
            recorder.record(kind, **attrs)
        recorder.record("odd", thing={1, 2})  # not JSON: dumped as its repr
        assert [(k, a) for _, k, a in recorder.events()][:-1] == events[-15:]
        dumps.append(_masked_dump(recorder.dump("fault", path=str(tmp_path / f"{name}.jsonl"))))
    assert dumps[0] == dumps[1]


def test_flight_dump_never_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    recorder = flight.FlightRecorder(capacity=4, dump_dir=str(blocker / "sub"))
    recorder.record("e")
    assert recorder.dump("fault") is None


@pytest.mark.parametrize("module", [ref_flight, flight], ids=["reference", "port"])
def test_pinned_fault_first_dump_refused_on_a_young_clock(module, tmp_path, monkeypatch):
    """The JAX package's throttle fault, kept by the copy: the last-dump
    stamp starts at 0.0, so while ``time.monotonic()`` (the host's uptime)
    is under the interval the FIRST automatic dump is refused too. Pinned
    with the module's clock set to 100 s against a 3,600 s interval."""
    monkeypatch.setattr(module.time, "monotonic", lambda: 100.0)
    recorder = module.FlightRecorder(capacity=8, dump_dir=str(tmp_path),
                                     min_dump_interval=3600)
    recorder.record("e")
    assert recorder.dump("first") is None
    assert list(tmp_path.iterdir()) == []
    # An explicit path bypasses the throttle, as documented.
    assert recorder.dump("explicit", path=str(tmp_path / "x.jsonl")) is not None


@pytest.mark.parametrize("module", [ref_flight, flight], ids=["reference", "port"])
def test_throttle_after_a_dump_on_an_old_clock(module, tmp_path, monkeypatch):
    clock = iter([5_000.0, 5_000.5, 9_000.0])
    monkeypatch.setattr(module.time, "monotonic", lambda: next(clock))
    recorder = module.FlightRecorder(capacity=8, dump_dir=str(tmp_path),
                                     min_dump_interval=3600)
    recorder.record("e")
    assert recorder.dump("first") is not None
    assert recorder.dump("second") is None
    assert recorder.dump("third") is not None


# ── Timelines ─────────────────────────────────────────────────────────


def _drive_timelines(module, seed):
    """A seeded sequence of created / voted / decided / forget calls with
    injected wall clocks, into a TimelineStore over a private histogram."""
    registry_module = ref_obs if module is ref_timeline else obs
    rng = np.random.default_rng(seed)
    hist = registry_module.MetricsRegistry().histogram("decision_latency_seconds")
    sunk = []
    store = module.TimelineStore(hist, completed_capacity=8)
    store.slo_sink = lambda tl, latency: sunk.append((tl.proposal_id, latency))
    wall = 100.0
    for step in range(120):
        slot = int(rng.integers(0, 10))
        op = int(rng.integers(0, 6))
        wall += float(rng.integers(1, 1000)) / 1000
        if op == 0:
            store.created(slot, f"s{slot % 3}", 1000 + step, 1_000 + step, wall)
        elif op == 1:
            store.voted(slot, 1_000 + step, wall)
        elif op == 2:
            store.decided(slot, ("yes", "no", "failed")[int(rng.integers(0, 3))],
                          1_000 + step, wall, by_timeout=bool(rng.integers(0, 2)))
        elif op == 3:
            store.decided(slot, "yes", 1_000 + step, wall, pre_decided=True)
        elif op == 4:
            store.forget(slot)
        else:
            store.replay_mode = not store.replay_mode
    live = {slot: store.get(slot).as_dict() for slot in range(10) if store.get(slot)}
    found = {}
    for pid in range(1000, 1120):
        for scope in ("s0", "s1", "s2"):
            tl = store.find(scope, pid)
            if tl is not None:
                found[f"{scope}-{pid}"] = tl.as_dict()
    return live, found, hist.export_state(), sunk, store.live_count()


@pytest.mark.parametrize("seed", SEEDS)
def test_timeline_store_equal(seed):
    assert _drive_timelines(timeline, seed) == _drive_timelines(ref_timeline, seed)


# ── The HTTP sidecar ──────────────────────────────────────────────────


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as response:
            return response.status, response.headers["Content-Type"], response.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers["Content-Type"], err.read()


def test_sidecars_serve_the_same_bodies():
    bodies = []
    for module in (ref_obs, obs):
        reg, _ = feed_registry(module, 3)
        sidecar = module.MetricsSidecar(
            reg, health_fn=lambda: {"ok": True, "peers": 2},
            slo_fn=lambda: {"objectives": []}, profile_fn=lambda: {"samples": 0})
        host, port = sidecar.start()
        assert host == "127.0.0.1" and port > 0
        try:
            bodies.append([_get(f"http://{host}:{port}{p}")
                           for p in ("/metrics", "/healthz", "/slo", "/profile", "/nope")])
        finally:
            sidecar.stop()
    assert bodies[0] == bodies[1]
    assert bodies[1][0][0] == 200 and bodies[1][4][0] == 404
    assert bodies[1][0][1].startswith("text/plain")


def test_unhealthy_is_503():
    sidecar = obs.MetricsSidecar(obs.MetricsRegistry(), health_fn=lambda: {"ok": False})
    host, port = sidecar.start()
    try:
        assert _get(f"http://{host}:{port}/healthz")[0] == 503
    finally:
        sidecar.stop()


def test_sidecar_over_the_default_registry_parses():
    """Every documented family of the port appears in the default
    registry's scrape, and every sample line parses as ``name value``."""
    sidecar = obs.MetricsSidecar(obs.registry, health_fn=lambda: {"ok": True})
    host, port = sidecar.start()
    try:
        status, _, body = _get(f"http://{host}:{port}/metrics")
    finally:
        sidecar.stop()
    assert status == 200
    names = set()
    for line in body.decode().splitlines():
        if not line or line.startswith("#"):
            continue
        line = line.split(" # ", 1)[0]  # an OpenMetrics exemplar rides after " # "
        sample, value = line.rsplit(" ", 1)
        float(value)  # parses, inf included
        names.add(sample.split("{", 1)[0])
    base = {n[: -len(s)] if n.endswith(s) else n
            for n in names for s in ("_bucket", "_sum", "_count", "")}
    missing = [f for f in obs.documented_families() if f not in base and f not in names]
    assert not missing, missing
