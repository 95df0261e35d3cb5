"""Parity: the port's ``parallel/rollup`` against the JAX package's.

- Twins of ``tests/test_profiler.py::TestFleetMerge`` (the fleet-wide
  attribution merge) and of
  ``tests/test_tiering.py::TestAccounting::test_shared_rollup_carries_tier_keys``
  (every summed occupancy key is one the port engine reports, tier
  counters included).
- Every rollup function (``aggregate_occupancy``, ``with_label``,
  ``merge_metric_states``, ``merge_slo_states``,
  ``merge_profile_states``) on seeded frames, against the JAX package's
  function on the same frames. The rollups are pure functions, so both
  run in this process.

Tolerance: exact (``pytest.approx`` only where the twin's original uses
it).
"""

import copy
import random

import pytest

from hashgraph_tpu.parallel import rollup as ref_rollup
from hashgraph_tpu_torch.obs.attribution import ATTRIBUTION_SCHEMA, STAGE_KEYS
from hashgraph_tpu_torch.parallel import rollup

NOW = 1_700_000_000
SEEDS = range(8)


# ── Twins of tests/test_profiler.py::TestFleetMerge ────────────────────


class TestFleetMerge:
    def _frame(self, host, decode, crypto, apply_s, samples):
        return {
            "host": host,
            "profile": {
                "schema": ATTRIBUTION_SCHEMA,
                "stages": {
                    "wire_decode": {"seconds": decode, "share": 0.0},
                    "crypto": {"seconds": crypto, "share": 0.0},
                    "device_apply": {"seconds": apply_s, "share": 0.0},
                    "wal_fsync": {"seconds": 0.0, "share": 0.0},
                },
                "device": {"dispatches": 4.0, "apply_rows": 64.0},
                "wal": {"fsyncs": 2},
                "samples": {
                    "total": samples,
                    "dropped": 1,
                    "overhead_seconds": 0.01,
                    "roles": {"reader": samples},
                },
            },
        }

    def test_shares_recomputed_over_fleet_denominator(self):
        merged = rollup.merge_profile_states(
            [
                self._frame("h1", 1.0, 1.0, 6.0, 10),
                self._frame("h2", 1.0, 1.0, 2.0, 30),
            ]
        )
        assert set(merged["hosts"]) == {"h1", "h2"}
        assert merged["busy_seconds"] == pytest.approx(12.0)
        # 8/12 device-apply fleet-wide — NOT the mean of per-host shares.
        assert merged["stages"]["device_apply"]["share"] == (
            pytest.approx(8.0 / 12.0, abs=1e-3)
        )
        assert merged["device"]["votes_per_dispatch"] == 16.0
        assert merged["wal"]["fsyncs"] == 4
        assert merged["samples"]["total"] == 40
        assert merged["samples"]["roles"] == {"reader": 40}

    def test_empty_and_degenerate_frames_merge_clean(self):
        merged = rollup.merge_profile_states([{"host": "h1"}, {}])
        assert merged["busy_seconds"] == 0.0
        assert all(
            s["share"] == 0.0 for s in merged["stages"].values()
        )


# ── Twin of tests/test_tiering.py::TestAccounting ──────────────────────


def test_shared_rollup_carries_tier_keys():
    from hashgraph_tpu_torch import (
        CreateProposalRequest,
        StubConsensusSigner,
        TorchConsensusEngine,
    )

    def engine():
        return TorchConsensusEngine(
            StubConsensusSigner(b"\x42" * 20), capacity=64, voter_capacity=8,
            device="cpu",
        )

    request = CreateProposalRequest(
        name="prop", payload=b"payload", proposal_owner=b"owner",
        expected_voters_count=2, expiration_timestamp=50,
        liveness_criteria_yes=True,
    )
    proposal = engine().create_proposal("author", request, NOW)
    eng = engine()
    eng.process_incoming_proposal("s", proposal.clone(), NOW)
    eng.demote_session("s", proposal.proposal_id)
    entry = eng.occupancy()
    for key in rollup.OCCUPANCY_SUM_KEYS:
        assert key in entry, f"engine occupancy missing {key}"
    total = rollup.aggregate_occupancy(
        [entry, {"recovering": True}, {"migrating": True}]
    )
    assert total["tier_sessions"] == 1
    assert total["unavailable_shards"] == 2


# ── Seeded frames through both packages' rollups ──────────────────────

FAMILIES = (
    "hashgraph_votes_total",
    'hashgraph_fleet_routed_votes_total{shard="shard-0"}',
    'hashgraph_verified_signatures_total{scheme="Stub\\"x"}',
    "hashgraph_sessions_active",
)
BOUNDS = ([0.001, 0.01, 0.1, 1.0], [0.005, 0.05, 0.5])


def occupancy_entries(rng):
    entries = []
    for _ in range(rng.randint(0, 7)):
        roll = rng.random()
        if roll < 0.15:
            entries.append({"recovering": True, "migrating": False,
                            "recovery_error": None})
        elif roll < 0.25:
            entries.append({"recovering": False, "migrating": True})
        else:
            entry = {key: rng.randint(0, 5_000) for key in rollup.OCCUPANCY_SUM_KEYS
                     if rng.random() < 0.9}
            entry["voter_capacity"] = 64
            entry["device"] = "cpu"
            entries.append(entry)
    return entries


def histogram(rng, bounds):
    counts = [rng.randint(0, 50) for _ in range(len(bounds) + 1)]
    exemplars = {
        str(i): [round(rng.random(), 6), f"{rng.getrandbits(64):016x}"]
        for i in range(len(counts)) if rng.random() < 0.4
    }
    return {"bounds": list(bounds), "counts": counts,
            "sum": round(rng.random() * 40, 6), "count": sum(counts),
            "exemplars": exemplars}


def metric_frames(rng):
    frames = []
    for h in range(rng.randint(0, 4)):
        state = {"counters": {}, "gauges": {}, "histograms": {}, "infos": {}}
        for name in FAMILIES:
            if rng.random() < 0.7:
                state["counters"][name] = rng.randint(0, 10**6)
            if rng.random() < 0.5:
                state["gauges"][name.replace("total", "now")] = rng.random() * 100
        for k in range(3):
            if rng.random() < 0.8:
                # Host 2 sometimes runs other buckets: that family's total
                # must drop out while its labelled series stay.
                bounds = BOUNDS[1] if (k == 0 and h == 2 and rng.random() < 0.5) else BOUNDS[0]
                state["histograms"][f"hashgraph_h{k}_seconds"] = histogram(rng, bounds)
        if rng.random() < 0.7:
            state["infos"]["hashgraph_build_info"] = {"version": f"0.{h}", "torch": "x"}
        frame = {"host": f"h{h}" if rng.random() < 0.9 else 'h"\n\\', "state": state}
        if rng.random() < 0.1:
            frame.pop("host")
        if rng.random() < 0.1:
            frame["state"] = None
        frames.append(frame)
    return frames


def slo_frames(rng):
    frames = []
    for h in range(rng.randint(0, 4)):
        slo = {
            "alerts_firing": [f"scope-{i}" for i in range(rng.randint(0, 3))],
            "incidents": [f"inc-{i}" for i in range(rng.randint(0, 2))],
            "global": {"count": rng.randint(0, 900), "p99": round(rng.random(), 6)},
            "scopes": {"s": {"p99": rng.random()}},
        }
        if rng.random() < 0.15:
            slo = {}
        frames.append({"host": f"h{h}", "slo": slo})
    if rng.random() < 0.2:
        frames.append({})
    return frames


def profile_frames(rng):
    frames = []
    for h in range(rng.randint(0, 4)):
        profile = {
            "schema": ATTRIBUTION_SCHEMA,
            "stages": {key: {"seconds": round(rng.random() * 10, 6), "share": 0.0}
                       for key in STAGE_KEYS if rng.random() < 0.85},
            "device": {"dispatches": float(rng.randint(0, 40)),
                       "apply_rows": float(rng.randint(0, 4_000))},
            "wal": {"fsyncs": rng.randint(0, 9)},
            "samples": {"total": rng.randint(0, 300), "dropped": rng.randint(0, 3),
                        "overhead_seconds": round(rng.random() / 10, 6),
                        "roles": {role: rng.randint(0, 90)
                                  for role in ("reader", "serial-lane", "gossip")
                                  if rng.random() < 0.6}},
        }
        if rng.random() < 0.1:
            profile["stages"]["not_a_stage"] = {"seconds": 1.0}
        if rng.random() < 0.1:
            profile = {}
        frames.append({"host": f"h{h}", "profile": profile})
    return frames


def both(fn_name, *args):
    """One rollup function of each package on deep copies of the same
    arguments: results equal, arguments left equal too."""
    port_args, ref_args = copy.deepcopy(args), copy.deepcopy(args)
    got = getattr(rollup, fn_name)(*port_args)
    want = getattr(ref_rollup, fn_name)(*ref_args)
    assert got == want
    assert port_args == ref_args
    return got


@pytest.mark.parametrize("seed", SEEDS)
def test_aggregate_occupancy_matches_reference(seed):
    rng = random.Random(seed)
    for _ in range(10):
        both("aggregate_occupancy", occupancy_entries(rng))
    assert rollup.OCCUPANCY_SUM_KEYS == ref_rollup.OCCUPANCY_SUM_KEYS


@pytest.mark.parametrize("seed", SEEDS)
def test_with_label_matches_reference(seed):
    rng = random.Random(seed)
    for _ in range(40):
        name = rng.choice(FAMILIES + ("plain", 'a{b="c",d="e"}'))
        value = rng.choice(["h0", 'q"uote', "back\\slash", "new\nline", 7])
        both("with_label", name, rng.choice(["host", "shard"]), value)


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_metric_states_matches_reference(seed):
    rng = random.Random(seed)
    for _ in range(6):
        both("merge_metric_states", metric_frames(rng))


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_slo_states_matches_reference(seed):
    rng = random.Random(seed)
    for _ in range(6):
        both("merge_slo_states", slo_frames(rng))


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_profile_states_matches_reference(seed):
    rng = random.Random(seed)
    for _ in range(6):
        both("merge_profile_states", profile_frames(rng))


def test_metric_merge_drops_totals_on_bucket_mismatch():
    """The seeded frames reach the mismatch branch: a family whose hosts
    disagree on bounds keeps its labelled series and loses its total."""
    rng = random.Random(3)
    state_a = {"histograms": {"f": histogram(rng, BOUNDS[0])}}
    state_b = {"histograms": {"f": histogram(rng, BOUNDS[1])}}
    merged = both("merge_metric_states", [{"host": "a", "state": state_a},
                                          {"host": "b", "state": state_b}])
    assert "f" not in merged["histograms"]
    assert {'f{host="a"}', 'f{host="b"}'} <= set(merged["histograms"])
