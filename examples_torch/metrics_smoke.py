"""Observability smoke check on the PyTorch port (the twin of the
``make metrics-smoke`` target).

Starts a BridgeServer (engines on ``--device``, the card by default,
raising without a GPU) with the HTTP metrics sidecar and a WAL directory,
drives one proposal to decision over the wire, then asserts:

- ``/metrics`` serves Prometheus text containing the well-known families
  (decision-latency histogram buckets, WAL fsync histogram, ingest batch
  size, bridge request counters);
- EVERY family documented in the :mod:`hashgraph_tpu_torch.obs` docstring
  table is eagerly installed — a dashboard provisioned from the docs
  must never see a hole before traffic arrives;
- ``/healthz`` reports ok with the expected peer count;
- ``/slo`` serves the machine-readable SLO state (windowed decision
  quantiles, burn-rate alert list) and the decision driven above shows
  up in its global window;
- the ``GET_METRICS`` bridge opcode returns the same families over the
  wire protocol.

It holds the port to the JAX package's smoke check but for the port's
documented divergences (the :mod:`hashgraph_tpu_torch.obs` docstring):
the three ``hashgraph_jax_*`` families are not required, nor is a live
device-buffer gauge (the port has none); the build-info labels are
``version``, ``torch`` and ``backend``; on ``--device cuda`` the backend
label must be ``cuda``, and on the CPU (where the port reports
``uninitialized``) only not ``not-loaded``.

Exit code 0 and a final ``metrics-smoke OK`` line mean the scrape path
works end to end.

Run: python examples_torch/metrics_smoke.py [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import tempfile
import urllib.request

sys.path.insert(0, ".")  # run from the repo root

from hashgraph_tpu_torch.bridge.client import BridgeClient  # noqa: E402
from hashgraph_tpu_torch.bridge.server import BridgeServer  # noqa: E402

NOW = 1_700_000_000

REQUIRED_FAMILIES = [
    "hashgraph_decision_latency_seconds_bucket",
    "hashgraph_decision_latency_seconds_count",
    "hashgraph_ingest_batch_size_bucket",
    "wal_fsync_seconds_bucket",
    "wal_segment_count",
    "hashgraph_live_proposals",
    "bridge_requests_total",
    # Labelled info gauge: who/what is serving this scrape.
    "hashgraph_build_info{",
    # Consensus-health observatory families.
    "hashgraph_alerts_total",
    "hashgraph_equivocations_total",
    "hashgraph_fork_redeliveries_total",
    "hashgraph_tracked_peers",
    "hashgraph_stale_peers",
    "hashgraph_evidence_records",
    # Verify-pool + scheme telemetry: the native pool's backlog gauge
    # (0 when the runtime is absent — the gauge must still exist), the
    # signatures-verified counter, and its per-scheme labelled variant
    # (registered at engine construction).
    "hashgraph_verify_pool_queue_depth",
    "hashgraph_verified_signatures_total",
    'hashgraph_verified_signatures_total{scheme="',
    # Device-resident batch verification (crypto_device): counters +
    # histogram exist from process start — a dashboard must see the
    # device families even on a host-verifying node (they read 0).
    "hashgraph_device_verify_batches_total",
    "hashgraph_device_verify_signatures_total",
    "hashgraph_device_verify_fallbacks_total",
    "hashgraph_device_verify_seconds_bucket",
    # State-sync families: snapshot chunks served/received, WAL tail
    # records applied, end-to-end catch-up seconds (histogram). Eagerly
    # installed so a dashboard sees them before the first catch-up; the
    # traffic itself is exercised by examples_torch/catchup_smoke.py.
    "hashgraph_sync_chunks_sent_total",
    "hashgraph_sync_chunks_received_total",
    "hashgraph_sync_tail_records_total",
    "hashgraph_sync_catchup_seconds_bucket",
    # Tiered-session-lifecycle families: demoted-tier population/bytes
    # gauges plus demotion/promotion/GC counters. Eagerly installed — an
    # untier'd node's dashboard must still see them (at 0) before any
    # scope opts into TTL policies; the traffic is exercised by
    # tests/test_torch_tiering.py.
    "hashgraph_tier_demoted_sessions",
    "hashgraph_tier_bytes",
    "hashgraph_tier_demotions_total",
    "hashgraph_tier_promotions_total",
    "hashgraph_tier_gc_total",
    # Federated fleet families: hosts gauge, votes routed to remotely
    # owned scopes over the fabric, shard migrations + their wall time.
    # Eagerly installed — a single-host node's dashboard must still see
    # them (at 0) before the operator ever federates; the traffic is
    # exercised by tests/test_torch_federation.py.
    "hashgraph_federation_hosts",
    "hashgraph_federation_remote_routed_votes_total",
    "hashgraph_federation_migrations_total",
    "hashgraph_federation_migration_seconds_bucket",
    # Liveness observatory: φ-accrual suspicion gauges (the bare family
    # reports the worst peer; the labelled per-peer variant appears as
    # peers are tracked — both voters above), suspect-count gauge, and
    # heartbeat/suspicion-edge counters.
    "hashgraph_phi",
    'hashgraph_phi{peer="',
    "hashgraph_liveness_suspects",
    "hashgraph_liveness_heartbeats_total",
    "hashgraph_liveness_suspicion_edges_total",
    # Overload admission control: typed RETRY_AFTER deferrals on both
    # fabrics plus the gossip drain-pressure gauge (0 on a healthy
    # smoke — the families must still exist).
    "hashgraph_gossip_frames_deferred_total",
    "hashgraph_gossip_drain_pressure",
    "hashgraph_bridge_retry_after_total",
    # SLO plane (hashgraph_tpu_torch.obs.slo): breach/alert counters and the
    # windowed burn-rate gauges exist from process start; the labelled
    # per-scope/per-shard variants appear once objectives are declared.
    "hashgraph_slo_breaches_total",
    "hashgraph_slo_alerts_total",
    "hashgraph_slo_alerts_firing",
    "hashgraph_slo_burn_rate",
    "hashgraph_slo_incidents_total",
    # Wire-path stage attribution: per-stage wall-seconds counters plus
    # columnar/fallback frame counts — the raw inputs the attribution
    # report fuses. Eagerly installed at server construction.
    "hashgraph_bridge_wire_columnar_frames_total",
    "hashgraph_bridge_wire_fallback_frames_total",
    "hashgraph_bridge_wire_decode_seconds_total",
    "hashgraph_bridge_wire_crypto_seconds_total",
    "hashgraph_bridge_wire_apply_seconds_total",
    "hashgraph_bridge_wire_device_dispatches_total",
    "hashgraph_bridge_wire_apply_rows_total",
    "hashgraph_bridge_shm_rings_attached_total",
    # Cross-connection apply reactor: windowing/flush counters and the
    # occupancy / rows-per-dispatch histograms exist from process start
    # even when the reactor is off (they read 0 — a dashboard must not
    # see a hole on a serial-lane node).
    "hashgraph_reactor_windows_total",
    "hashgraph_reactor_rows_total",
    "hashgraph_reactor_flush_rows_total",
    "hashgraph_reactor_flush_bytes_total",
    "hashgraph_reactor_flush_deadline_total",
    "hashgraph_reactor_flush_now_change_total",
    "hashgraph_reactor_flush_forced_total",
    "hashgraph_reactor_window_occupancy_bucket",
    "hashgraph_reactor_rows_per_dispatch_bucket",
    # Continuous profiling plane: sample/drop counters and the sampler's
    # self-measured overhead seconds — present (at 0) even when the
    # profiler is parked, so the kill switch never hides the families.
    "hashgraph_profile_samples_total",
    "hashgraph_profile_dropped_total",
    "hashgraph_profile_overhead_seconds_total",
]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = parser.parse_args().device
    with tempfile.TemporaryDirectory() as wal_dir:
        server = BridgeServer(
            capacity=16, voter_capacity=8, wal_dir=wal_dir,
            wal_fsync="always", metrics_port=0, device=device,
        )
        with server:
            host, port = server.address
            mhost, mport = server.metrics_address
            with BridgeClient(host, port) as alice, BridgeClient(host, port) as bob:
                a_peer, _ = alice.add_peer(os.urandom(32))
                b_peer, _ = bob.add_peer(os.urandom(32))
                pid, proposal = alice.create_proposal(
                    a_peer, "smoke", NOW, "p", b"payload", 2, 100
                )
                bob.process_proposal(b_peer, "smoke", proposal, NOW)
                vote_a = alice.cast_vote(a_peer, "smoke", pid, True, NOW)
                vote_b = bob.cast_vote(b_peer, "smoke", pid, True, NOW)
                alice.process_vote(a_peer, "smoke", vote_b, NOW)
                bob.process_vote(b_peer, "smoke", vote_a, NOW)
                assert alice.get_result(a_peer, "smoke", pid) is True

                # HTTP sidecar scrape.
                with urllib.request.urlopen(
                    f"http://{mhost}:{mport}/metrics", timeout=5
                ) as response:
                    text = response.read().decode("utf-8")
                missing = [f for f in REQUIRED_FAMILIES if f not in text]
                assert not missing, f"missing families in /metrics: {missing}"
                assert 'le="+Inf"' in text, "histogram missing +Inf bucket"

                # The obs/__init__ docstring table IS the contract: every
                # family it documents must be eagerly installed, so a
                # dashboard provisioned from the docs sees no holes even
                # before the matching subsystem carries traffic.
                from hashgraph_tpu_torch.obs import documented_families

                documented = documented_families()
                assert documented, "documented_families() came back empty"
                undocumented_holes = [
                    f for f in documented if f not in text
                ]
                assert not undocumented_holes, (
                    f"documented families not eagerly installed: "
                    f"{undocumented_holes}"
                )
                build_line = next(
                    l for l in text.splitlines()
                    if l.startswith("hashgraph_build_info{")
                )
                for label in ("version=", "torch=", "backend="):
                    assert label in build_line, build_line
                # The bridge server imported and ran PyTorch, so the
                # backend label must not be a placeholder; engines on the
                # card initialise CUDA, so there it names the card.
                assert 'backend="not-loaded"' not in build_line, build_line
                if device == "cuda":
                    assert 'backend="cuda"' in build_line, build_line

                with urllib.request.urlopen(
                    f"http://{mhost}:{mport}/healthz", timeout=5
                ) as response:
                    health = json.loads(response.read())
                assert health["ok"] and health["peers"] == 2, health
                # Enriched /healthz: the alerts array is always present
                # (machine-readable degradation reasons appear there and
                # in "reasons" when a critical rule fires).
                assert "alerts" in health, health

                # /slo: the machine-readable SLO plane. The decision we
                # just drove must appear in the global fast window, and
                # nothing alerts on a healthy smoke.
                with urllib.request.urlopen(
                    f"http://{mhost}:{mport}/slo", timeout=5
                ) as response:
                    slo = json.loads(response.read())
                assert slo["enabled"] is True, slo
                assert slo["global"]["count"] >= 1, slo["global"]
                assert slo["alerts_firing"] == [], slo["alerts_firing"]
                assert slo["burn_threshold"] > 0, slo

                # Consensus-health snapshot over the wire (OP_HEALTH):
                # both voters carry healthy scorecards.
                report = alice.health(a_peer, NOW + 1)
                assert report["wal"]["fsync_policy"] == "always", report["wal"]
                grades = {
                    card["grade"] for card in report["peers"].values()
                }
                assert grades == {"healthy"}, report["peers"]
                assert report["alerts"]["firing"] == [], report["alerts"]

                # Same families over the bridge wire (GET_METRICS opcode).
                wire_text = alice.get_metrics()
                missing = [f for f in REQUIRED_FAMILIES if f not in wire_text]
                assert not missing, f"missing families via GET_METRICS: {missing}"

    print("metrics-smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
