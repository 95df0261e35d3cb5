"""hashgraph_tpu_torch.obs — the production observability layer.

Four pieces, layered on (not replacing) the opt-in tracer in
:mod:`hashgraph_tpu_torch.tracing`:

- :class:`MetricsRegistry` (``registry`` is the process-wide default):
  always-on counters / gauges / log-bucketed histograms cheap enough for
  per-batch hot paths;
- per-proposal lifecycle timelines (:mod:`.timeline`), recorded by
  ``TorchConsensusEngine`` and feeding the decision-latency histogram;
- exposition: Prometheus text rendering (:mod:`.prometheus`), an HTTP
  ``/metrics`` + ``/healthz`` sidecar (:mod:`.http`), and the bridge's
  ``GET_METRICS`` opcode;
- the always-on :class:`FlightRecorder` (``flight_recorder`` is the
  process-wide ring), auto-dumped as JSONL on engine faults and bridge
  dispatch exceptions;
- distributed causal tracing (:mod:`.trace`): traceparent-style
  :class:`TraceContext` carried on bridge frames and gossip bytes, the
  bounded process-wide :data:`trace_store` of context-tagged spans
  (:func:`observed_span` feeds it whenever a context is active), Chrome
  trace-event / Perfetto export, and :func:`merge_traces` stitching N
  peers' dumps into one causal timeline. Decision provenance on top:
  ``TorchConsensusEngine.explain_decision`` and the bridge ``OP_EXPLAIN``.

Every object here is the port's own: the process-wide ``registry``,
``flight_recorder``, ``slo_engine``, ``default_profiler``,
``health_monitor`` and ``trace_store`` are distinct from the JAX
package's, so a process that imports both feeds each only from its own
engines. The modules are copies of the JAX package's ``obs``, with these
divergences and no others:

- No ``install_jax_telemetry``. The JAX package's three
  ``hashgraph_jax_*`` families (live JAX buffer bytes and the persistent
  compile cache's hits and misses) have no PyTorch meaning, so they are
  neither installed nor listed in the table below.
- ``hashgraph_build_info``'s labels: ``version`` is this package's
  ``__version__``; ``torch`` (in place of ``jax``) is read from the
  installed distribution's metadata without importing it; ``backend``
  names ``cuda`` or ``cpu`` only once ``torch.cuda.is_initialized()``
  (``not-loaded`` or ``uninitialized`` before), as the JAX package names
  only an initialised backend.
- Strings that named the JAX package (the ``sys.modules`` keys of the
  package and its native runtime, in-function imports) name this one.
- :func:`hashgraph_tpu_torch.tracing.device_profile` is a
  ``torch.profiler`` capture (host and CUDA activity, exported as a
  Chrome trace, with the tracer's spans as a track of their own), not a
  ``jax.profiler`` one.
- Tracer spans start on the profiler's clock
  (:func:`hashgraph_tpu_torch.tracing.span_clock`), and
  :func:`stage_span` times the hot calls' host stages once for the tracer
  and a caller's ``stage_seconds``.

The environment variables keep their names: ``$HASHGRAPH_FLIGHT_DIR``,
``$HASHGRAPH_INCIDENT_DIR`` and ``$HASHGRAPH_TPU_PROFILE``.

Well-known families (all on the default registry):

==============================================  =========  ==================
family                                          type       source
==============================================  =========  ==================
hashgraph_decision_latency_seconds              histogram  engine (create→decide wall time)
hashgraph_ingest_batch_size                     histogram  engine (votes per ingest call)
hashgraph_verify_batch_seconds                  histogram  engine (signature batch verify)
hashgraph_chain_kernel_seconds                  histogram  engine (device chain validation)
hashgraph_device_ingest_seconds                 histogram  engine (device vote dispatch)
wal_fsync_seconds                               histogram  WAL writer (per fsync syscall)
wal_recover_seconds                             histogram  DurableEngine.recover
hashgraph_live_proposals                        gauge      engines (tracked sessions)
hashgraph_vote_table_occupancy                  gauge      engines (claimed pool slots)
hashgraph_tier_{demoted_sessions,bytes}         gauge      engines (demoted-tier population / bytes)
hashgraph_tier_{demotions,promotions,gc}_total  counter    engine tier lifecycle traffic
wal_segment_count / wal_segment_bytes           gauge      WAL writers (live log footprint)
hashgraph_chain_suffix_length                   histogram  engine (votes applied per watermark extension)
hashgraph_votes_{total,accepted_total}          counter    engine ingest paths
hashgraph_proposals_created_total               counter    engine registration
hashgraph_decisions_total                       counter    engine transitions
hashgraph_timeouts_fired_total                  counter    engine timeout paths
hashgraph_verify_cache_{hits,misses,negative_hits,evictions}_total  counter  VerifiedVoteCache (memoized admission)
hashgraph_verified_signatures_total (+ {scheme=...})  counter    engine verify prepass (cache hits excluded)
hashgraph_verify_pool_queue_depth               gauge      native verify-pool backlog (scrape-time)
hashgraph_device_verify_{batches,signatures}_total  counter  crypto_device backend (batches / sigs dispatched)
hashgraph_device_verify_fallbacks_total         counter    crypto_device backend (host blame escalations)
hashgraph_device_verify_seconds                 histogram  crypto_device backend (end-to-end batch verify)
bridge_requests_total / bridge_errors_total     counter    bridge dispatch loop
flight_dumps_total                              counter    flight recorder dump sites
wal_checkpoints_total                           counter    DurableEngine checkpoints
hashgraph_alerts_total (+ {rule=...})           counter    health alert rule rising edges
hashgraph_equivocations_total                   counter    health evidence log (double-signs)
hashgraph_fork_redeliveries_total               counter    health evidence log (watermark forks)
hashgraph_truncation_redeliveries_total         counter    health scorecards (lagging chains)
hashgraph_expired_gossip_total                  counter    health scorecards (stale redeliveries)
hashgraph_{tracked_peers,evidence_records}      gauge      default health monitor
hashgraph_stale_peers                           gauge      liveness watchdog
hashgraph_phi (+ {peer=...})                    gauge      φ-accrual suspicion, worst peer (scrape-time)
hashgraph_liveness_suspects                     gauge      peers past the phi threshold (scrape-time)
hashgraph_liveness_heartbeats_total             counter    health monitor (admission heartbeats observed)
hashgraph_liveness_suspicion_edges_total        counter    health monitor (phi rising edges)
hashgraph_sync_chunks_sent_total                counter    bridge sync source (snapshot chunks served)
hashgraph_sync_chunks_received_total            counter    CatchUpClient (snapshot chunks verified)
hashgraph_sync_tail_records_total               counter    CatchUpClient (WAL tail records applied)
hashgraph_sync_catchup_seconds                  histogram  CatchUpClient (end-to-end catch-up)
hashgraph_gossip_frames_sent_total              counter    gossip transport (multiplexed frames out)
hashgraph_gossip_frames_shed_total              counter    gossip transport (backpressure sheds)
hashgraph_gossip_frames_deferred_total          counter    gossip node (typed STATUS_RETRY_AFTER deferrals)
hashgraph_gossip_drain_pressure                 gauge      gossip send-queue saturation 0..1 (scrape-time)
hashgraph_bridge_retry_after_total              counter    bridge admission control (overload answers sent)
hashgraph_gossip_votes_coalesced_total          counter    vote coalescer (votes packed into batch frames)
hashgraph_gossip_send_queue_bytes               gauge      gossip transport send queues (scrape-time)
hashgraph_gossip_inflight_requests              gauge      gossip transport unanswered requests (scrape-time)
hashgraph_gossip_anti_entropy_rounds_total      counter    GossipNode anti-entropy rounds
hashgraph_gossip_anti_entropy_sessions_total    counter    GossipNode sessions pushed by anti-entropy
hashgraph_gossip_catchup_escalations_total      counter    GossipNode escalations to CatchUpClient
hashgraph_slo_breaches_total                    counter    SLO engine (decisions over their scope objective)
hashgraph_slo_alerts_total                      counter    SLO engine (burn-rate alert rising edges)
hashgraph_slo_alerts_firing                     gauge      SLO engine (objectives currently alerting)
hashgraph_slo_decision_p99_seconds (+ {scope=...}/{shard=...})  gauge  SLO engine (fast-window p99)
hashgraph_slo_burn_rate (+ {scope=...,window=...})  gauge   SLO engine (max fast-window burn rate)
hashgraph_slo_incidents_total                   counter    incident capture (dumps written)
hashgraph_bridge_wire_{columnar,fallback}_frames_total  counter  wire ingest (frames per decode path)
hashgraph_bridge_wire_{decode,crypto,apply}_seconds_total  counter  wire ingest (per-stage busy seconds)
hashgraph_bridge_wire_device_dispatches_total   counter    wire ingest (fused device calls issued)
hashgraph_bridge_wire_apply_rows_total          counter    wire ingest (vote rows riding dispatches)
hashgraph_bridge_shm_rings_attached_total       counter    bridge shm lane attachments
hashgraph_reactor_{windows,rows}_total          counter    apply reactor (windows flushed / rows ridden)
hashgraph_reactor_flush_{rows,bytes,deadline,now_change,forced}_total  counter  apply reactor flush reasons
hashgraph_reactor_window_occupancy              histogram  apply reactor (frames merged per window)
hashgraph_reactor_rows_per_dispatch             histogram  apply reactor (rows per fused dispatch)
hashgraph_profile_{samples,dropped}_total       counter    continuous profiler (stacks sampled / cap drops)
hashgraph_profile_overhead_seconds_total        counter    continuous profiler (self-measured sampling cost)
==============================================  =========  ==================

The table above is machine-readable: :func:`documented_families` parses it
(brace expansion, ``/`` alternatives, ``(+ ...)`` labelled-variant notes
stripped) and ``examples/metrics_smoke.py`` asserts every listed family is
eagerly installed — documentation drift from the registry is a test
failure, not a silent lie.
"""

from __future__ import annotations

import contextlib
import functools
import re
import time

from ..tracing import span_clock
from .flight import FlightRecorder, flight_recorder
from .accrual import PhiAccrual, phi_from_deviation
from .health import (
    ALERTS_TOTAL,
    EQUIVOCATIONS_TOTAL,
    EVIDENCE_RECORDS,
    EXPIRED_GOSSIP_TOTAL,
    FORK_REDELIVERIES_TOTAL,
    LIVENESS_HEARTBEATS_TOTAL,
    LIVENESS_SUSPECTS,
    LIVENESS_SUSPICION_EDGES_TOTAL,
    PHI,
    STALE_PEERS,
    TRACKED_PEERS,
    TRUNCATION_REDELIVERIES_TOTAL,
    AlertRule,
    EvidenceRecord,
    HealthMonitor,
    PeerScorecard,
)
from .http import MetricsSidecar
from .attribution import attribution_report, report_from_stage_totals
from .profiler import (
    PROFILE_DROPPED_TOTAL,
    PROFILE_OVERHEAD_SECONDS_TOTAL,
    PROFILE_SAMPLES_TOTAL,
    ContinuousProfiler,
    parse_collapsed,
    profiler_enabled,
    thread_role,
)
from .registry import (
    DEFAULT_SIZE_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    GaugeHandle,
    Histogram,
    Info,
    MetricsRegistry,
    log_buckets,
)
from .slo import (
    SLO_ALERTS_FIRING,
    SLO_ALERTS_TOTAL,
    SLO_BREACHES_TOTAL,
    SLO_BURN_RATE,
    SLO_DECISION_P99_SECONDS,
    SLO_INCIDENTS_TOTAL,
    IncidentCapture,
    SloEngine,
    WindowedHistogram,
)
from .timeline import ProposalTimeline, TimelineStore
from .trace import (
    TraceContext,
    TraceSpan,
    TraceStore,
    attach_trace,
    current_context,
    extract_trace,
    merge_traces,
    trace_store,
    use_context,
)

# ── Well-known family names ────────────────────────────────────────────

DECISION_LATENCY = "hashgraph_decision_latency_seconds"
INGEST_BATCH_SIZE = "hashgraph_ingest_batch_size"
VERIFY_BATCH_SECONDS = "hashgraph_verify_batch_seconds"
CHAIN_KERNEL_SECONDS = "hashgraph_chain_kernel_seconds"
DEVICE_INGEST_SECONDS = "hashgraph_device_ingest_seconds"
WAL_FSYNC_SECONDS = "wal_fsync_seconds"
WAL_RECOVER_SECONDS = "wal_recover_seconds"

LIVE_PROPOSALS = "hashgraph_live_proposals"
VOTE_TABLE_OCCUPANCY = "hashgraph_vote_table_occupancy"
WAL_SEGMENT_COUNT = "wal_segment_count"
WAL_SEGMENT_BYTES = "wal_segment_bytes"

# Tiered session lifecycle (engine demote/demand-page/GC): demoted-tier
# population + serialized bytes (scrape-time gauges over every live
# engine), and the demotion/promotion/GC traffic counters.
TIER_DEMOTED_SESSIONS = "hashgraph_tier_demoted_sessions"
TIER_BYTES = "hashgraph_tier_bytes"
TIER_DEMOTIONS_TOTAL = "hashgraph_tier_demotions_total"
TIER_PROMOTIONS_TOTAL = "hashgraph_tier_promotions_total"
TIER_GC_TOTAL = "hashgraph_tier_gc_total"

CHAIN_SUFFIX_LENGTH = "hashgraph_chain_suffix_length"

VOTES_TOTAL = "hashgraph_votes_total"
VOTES_ACCEPTED_TOTAL = "hashgraph_votes_accepted_total"
PROPOSALS_CREATED_TOTAL = "hashgraph_proposals_created_total"
DECISIONS_TOTAL = "hashgraph_decisions_total"
TIMEOUTS_FIRED_TOTAL = "hashgraph_timeouts_fired_total"
BRIDGE_REQUESTS_TOTAL = "bridge_requests_total"
BRIDGE_ERRORS_TOTAL = "bridge_errors_total"
FLIGHT_DUMPS_TOTAL = "flight_dumps_total"
WAL_CHECKPOINTS_TOTAL = "wal_checkpoints_total"
VERIFY_CACHE_HITS_TOTAL = "hashgraph_verify_cache_hits_total"
VERIFY_CACHE_MISSES_TOTAL = "hashgraph_verify_cache_misses_total"
VERIFY_CACHE_NEGATIVE_HITS_TOTAL = "hashgraph_verify_cache_negative_hits_total"
VERIFY_CACHE_EVICTIONS_TOTAL = "hashgraph_verify_cache_evictions_total"
# Signatures handed to a scheme's (batch) verify — cache hits excluded.
# Engines add a per-scheme labelled variant, e.g.
# hashgraph_verified_signatures_total{scheme="Ed25519ConsensusSigner"}.
VERIFIED_SIGNATURES_TOTAL = "hashgraph_verified_signatures_total"
# Native verify-pool tasks queued + running, sampled at scrape time.
VERIFY_POOL_QUEUE_DEPTH = "hashgraph_verify_pool_queue_depth"
# Device-resident Ed25519 batch verification (crypto_device.backend):
# batches/signatures dispatched to the device pipeline, host-blame
# escalations after a failed linear combination, and end-to-end batch
# wall time (decompress + SHA-512 + MSM + any blame pass).
DEVICE_VERIFY_BATCHES_TOTAL = "hashgraph_device_verify_batches_total"
DEVICE_VERIFY_SIGNATURES_TOTAL = "hashgraph_device_verify_signatures_total"
DEVICE_VERIFY_FALLBACKS_TOTAL = "hashgraph_device_verify_fallbacks_total"
DEVICE_VERIFY_SECONDS = "hashgraph_device_verify_seconds"
BUILD_INFO = "hashgraph_build_info"

# Scope-sharded fleet (parallel.fleet): shard-count gauges, the router's
# per-shard vote counter (fleets add labelled variants, e.g.
# hashgraph_fleet_routed_votes_total{shard="shard-0"}), and the
# fleet-wide sweep latency.
FLEET_SHARDS = "hashgraph_fleet_shards"
FLEET_SHARDS_RECOVERING = "hashgraph_fleet_shards_recovering"
FLEET_ROUTED_VOTES_TOTAL = "hashgraph_fleet_routed_votes_total"
FLEET_SWEEP_SECONDS = "hashgraph_fleet_sweep_seconds"

# Federated fleet (parallel.federation): live host count seen by each
# participant, votes routed to remotely-owned scopes over the gossip
# fabric, shard migrations completed, and end-to-end migration wall time
# (freeze -> snapshot+tail adopt -> placement flip -> tail replay).
FEDERATION_HOSTS = "hashgraph_federation_hosts"
FEDERATION_REMOTE_ROUTED_VOTES_TOTAL = (
    "hashgraph_federation_remote_routed_votes_total"
)
FEDERATION_MIGRATIONS_TOTAL = "hashgraph_federation_migrations_total"
FEDERATION_MIGRATION_SECONDS = "hashgraph_federation_migration_seconds"

# State sync (sync.client / bridge sync opcodes): snapshot chunks served
# by the source, chunks received + WAL tail records applied by the
# joiner, and the end-to-end catch-up wall time.
SYNC_CHUNKS_SENT_TOTAL = "hashgraph_sync_chunks_sent_total"
SYNC_CHUNKS_RECEIVED_TOTAL = "hashgraph_sync_chunks_received_total"
SYNC_TAIL_RECORDS_TOTAL = "hashgraph_sync_tail_records_total"
SYNC_CATCHUP_SECONDS = "hashgraph_sync_catchup_seconds"

# Gossip fabric (gossip.transport / gossip.node): multiplexed frames
# sent and shed (backpressure), votes packed by the coalescer, live
# send-queue bytes + in-flight requests across every transport (provider
# gauges), anti-entropy rounds/sessions pushed, and catch-up escalations
# of far-behind peers to the state-sync path.
GOSSIP_FRAMES_SENT_TOTAL = "hashgraph_gossip_frames_sent_total"
GOSSIP_FRAMES_SHED_TOTAL = "hashgraph_gossip_frames_shed_total"
GOSSIP_VOTES_COALESCED_TOTAL = "hashgraph_gossip_votes_coalesced_total"
GOSSIP_SEND_QUEUE_BYTES = "hashgraph_gossip_send_queue_bytes"
GOSSIP_INFLIGHT_REQUESTS = "hashgraph_gossip_inflight_requests"
GOSSIP_ANTI_ENTROPY_ROUNDS_TOTAL = "hashgraph_gossip_anti_entropy_rounds_total"
GOSSIP_ANTI_ENTROPY_SESSIONS_TOTAL = (
    "hashgraph_gossip_anti_entropy_sessions_total"
)
GOSSIP_CATCHUP_ESCALATIONS_TOTAL = "hashgraph_gossip_catchup_escalations_total"
# Overload admission control (ISSUE 18): frames the gossip node deferred
# after a typed STATUS_RETRY_AFTER answer (server-computed backoff hint
# from lane/queue depth), the server-side count of those answers, and a
# scrape-time 0..1 saturation gauge over every transport's send queues —
# operators see drain pressure instead of inferring it from silence.
GOSSIP_FRAMES_DEFERRED_TOTAL = "hashgraph_gossip_frames_deferred_total"
GOSSIP_DRAIN_PRESSURE = "hashgraph_gossip_drain_pressure"
BRIDGE_RETRY_AFTER_TOTAL = "hashgraph_bridge_retry_after_total"

# Zero-copy wire ingest (bridge._op_vote_batch columnar fast path):
# frames taken by each path, shm ring attachments, and per-stage wall
# seconds (wire decode / crypto / device apply) — the attribution the
# gossip bench reads back over GET_METRICS so the residual gap between
# networked and in-process throughput stays explainable per stage.
WIRE_COLUMNAR_FRAMES_TOTAL = "hashgraph_bridge_wire_columnar_frames_total"
WIRE_FALLBACK_FRAMES_TOTAL = "hashgraph_bridge_wire_fallback_frames_total"
WIRE_DECODE_SECONDS_TOTAL = "hashgraph_bridge_wire_decode_seconds_total"
WIRE_CRYPTO_SECONDS_TOTAL = "hashgraph_bridge_wire_crypto_seconds_total"
WIRE_APPLY_SECONDS_TOTAL = "hashgraph_bridge_wire_apply_seconds_total"
SHM_RINGS_ATTACHED_TOTAL = "hashgraph_bridge_shm_rings_attached_total"
# Device-dispatch amortization (ISSUE 19): how many fused
# ingest_wire_columnar dispatches the bridge layer actually issued and
# how many vote rows rode them — the bench's votes_per_dispatch line is
# apply_rows / device_dispatches, measured, not asserted. Both paths
# (reactor on AND off) increment these at the engine-call site.
WIRE_DEVICE_DISPATCHES_TOTAL = "hashgraph_bridge_wire_device_dispatches_total"
WIRE_APPLY_ROWS_TOTAL = "hashgraph_bridge_wire_apply_rows_total"

# Apply reactor (ISSUE 19): the cross-connection continuous-batching
# scheduler on the wire path. Windows = fused dispatch units flushed;
# rows = vote rows that rode a window; the flush_* family breaks the
# flush decisions down by reason (the registry's counters are
# label-free, so "flushes_by_reason" is one counter per reason).
# Occupancy (frames merged per window) and rows-per-dispatch land on
# size-bucket histograms.
REACTOR_WINDOWS_TOTAL = "hashgraph_reactor_windows_total"
REACTOR_ROWS_TOTAL = "hashgraph_reactor_rows_total"
REACTOR_FLUSH_ROWS_TOTAL = "hashgraph_reactor_flush_rows_total"
REACTOR_FLUSH_BYTES_TOTAL = "hashgraph_reactor_flush_bytes_total"
REACTOR_FLUSH_DEADLINE_TOTAL = "hashgraph_reactor_flush_deadline_total"
REACTOR_FLUSH_NOW_CHANGE_TOTAL = "hashgraph_reactor_flush_now_change_total"
REACTOR_FLUSH_FORCED_TOTAL = "hashgraph_reactor_flush_forced_total"
REACTOR_WINDOW_OCCUPANCY = "hashgraph_reactor_window_occupancy"
REACTOR_ROWS_PER_DISPATCH = "hashgraph_reactor_rows_per_dispatch"

# Process-wide default registry (mirrors tracing.tracer's role).
registry = MetricsRegistry()


def _install_well_known(reg: MetricsRegistry) -> None:
    """Create the well-known families eagerly so a scrape sees them from
    process start (a dashboard query against an idle node must not 404)."""
    for name in (
        DECISION_LATENCY,
        VERIFY_BATCH_SECONDS,
        CHAIN_KERNEL_SECONDS,
        DEVICE_INGEST_SECONDS,
        WAL_FSYNC_SECONDS,
        WAL_RECOVER_SECONDS,
        FLEET_SWEEP_SECONDS,
        FEDERATION_MIGRATION_SECONDS,
        SYNC_CATCHUP_SECONDS,
        DEVICE_VERIFY_SECONDS,
    ):
        reg.histogram(name, DEFAULT_TIME_BUCKETS)
    reg.histogram(INGEST_BATCH_SIZE, DEFAULT_SIZE_BUCKETS)
    reg.histogram(CHAIN_SUFFIX_LENGTH, DEFAULT_SIZE_BUCKETS)
    reg.histogram(REACTOR_WINDOW_OCCUPANCY, DEFAULT_SIZE_BUCKETS)
    reg.histogram(REACTOR_ROWS_PER_DISPATCH, DEFAULT_SIZE_BUCKETS)
    for name in (
        LIVE_PROPOSALS,
        VOTE_TABLE_OCCUPANCY,
        TIER_DEMOTED_SESSIONS,
        TIER_BYTES,
        WAL_SEGMENT_COUNT,
        WAL_SEGMENT_BYTES,
        VERIFY_POOL_QUEUE_DEPTH,
        FLEET_SHARDS,
        FLEET_SHARDS_RECOVERING,
        FEDERATION_HOSTS,
        TRACKED_PEERS,
        EVIDENCE_RECORDS,
        STALE_PEERS,
        PHI,
        LIVENESS_SUSPECTS,
        GOSSIP_SEND_QUEUE_BYTES,
        GOSSIP_INFLIGHT_REQUESTS,
        GOSSIP_DRAIN_PRESSURE,
    ):
        reg.gauge(name)
    for name in (
        VOTES_TOTAL,
        VOTES_ACCEPTED_TOTAL,
        PROPOSALS_CREATED_TOTAL,
        DECISIONS_TOTAL,
        TIMEOUTS_FIRED_TOTAL,
        BRIDGE_REQUESTS_TOTAL,
        BRIDGE_ERRORS_TOTAL,
        FLIGHT_DUMPS_TOTAL,
        WAL_CHECKPOINTS_TOTAL,
        VERIFY_CACHE_HITS_TOTAL,
        VERIFY_CACHE_MISSES_TOTAL,
        VERIFY_CACHE_NEGATIVE_HITS_TOTAL,
        VERIFY_CACHE_EVICTIONS_TOTAL,
        VERIFIED_SIGNATURES_TOTAL,
        TIER_DEMOTIONS_TOTAL,
        TIER_PROMOTIONS_TOTAL,
        TIER_GC_TOTAL,
        DEVICE_VERIFY_BATCHES_TOTAL,
        DEVICE_VERIFY_SIGNATURES_TOTAL,
        DEVICE_VERIFY_FALLBACKS_TOTAL,
        ALERTS_TOTAL,
        EQUIVOCATIONS_TOTAL,
        FORK_REDELIVERIES_TOTAL,
        TRUNCATION_REDELIVERIES_TOTAL,
        EXPIRED_GOSSIP_TOTAL,
        FLEET_ROUTED_VOTES_TOTAL,
        FEDERATION_REMOTE_ROUTED_VOTES_TOTAL,
        FEDERATION_MIGRATIONS_TOTAL,
        SYNC_CHUNKS_SENT_TOTAL,
        SYNC_CHUNKS_RECEIVED_TOTAL,
        SYNC_TAIL_RECORDS_TOTAL,
        GOSSIP_FRAMES_SENT_TOTAL,
        GOSSIP_FRAMES_SHED_TOTAL,
        GOSSIP_VOTES_COALESCED_TOTAL,
        GOSSIP_ANTI_ENTROPY_ROUNDS_TOTAL,
        GOSSIP_ANTI_ENTROPY_SESSIONS_TOTAL,
        GOSSIP_CATCHUP_ESCALATIONS_TOTAL,
        GOSSIP_FRAMES_DEFERRED_TOTAL,
        BRIDGE_RETRY_AFTER_TOTAL,
        LIVENESS_HEARTBEATS_TOTAL,
        LIVENESS_SUSPICION_EDGES_TOTAL,
        WIRE_COLUMNAR_FRAMES_TOTAL,
        WIRE_FALLBACK_FRAMES_TOTAL,
        WIRE_DECODE_SECONDS_TOTAL,
        WIRE_CRYPTO_SECONDS_TOTAL,
        WIRE_APPLY_SECONDS_TOTAL,
        WIRE_DEVICE_DISPATCHES_TOTAL,
        WIRE_APPLY_ROWS_TOTAL,
        REACTOR_WINDOWS_TOTAL,
        REACTOR_ROWS_TOTAL,
        REACTOR_FLUSH_ROWS_TOTAL,
        REACTOR_FLUSH_BYTES_TOTAL,
        REACTOR_FLUSH_DEADLINE_TOTAL,
        REACTOR_FLUSH_NOW_CHANGE_TOTAL,
        REACTOR_FLUSH_FORCED_TOTAL,
        SHM_RINGS_ATTACHED_TOTAL,
        SLO_BREACHES_TOTAL,
        SLO_ALERTS_TOTAL,
        SLO_INCIDENTS_TOTAL,
        PROFILE_SAMPLES_TOTAL,
        PROFILE_DROPPED_TOTAL,
        PROFILE_OVERHEAD_SECONDS_TOTAL,
    ):
        reg.counter(name)
    # SLO gauges with registered providers come from the SloEngine bound
    # to this registry (below, for the default); bare families still must
    # exist from process start so an idle scrape sees them.
    for name in (SLO_ALERTS_FIRING, SLO_DECISION_P99_SECONDS, SLO_BURN_RATE):
        reg.gauge(name)
    reg.info(BUILD_INFO).set(
        # Resolved at scrape time: the package version needs the top-level
        # package object (circular at obs import time), and naming the CUDA
        # backend must not be the thing that initializes it.
        version=_pkg_version,
        torch=lambda: _dist_version("torch"),
        backend=_torch_backend,
    )


@functools.lru_cache(maxsize=None)
def _dist_version(dist: str) -> str:
    """Installed version of ``dist`` WITHOUT importing it
    (importlib.metadata reads dist-info only). Cached: the value cannot
    change within a process, and every scrape resolves the labels —
    Prometheus polling must not pay repeated sys.path metadata walks."""
    try:
        from importlib.metadata import version

        return version(dist)
    except Exception:
        return "unknown"


def _pkg_version() -> str:
    import sys

    pkg = sys.modules.get("hashgraph_tpu_torch")
    return getattr(pkg, "__version__", "unknown") if pkg else "unknown"


def _torch_backend() -> str:
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return "not-loaded"
    # Only NAME an already-initialized backend: asking for the device
    # count first would initialize CUDA on the scrape thread (grabbing a
    # context and device memory).
    if not torch.cuda.is_initialized():
        return "uninitialized"
    return "cuda" if torch.cuda.device_count() else "cpu"


_install_well_known(registry)
flight_recorder.dump_counter = registry.counter(FLIGHT_DUMPS_TOTAL)

# Process-wide SLO engine (mirrors ``registry``'s role): engines feed it
# one observation per decision via their timeline sink; its windowed
# quantile / burn-rate / alert state backs the ``hashgraph_slo_*``
# families above and the sidecar's ``/slo`` endpoint. Incident capture is
# armed by ``$HASHGRAPH_INCIDENT_DIR`` (unset = evidence capture off).
slo_engine = SloEngine(
    registry,
    capture=IncidentCapture(counter=registry.counter(SLO_INCIDENTS_TOTAL)),
)

# Process-wide continuous profiler (mirrors ``registry``'s role): dormant
# until something starts it — ``BridgeServer.start()`` under the
# ``$HASHGRAPH_TPU_PROFILE=1`` opt-in (profiler.maybe_start_default), or
# an embedder directly. Its sample summary rides every attribution
# report (``/profile``, ``OP_PROFILE``, incident bundles).
default_profiler = ContinuousProfiler(registry)


def documented_families() -> list[str]:
    """Family names parsed from this module's docstring table — the
    contract ``examples/metrics_smoke.py`` holds the registry to, so the
    table can never silently drift from what is actually installed.
    Handles ``prefix{a,b}suffix`` brace alternatives, ``a / b`` listings,
    and strips ``(+ ...)`` labelled-variant notes."""
    table = __doc__.split("Well-known families", 1)[1]
    names: set[str] = set()
    separators = 0
    for line in table.splitlines():
        if line.startswith("====="):
            separators += 1
            if separators >= 3:
                break
            continue
        if separators != 2 or not line.strip():
            continue
        cell = re.split(r"\s{2,}", line.strip())[0]
        cell = cell.split(" (+", 1)[0].strip()
        for part in cell.split(" / "):
            part = part.strip()
            m = re.match(r"^([\w:]*)\{([\w,]+)\}([\w:]*)$", part)
            if m:
                for alt in m.group(2).split(","):
                    names.add(m.group(1) + alt + m.group(3))
            elif part:
                names.add(part)
    return sorted(names)

# Process-wide default health monitor (mirrors ``registry``'s role):
# engines not given their own share this one, so a bridge server's
# co-hosted peers accumulate one fleet view; its anomaly counters and
# point-in-time gauges land on the default registry above.
health_monitor = HealthMonitor(registry=registry)
health_monitor.register_gauges(registry)


def _verify_pool_queue_depth() -> int:
    """Native verify-pool backlog — sampled at scrape time, and ONLY
    when the runtime is already loaded: naming the gauge must never be
    the thing that compiles or dlopens the native library (same
    discipline as ``_torch_backend``)."""
    import sys

    native = sys.modules.get("hashgraph_tpu_torch.native")
    if native is None:
        return 0
    try:
        return native.pool_queue_depth_if_loaded()
    except Exception:
        return 0


registry.register_gauge(VERIFY_POOL_QUEUE_DEPTH, _verify_pool_queue_depth)

@contextlib.contextmanager
def observed_span(tracer, name: str, histogram: Histogram, **attrs):
    """Time a block into the observability layers: always observe the
    duration into ``histogram`` (registry, always on); record a tracer
    span when tracing is enabled; and when a distributed trace context is
    active (:func:`hashgraph_tpu_torch.obs.trace.use_context`), record a
    context-tagged child span into :data:`trace_store` — this is how
    engine/bridge/WAL spans join a cross-peer causal trace without any
    per-site wiring. One perf_counter pair (plus one contextvar read)
    when nothing is listening — cheap enough for per-batch sites, which
    is where this is used. The tracer span starts on the profiler's clock
    (:func:`hashgraph_tpu_torch.tracing.span_clock`)."""
    start = span_clock()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        duration = time.perf_counter() - t0
        histogram.observe(duration)
        if tracer.enabled:
            tracer.record_span(name, start, duration, attrs)
        ctx = current_context()
        if ctx is not None and trace_store.enabled:
            end = time.time()
            trace_store.record(
                name,
                ctx.child(),
                end - duration,
                duration,
                parent=ctx.span_id,
                attrs=attrs,
            )


_UNTIMED = contextlib.nullcontext()


def stage_span(tracer, name: str, seconds: "dict | None" = None, key: str = "", **attrs):
    """Time a block once, for whoever listens: a tracer span ``name``
    (started on :func:`~hashgraph_tpu_torch.tracing.span_clock`) when
    ``tracer`` is enabled, and the block's seconds added to
    ``seconds[key]`` when a dict is passed. With the tracer off and no
    dict it is one attribute check and a shared no-op context."""
    if seconds is None and not tracer.enabled:
        return _UNTIMED
    return _StageSpan(tracer, name, seconds, key, attrs)


class _StageSpan:
    __slots__ = ("tracer", "name", "seconds", "key", "attrs", "start", "t0")

    def __init__(self, tracer, name, seconds, key, attrs):
        self.tracer, self.name, self.seconds, self.key, self.attrs = (
            tracer, name, seconds, key, attrs)

    def __enter__(self):
        self.start = span_clock() if self.tracer.enabled else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        duration = time.perf_counter() - self.t0
        if self.seconds is not None:
            self.seconds[self.key] = self.seconds.get(self.key, 0.0) + duration
        if self.start is not None:
            self.tracer.record_span(self.name, self.start, duration, self.attrs)
        return False


__all__ = [
    "AlertRule",
    "ContinuousProfiler",
    "Counter",
    "EvidenceRecord",
    "FlightRecorder",
    "Gauge",
    "GaugeHandle",
    "HealthMonitor",
    "Histogram",
    "IncidentCapture",
    "Info",
    "MetricsRegistry",
    "MetricsSidecar",
    "PeerScorecard",
    "PhiAccrual",
    "ProposalTimeline",
    "SloEngine",
    "TimelineStore",
    "TraceContext",
    "TraceSpan",
    "TraceStore",
    "WindowedHistogram",
    "attach_trace",
    "attribution_report",
    "current_context",
    "default_profiler",
    "documented_families",
    "extract_trace",
    "flight_recorder",
    "health_monitor",
    "log_buckets",
    "merge_traces",
    "observed_span",
    "parse_collapsed",
    "phi_from_deviation",
    "profiler_enabled",
    "registry",
    "report_from_stage_totals",
    "slo_engine",
    "stage_span",
    "thread_role",
    "trace_store",
    "use_context",
]
