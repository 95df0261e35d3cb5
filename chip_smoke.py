#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hashgraph_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--only 1,2,6b]

Drives the port's vote and proposal paths through their public entry
points at the size of the README's single-chip engine
(``capacity=100_000``, ``voter_capacity=1024``), and fails unless every
phase holds:

1. build and device: build every CUDA kernel from ``hashgraph_tpu_torch/
   csrc`` and the native host runtime, and print the toolchain, the card
   and each kernel's registers and stack;
2. kernel against its plain version: the CUDA ingest scan against the plain
   PyTorch scan on the card, for the three packed-grid layouts with pad
   rows, pad rows deeper than the kernel's 32-vote chunk, the main path's
   shape and config 2's one-row depth-128 call — bit-exact — each timed
   alone beside its byte bound;
3. BASELINE config 3 (the main path): one scope, 10,000 proposals × 64
   voters, half gossipsub and half P2P, voted in four columnar waves of 16
   votes per proposal plus one redelivered wave;
4. BASELINE config 2: one P2P proposal × 1024 voters in 8 columnar calls of
   128 votes (decision at vote 683), in at most 7 scan calls;
5. timeouts: silent peers under both liveness settings, a vote after
   expiry, ``sweep_timeouts`` and per-session timeouts;
5b. sessions the pool cannot hold: 16 proposals of 2,000 voters (wider than
   ``voter_capacity``, served on the host) among 10,000 pooled proposals of
   64 voters, voted in the same ``ingest_columnar`` and pre-validated
   ``ingest_votes`` calls; a pool of 64 slots that overflows by 32
   sessions; ``sweep_timeouts``; spill counts from ``occupancy()``;
6. the field kernels against their plain versions: ``fe_mul`` against
   ``field._mul_plain`` bit-exact at 16,384 lanes on seeded carried inputs
   plus the boundary and carry-ripple rows, and ``fe_pow22523`` (what
   ``field.pow22523`` launches on the card) against ``field.
   _pow22523_plain`` at decompression's 8,192 lanes with the boundary rows;
   each timed alone beside its bound;
6b. the MSM kernels against their plain versions at a batch's 16,384 lanes
   of real curve points (seeded multiples of the base point, identity lanes
   and the order-4 point) and seeded nibbles (with all-0 and all-15 rows):
   ``msm_windows`` against ``msm._windows_plain`` limb for limb, accepting
   and rejecting; the root limbs and verdict of ``msm_reduce`` (the tree
   and the cofactored identity test) against ``msm._reduce_plain`` and
   ``msm._final_plain`` for an accepting and a rejecting combination and at
   the counts of ``tree_counts`` (odd folds, around the block's span, past
   span^2); each timed alone beside its bound (the tree's two launches also
   apart);
6c. the SHA-512 kernel (``csrc/sha512.cu``) against its plain version,
   ``sha512._sha512_blocks`` on the card, and against hashlib, bit for bit:
   8 lanes of the padding boundaries (1-4 blocks), 16,384 lanes of the
   signed cell's R || A || M lengths (2 blocks) and 16,384 ragged lanes of
   0-495 bytes (1-4 blocks), one launch a call; its time at the signed
   cell's batch beside its bound and the plain version's;
7. validated ingest through device verification (the main path of slices 2
   and 3): a
   GPU engine signed by an ``Ed25519DeviceConsensusSigner`` takes 256
   proposals x 16 voters (64 voter keys) as one ``ingest_votes`` call of
   4,096 Ed25519-signed votes — one device batch — then a call of 64 votes
   holding a corrupted scalar, an s >= L, an undecodable key and an R with
   its sign bit flipped, which forces the host blame pass. A CPU engine
   with the host signer (the native runtime's batch verification) takes
   the same vote bytes;
8. proposals from peers, at config 3's width (the main path of slice 6):
   senders (a CPU engine taking pre-validated votes, 64 Ed25519 keys,
   seeded ids) hold 64 proposals of 64 voters, half gossipsub and half
   P2P, whose chains grow only by the votes the sender accepts; the
   receivers take them as wire bytes. (a) One ``ingest_proposals`` call of
   the 64 proposals with 32-vote chains — two with a broken received link,
   two with a parent mismatch (one the last-occurrence shadowing case), two
   with a damaged signature (s >= L, an R that is no point) — plus two
   expired, two redelivered pids, one of 2,000 voters (served on the host)
   and one of 16 voters decided when it arrives: one device batch of
   signatures and one chain check on the card. (b) Two ``deliver_proposals``
   waves of the grown chains (watermark extensions, up to 16 votes each;
   one verify batch a wave). (c) The final chains redelivered: all
   PROPOSAL_ALREADY_EXIST with no verification launch. (d) The same traffic
   on a GPU engine with the cache off. (e) The chain check alone at (a)'s
   chains, at [1,024, 64] and at [1, 1,024], against the CPU and, chain by
   chain, the scalar oracle. Each verification
   kernel is then held against its plain version on the inputs its wrapper
   was given in (a) and (b) on both GPU engines: the field kernels at every
   shape, the MSM kernels at the fewest lanes (a cache-off run of one whole
   chain) and the most ((a)'s batch), also on a rejecting combination made
   from them. A CPU engine whose host signer verifies with the native
   runtime takes the same bytes;
9. the service layer (slice 7), BASELINE config 1 and then a node's
   session backlog. (a) The README quick-start: three peers'
   ``ConsensusService``s with Ethereum signers share one
   ``TorchBackedStorage`` on the card and one event bus. (b) 48 scopes,
   half on the Gossipsub preset and half on the P2P one, thresholds 2/3,
   0.75 and 1.0, both liveness settings; 11 proposals of 64 voters a scope
   (the 11th evicts the oldest under the default retention of 10) and 8
   proposals of 100 voters (host-only); 48 votes a proposal (70 on the wide
   ones) from 70 Ethereum keys, signed once by the native runtime on 8
   threads and delivered through ``process_incoming_vote`` in one
   seeded shuffle across scopes with 1% duplicates and 2% after their
   session's expiry, then ``handle_consensus_timeout`` on every active
   session. A service over ``TorchBackedStorage(capacity=4096,
   voter_capacity=64)`` on the card and one over
   ``InMemoryConsensusStorage`` take the same calls: every outcome, the
   events and stats per scope and every result must be equal, and every
   pooled row read back from the card must equal the row built from the
   in-memory session in a fresh CPU pool, and the native ``eth_verify``
   must accept every vote the services verified. The path launches no hand
   kernel;
10. the wire path and the write-ahead log (slice 8). (a) Config 3's shape
   over wire bytes (2,000 proposals x 64 voters, half gossipsub and half
   P2P; stub-signed votes chained per proposal, parsed by the native
   ``parse_vote_columns``), phase 3's four waves of 16 votes a proposal
   plus the redelivered wave, each one ``ingest_wire_columnar`` call. A
   child process runs them on a GPU engine under ``DurableEngine(...,
   fsync_policy="always")`` and ends with ``os._exit`` after its last
   acknowledged call; then a CPU engine, a bare GPU engine and durable GPU
   engines at ``batch`` and ``always`` take the same calls. A fresh GPU
   engine recovers the child's log: its sessions and pooled rows must
   equal the CPU engine's, but for the state of the sessions a
   MAX_ROUNDS_EXCEEDED row failed live (the log holds accepted rows only,
   as the JAX package's does: those come back active), every log must
   equal the CPU engine's byte for byte, a recovered vote re-ingested is a
   DUPLICATE_VOTE, ``checkpoint`` leaves one segment and
   ``load_from_storage`` into another fresh GPU engine gives the same
   sessions and rows. (b) 16 scopes (half on the P2P preset) x 125
   proposals x 64 voters through ``create_proposals_multi`` and four
   ``ingest_columnar_multi`` calls with ``wire_votes``, two scopes deleted
   and a sweep after the second and one checkpoint, on a durable GPU
   engine abandoned (a simulated crash) and recovered, against a CPU
   engine. (c) Phase 7's 256 proposals x 16 voters from 64 Ed25519 keys as
   one ``ingest_wire_columnar`` frame of 4,096 signed rows through device
   verification (one batch, no fallback to the host), then a frame with
   phase 7's four damaged signatures (its batch fails the MSM and the host
   blame names them), against a CPU engine on the native batch; the
   batch's kernels are held against their plain versions on the frame's
   inputs. (a) and (b) are cut in depth from config 3's 10,000 proposals
   to fit the phase's 60 s;
11. session tiering (slice 9), at config 3's width: (a) one scope of
   10,000 proposals x 64 voters, half gossipsub and half P2P, expiring at
   NOW + 300; a tenth of them retain their rows' bytes (``wire_votes``).
   Waves 1-2 on every proposal, waves 3-4 on 8,000; ``pin_scope`` must
   stop a ``lifecycle_sweep`` from demoting anything; ``sweep_timeouts`` at
   NOW + 120 demotes all 10,000 (``demote_after=60``); one
   ``ingest_columnar`` call at NOW + 130 carries wave 3 to 1,000 active
   sessions and wave 2 again to 1,000 decided ones, paging them back in
   (the retaining ones into pool slots, which the scan then serves; the
   others on the host, as in the JAX package); reads of 100 other demoted
   sessions; sweeps at NOW + 400 (the tier's expired actives are paged in
   and time out) and NOW + 1000 (``evict_decided_after=600`` collects live
   and demoted sessions). An untiered GPU twin and a tiered CPU engine take
   the same calls, and after every step the answers, events per session,
   scope stats, session keys and ``state_fingerprint`` must be equal. (b)
   The same traffic (2,000 proposals) on a tiered GPU engine under
   ``DurableEngine(fsync_policy="batch")``, abandoned after the reads and
   recovered on the card to the live fingerprint (two recovered votes
   re-ingested are DUPLICATE_VOTE); the recovered engine sweeps at NOW +
   400, runs a standalone ``lifecycle_sweep`` at NOW + 700 (KIND_LIFECYCLE
   and KIND_GC), is abandoned again and recovered from the whole log to
   the live fingerprint;
12. observability (slice 10), every figure on the port's own registry,
   read as changes over a step. (a) Config 3 (phase 3's traffic, seeded
   ids) on a GPU and a CPU engine, each with its own ``HealthMonitor(
   registry=MetricsRegistry())``: every counter's change, the size
   histograms' buckets and the count of decision latencies must be equal,
   ``hashgraph_device_ingest_seconds`` must count each call's dispatch, and
   ``explain_decision`` of 10 seeded decided proposals must be equal with
   wall times and trace ids masked. (b) The same traffic on a fresh GPU
   engine with the tracer, the trace store, an ambient trace context and
   the continuous profiler on: outcomes, events and ``state_fingerprint``
   equal to (a)'s; ``attribution_report()``; a ``MetricsSidecar``
   on 127.0.0.1:0 whose ``/metrics`` parses and holds every documented
   family, and whose ``/healthz`` answers 200. (c) Phase 7's batch and its
   damaged call on a device-signed GPU engine and a CPU engine: the verified
   signatures equal, the device-verify counters moved by one batch of
   4,096, then one batch of 64 and one host blame; the verify skill's
   equivocation recipe grades the peer ``faulty`` with one verified
   evidence record, and the two ``health_report``s are equal but for
   ``identity``. (d) ``tracing.device_profile`` (``torch.profiler``, host
   and CUDA) around config 3's second wave (the scan) and phase 7's batch:
   the Chrome trace must hold timed launches of ``ingest_scan_kernel``,
   ``fe_mul_kernel``, ``fe_pow22523_kernel``, ``msm_windows_kernel`` and
   the ``msm_reduce`` tree's two kernels; each one's device time a launch is
   printed beside its CUDA-event time. (e) Phase 10 (a)'s waves (2,000
   proposals) under ``DurableEngine`` on the card, recovered by a fresh GPU
   engine under replay mode: ``hashgraph_decisions_total`` and
   ``hashgraph_timeouts_fired_total`` hold still, ``wal_recover_seconds``
   counts one recovery and the recovered monitor is clean. Files go to a
   temporary directory, removed at the end;
13. the bridge (slice 11): port ``BridgeServer``s on the card, started
   (loopback TCP, their own threads). (a) ``native/bridge_client.c``,
   built with ``cc`` into ``hashgraph_tpu_torch/_build/``, and the port's
   ``BridgeClient`` run the README quick-start against a default server
   (Ethereum signers); ``OP_EXPLAIN``, ``OP_HEALTH``, ``GET_METRICS``,
   ``OP_STATE_FINGERPRINT`` (equal to ``sync.state_fingerprint`` of the
   peer's engine) and ``OP_FLEET_TALLY`` must answer. (b) Config 3 over a
   socket: a stub-signed key-carrying peer on a server whose engines are
   config 3's (``engine_factory``: the default engine keeps the
   reference's 10 sessions a scope; the P2P half in a second scope on
   the P2P preset, as no opcode carries a per-proposal config); 5,000
   proposals (config 3 cut in depth) as pipelined ``OP_PROCESS_PROPOSAL``
   frames, then phase 10's
   waves over them as ``OP_VOTE_BATCH`` frames of 1,024 rows from 4
   pipelined connections, each owning a quarter of the proposals. Reactor
   off, reactor on (each a fresh server) and a ``device="cpu"`` server
   cut to 2,000 proposals must give equal per-row statuses, state
   fingerprints (the CPU arm's over its 2,000 sessions) and scope stats,
   with the wire fallback, bridge error and retry-after counters
   unmoved; each arm's dispatches, rows a dispatch and scan launches are
   printed. Its frames fill a default
   reactor window each, which keeps the reactor from merging two frames
   of one connection (a merge across a refused vote changes the chain
   guard's verdict, as in the JAX package). (c) On both servers
   on the card, 2,000 ``OP_PROCESS_VOTE`` frames one at a time, each a
   first vote on a fresh proposal of 64 voters: every one answered OK.
   (d) Phase 7's traffic on a server whose peers verify on the card: one
   ``OP_PROCESS_VOTES`` frame of 4,096 votes; on a fresh peer one
   canonical ``OP_VOTE_BATCH`` frame through a pipelined connection (the
   reader thread starts the batch); the damaged 64-vote frame; on a third
   peer the 4,096 votes from four pipelined connections at once, one
   frame of 1,024 each, their four device batches overlapping. Statuses equal a CPU-engine server's
   with the host signer; each clean 4,096-vote frame is one device batch
   with no fallback, and no concurrent batch falls back. (e) A server
   with a WAL takes (b)'s cut and two waves and stops; a new server on
   the directory recovers the peer when its key is re-added (no dropped
   segment, no error, the fingerprint from before the stop); its snapshot
   over ``OP_SYNC_MANIFEST`` and ``OP_SYNC_CHUNK`` checks every chunk's
   digest and restores a fresh GPU engine to that fingerprint;
   ``OP_WAL_TAIL`` after a mid-log LSN serves exactly the later records.
   The phase fails if any frame was answered with a bridge-level error. The
   kernels are the ones earlier phases hold against their plain versions
   at these shapes;
14. gossip, catch-up and the chaos simulator (slice 12), at config 3's
   cut: 500 proposals x 64 voters, half Gossipsub, half P2P in a second
   scope, on port servers on the card (engines of 4,096 slots). (a) Four
   servers take the proposals; a ``GossipNode`` submits every session's
   64 stub-signed votes in chunks of 16. Arm 1: a driver with no engine
   fans out to all four (``bench.py::run_gossip``'s fabric; its transport
   queues the whole traffic, so nothing is shed); every fingerprint must
   equal a ``device="cpu"`` server's fed the same chunks directly. Arm 2:
   the node owns the first server's engine (applying on its own thread),
   samples 2 of the other three a session, and runs anti-entropy until a
   round repairs nothing; every server must equal the CPU server but for
   sessions failed at the P2P round cap, which a server that learnt them
   by repair holds active on the same chain (the JAX package's fault,
   ROADMAP queue 3). Frames sent, shed and deferred, rounds and scan
   launches are printed. (b) A durable server
   (``wal_fsync="batch"``) takes the proposals and three waves of chains
   of 64 Ed25519 votes from 64 keys (signed by the native runtime); a
   fresh GPU joiner with the device signer runs ``CatchUpClient.catch_up``,
   and the fourth wave reaches the source after the snapshot's chunks, so
   the tail is not empty; a second GPU joiner runs ``full_replay``, and a
   CPU joiner with the host signer runs ``catch_up``. The source's and
   both ``catch_up`` joiners' fingerprints must be equal, the replay's
   sessions the source's but for the round-cap failures the log cannot
   carry (queue 3); the snapshot must be one device batch of the retained
   signatures, with no fallback, one ``msm_windows`` and ``fe_pow22523``
   launch and ``msm_reduce``'s passes at the batch's lanes; each
   verification kernel is held against its plain version and timed on the
   batch's inputs; a snapshot with one signature byte flipped must raise
   ``SyncVerificationError``, fall back to the host blame and install
   nothing. (c) Every scenario of ``SCENARIOS`` at seed 424242 on the card and
   on the CPU: every verdict ok and the verdict JSON byte-identical; then
   ``expired-spam-burst`` and ``columnar-wire-storm`` with the device
   signer on the card, equal to the host signer on the CPU;
15. placement (slice 13) on the one card. (a) Phase 3's config 3 on an
   engine over ``ShardedPool(25_000, 1024, mesh=[cuda:0] * 4)`` (phase 3's
   capacity as four blocks): statuses, results, scope stats, events per
   session, ``global_state_counts`` and ``per_device_occupancy`` equal to
   a single-pool engine's on the card and to the same sharded pool's on
   four CPU entries, every pool array equal to the CPU blocks'; the scan
   must launch once a dispatch on every shard; the launches per shard are
   printed. (b) The engine worker of
   ``tests/test_torch_multihost.py`` at 2,000 proposals x 64 voters: two
   processes of one gloo group, each holding a ``MultiHostPool`` block on
   cuda:0, and the same worker on the CPU, both pairs at once; each
   process's observations (owned sessions, statuses, events, the
   replicated created id, stats, the checkpoint digest) must equal its CPU
   twin's, the owned sets must be disjoint and not empty, and each card
   process must launch the scan once a scan dispatch. A worker that fails
   or outlives ``MULTIHOST_TIMEOUT`` (then killed) fails the phase. One
   card checks routing, per-block kernels, summed stats and the control
   plane; placement across GPUs and NCCL stay unchecked;
16. the fleet and the federation (slice 14) on the one card. (a) Config 3
   with its proposals spread over 64 scopes through ``ConsensusFleet(
   n_shards=4, devices=[cuda:0], capacity_per_shard=25_000,
   voter_capacity=1024)`` in five ``ingest_columnar_multi`` calls:
   statuses, results, scope stats and events equal to one engine on the
   card and to the same fleet on the CPU, the scan launched on every
   shard, and ``fleet_state_counts`` reduced on the card from the four
   shards' device vectors, equal to the host mirrors. Then phase 8's
   Ed25519 chains
   through ``deliver_proposals`` on a fleet whose shards verify on the
   card, equal to a fleet of host signers on the CPU, with no device batch
   falling back to the host blame and each verification kernel held
   against its plain version on the path's inputs. (b) Cut to 2,000
   proposals x 64 voters in 16 scopes: (b1) a durable fleet of four shards
   on cuda:0 takes the waves as wire rows, one shard crashes and replays
   its log in the background while a wave goes to the other three, and
   another is rebuilt from a peer (a bridge server holding a replica of
   its log) while the next does; (b2) two ``FleetGroup``s of two shards
   over loopback TCP take three waves of object votes, half through the
   other host (the fabric), the fabric tally must agree on both hosts,
   and one ``migrate_shard`` runs under a traffic thread. Statuses,
   results, fingerprints, tallies and the migration report must equal
   the same runs on the CPU (in a child process, ``--fleet-twin``,
   beside the card's runs). (c) The federation worker of
   ``tests/test_torch_multihost.py``: two gloo processes, each a
   ``FleetGroup`` of one shard on cuda:0 with 200 proposals, where
   ``tally_path()`` must be ``"psum"`` and the all-gather's counts equal
   the fabric's, equal to the same pair on the CPU; a worker or twin that
   fails or outlives ``FED_TIMEOUT`` (then killed) fails the phase. One
   card checks the router, the per-shard kernels, the device tally, the
   fabric and live migration; shards on separate GPUs, NCCL and hosts on
   separate machines stay unchecked;
17. the example programs (slice 15): every twin under ``examples_torch/``
   as its own process from the repository root, through the runner
   (``python3 chip_smoke.py --run-example NAME ARGS...``, which runs the
   twin's ``__main__`` and then reports that process's kernel launches,
   whether it initialised CUDA and its device-verification batches and
   fallbacks on one stderr line; twins a twin spawns go through it too),
   ``EXAMPLE_WORKERS`` runs at a time. (a) ``batch_engine``,
   ``bridge_embedder``, ``catchup_smoke``, ``trace_smoke``,
   ``metrics_smoke`` and ``federation_scrape_smoke`` with ``--device
   cuda`` and with ``--device cpu``: both exit 0 with stdout equal line
   for line after ``EXAMPLE_MASKS`` (wall time, random ids and the
   listening port), the smokes on their ``... OK`` line, every process
   holding device state on the card having initialised CUDA, the CPU runs
   launching nothing; ``quickstart`` and ``gossip_simulation`` (host-only)
   exit 0 without touching CUDA. Two ``federation_host`` twins on the card
   and two on the CPU each take one decision a host from the port's
   ``FederationDriver``, move one shard h0 -> h1 over
   ``EXPORT``/``ADOPT``/``FLIP``/``RETIRE`` with equal fingerprints, take
   one more decision a host and answer ``TALLY``: tallies and sessions
   moved equal across devices. A ``gossip_peer`` twin on each device
   answers the bridge quick-start the same and exits 0 on EOF. (b) Each
   card run's launches are printed; the phase fails unless
   ``batch_engine`` launched ``ingest_scan`` at least 4 times, some
   twin serving a bridge at least once, and each card ``federation_host``
   (whose chains arrive in two halves, the second on the scan's path) at
   least once. (c) ``gossip_peer --scheme
   ed25519 --device cuda`` under ``HASHGRAPH_TPU_DEVICE_VERIFY=1`` and
   ``--device cpu`` under the host signer take the quick-start on keyed
   peers, then three outside Ed25519 votes in one frame, the last with a
   damaged scalar: statuses and results equal, and the card peer's
   process launched every verification kernel, ran every batch's MSM on
   the card and fell back to the host blame once (the damaged frame's).
   A twin that fails, falls back to the CPU or outlives
   ``EXAMPLE_TIMEOUT`` (then killed) fails the phase.

Phases 3-5b, 7 and 8 run the same traffic on a ``device="cpu"`` port engine
and require identical statuses, results, events per session and scope
stats; phases 1-7 build their engines with ``verify_cache=None``. The
script fails unless the native host runtime builds: the CPU engines and
the services verify with it, as the JAX package does. Launch counts are reset just before each phase and read just after
it; phase 7 fails unless the batch launched every verification kernel, the
MSM exactly one window launch and the tree's two, ``fe_mul`` at most
20 times and ``sha512`` once a batch, and the hash stage makes at most 4
PyTorch operator calls; phase 10 unless the waves and the replay of (a) and the calls of
(b) launched the scan and (c)'s main frame every verification kernel, the
MSM's window once; phase 11 unless its late call and (b)'s first replay
launched the scan; phase 12 unless (a)'s GPU run and (e)'s replay launched
the scan, (c)'s batches every verification kernel and (d)'s profiled calls
every hand kernel; phase 13 unless (b)'s GPU arms launched the scan and
(d)'s clean frames every verification kernel, one MSM window launch
each; phase 14 unless both arms of (a), the catch-up and the full replay
of (b) and the corpus of (c) launched the scan, and (b)'s snapshot batch
and (c)'s device-signer scenarios every verification kernel; phase 15
unless (a)'s sharded run launched the scan on every shard and each card
process of (b) launched it; phase 16 unless (a)'s fleet launched the scan
on every shard, its signed deliveries every verification kernel, and (b)'s
card runs and each card process of (c) the scan; phase 8
fails unless (a) launched every verification kernel in one batch, every batch of (a) and (b) ran its MSM without falling back to
the host blame, (c) launched none, and the cache-on engine verified each
unique vote once. The plain versions
that the kernels are held against run with ``field.mul`` routed to
``field._mul_plain``, so they touch no kernel. A kernel's bound is the
larger of its bytes over the memory rate and its integer instructions over
the issue rate, both rates from ``portbench/counts/peaks.py``;
``msm_windows``' instructions and ``ingest_scan``'s bytes are the
benchmark's own counts (``portbench/counts/``), so this table and the
benchmark's roofline metrics divide by the same work. The last lines are
the kernel table as JSON, the card's name and power limit, and ``{"ok":
true, "device": {...}}``. ``--only`` runs phase 1 and the named phases and
prints no result lines. Without a GPU, or without the package beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import random
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from portbench.counts import ingest_scan as ingest_scan_counts
from portbench.counts import msm_windows as msm_windows_counts
from portbench.counts import peaks

NOW = 1_700_000_000
CAPACITY = 100_000
VOTER_CAPACITY = 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ── Phase 2: the kernel against its plain version ──────────────────────

POOL_DTYPES = (torch.int32, torch.int32, torch.int32, torch.bool, torch.bool,
               torch.int32, torch.int32, torch.int32, torch.bool, torch.bool)


def random_rows(seed, p, v, s, depth, grid_np_dtype, pad_share=0.02):
    """Pool arrays (numpy) and one packed batch drawn from a seeded
    ``torch.Generator``: random prior votes, decided/failed rows, rows at
    their round cap, expired rows, duplicate voters, partly empty rows and,
    with ``pad_share`` > 0, pad rows (id == P)."""
    from hashgraph_tpu_torch.ops.decide import required_votes_np
    from hashgraph_tpu_torch.ops.ingest import grid_layout, pack_slots

    gen = torch.Generator().manual_seed(seed)

    def uniform(*shape):
        return torch.rand(shape, generator=gen).numpy()

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen).numpy()

    n = ints(1, v + 1, p).astype(np.int32)
    gossip = uniform(p) < 0.5
    thresholds = np.array([2 / 3, 0.9, 1.0])[ints(0, 3, p)]
    req = required_votes_np(n, thresholds).astype(np.int32)
    cap = np.where(gossip, 2, req).astype(np.int32)
    prior = np.minimum(ints(0, 4, p), n)  # prior votes in lanes 0..k-1
    mask = np.arange(v)[None, :] < prior[:, None]
    vals = np.zeros((p, v), bool)
    vals[:, :4] = mask[:, :4] & (uniform(p, 4) < 0.5)
    tot = prior.astype(np.int32)
    yes = vals.sum(axis=1).astype(np.int32)
    state = np.array([1, 1, 1, 1, 2, 3, 4], np.int32)[ints(0, 7, p)]
    # a share of P2P rows sit at their round cap
    at_cap = (~gossip) & (uniform(p) < 0.1)
    cap[at_cap] = tot[at_cap]
    live = uniform(p) < 0.5
    pool = [state, yes, tot, mask, vals, n, req, cap, gossip, live]

    slots = torch.randperm(p, generator=gen)[:s].numpy().astype(np.int32)
    slots[uniform(s) < pad_share] = p  # pad rows
    expired = uniform(s) < 0.1
    lane_mask, val_bit, valid_bit = grid_layout(grid_np_dtype)
    hi = min(v, lane_mask + 1)
    lanes = ints(0, min(hi, 48), s, depth)  # small range: duplicates
    lanes[:, depth // 2:] = ints(0, hi, s, depth - depth // 2)
    cells = (
        lanes
        | ((uniform(s, depth) < 0.6).astype(np.int64) << val_bit)
        | ((uniform(s, depth) < 0.9).astype(np.int64) << valid_bit)
    )
    return pool, pack_slots(slots, expired), cells.astype(grid_np_dtype)


def to_device(pool, slot_pack, grid, dev):
    from hashgraph_tpu_torch.ops.ingest import grid_tensor

    tensors = [torch.tensor(a, dtype=dt, device=dev) for a, dt in zip(pool, POOL_DTYPES)]
    return tensors, torch.tensor(slot_pack, device=dev), grid_tensor(grid, dev)


def event_ms(fn, setup, reps):
    """Mean device time of ``fn`` over ``reps`` runs; ``setup`` restores
    the inputs outside the timed window."""
    total = 0.0
    for _ in range(reps):
        setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def restored_ms(fn, restore, reps):
    """Device time per call of ``fn`` on inputs put back as they were
    before every call: the stream is held by a sleep while the host
    enqueues ``reps`` rounds of ``restore`` then ``fn``, with CUDA events
    around ``fn`` alone, so every call meets the inputs the first met and
    neither the restore nor the host's enqueue is in the reading."""
    restore()
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        restore()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


def scan_work(pool, slot_pack, grid):
    """(sessions, votes, applied) of these inputs, as
    ``portbench/counts/ingest_scan.py`` counts a call: the real rows (each
    a distinct session), the valid votes they carry and the votes the
    plain scan applies."""
    from hashgraph_tpu_torch.ops.ingest import _unpack_cells, ingest_body

    real = (slot_pack & ((1 << 30) - 1)) < pool[0].shape[0]
    _, _, valid = _unpack_cells(torch.from_numpy(np.ascontiguousarray(
        grid.view(np.int16) if grid.dtype == np.uint16 else grid)))
    tensors, sp, g = to_device(pool, slot_pack, grid, "cpu")
    out = ingest_body(*tensors, sp, g)[-1].numpy()
    return (int(real.sum()), int(valid.numpy()[real].sum()),
            int((out[:, :-1][real] == 0).sum()))


def phase_kernel(dev):
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.ops import cuda_ingest
    from hashgraph_tpu_torch.ops.ingest import ingest_body

    # (label, P, V, S, L, grid, share of pad rows). Only the first three
    # carry pad rows: the engine sends none, so the main path's shapes are
    # timed as the engine dispatches them, one launch a call.
    cases = [
        ("uint8 with pad rows", 8192, 64, 4096, 8, np.uint8, 0.02),
        ("uint16 with pad rows", 8192, 1024, 4096, 8, np.uint16, 0.02),
        ("int32 with pad rows", 512, 65536, 256, 8, np.int32, 0.02),
        ("pad rows, depth 70", 4096, 1024, 1024, 70, np.uint16, 0.2),
        ("main path (uint16)", CAPACITY, VOTER_CAPACITY, 10_000, 8, np.uint16, 0.0),
        ("config 2's call (uint16)", CAPACITY, VOTER_CAPACITY, 1, 128, np.uint16, 0.0),
    ]
    timing = {}
    for i, (label, p, v, s, depth, dt, pad_share) in enumerate(cases):
        pool, slot_pack, grid = random_rows(100 + i, p, v, s, depth, dt, pad_share)
        has_pad = bool(((slot_pack & ((1 << 30) - 1)) >= p).any())
        if has_pad != (pad_share > 0):
            raise AssertionError(f"{label}: pad rows {has_pad}, share {pad_share}")
        base, sp, g = to_device(pool, slot_pack, grid, dev)
        plain = [t.clone() for t in base]
        plain_out = ingest_body(*plain, sp, g)[-1]
        before = _build.launches[cuda_ingest.KERNEL]
        grid_before = cuda_ingest.grid_launches
        kern = [t.clone() for t in base]
        kern_out = cuda_ingest.ingest_scan(*kern, sp, g, pad_rows=has_pad)
        torch.cuda.synchronize()
        if _build.launches[cuda_ingest.KERNEL] != before + 1:
            raise AssertionError("the scan wrapper did not count its launch")
        per_call = cuda_ingest.grid_launches - grid_before
        if per_call != (2 if has_pad else 1):
            raise AssertionError(f"{label}: {per_call} device launches for one call")
        for name, a, b in zip(
            ("state", "yes", "tot", "vote_mask", "vote_val", "n", "req", "cap",
             "gossip", "liveness", "out"),
            plain + [plain_out], kern + [kern_out],
        ):
            if not torch.equal(a, b):
                bad = int((a != b).sum())
                raise AssertionError(f"{label}: kernel differs from plain in {name} ({bad} cells)")
        statuses = kern_out[:, :-1].cpu().numpy()
        seen = sorted(set(np.unique(statuses).tolist()))
        log(f"[kernel] {label}: P={p} V={v} S={s} L={depth} grid={np.dtype(dt).name} "
            f"bit-exact against plain; {per_call} device launch(es); statuses seen {seen}")

        work = [t.clone() for t in base]

        def restore():
            for w, b0 in zip(work, base):
                w.copy_(b0)

        # Both on inputs put back before every call. ms: the kernel's device
        # time alone; call_ms: CUDA events around one wrapper call, the host's
        # enqueue included (how the scan was first timed).
        def call():
            return cuda_ingest.ingest_scan(*work, sp, g, pad_rows=has_pad)

        ms = restored_ms(call, restore, 20)
        call_ms = event_ms(call, restore, 20)
        plain_ms = event_ms(lambda: ingest_body(*work, sp, g), restore, 5)
        work_counts = scan_work(pool, slot_pack, grid)
        n_bytes = ingest_scan_counts.bytes_needed(*work_counts)
        bound = n_bytes / peaks.HBM_BYTES_PER_S * 1e3
        log(f"[kernel] {label}: {ms:.6f} ms device time a call, {call_ms:.6f} ms with the "
            f"host's enqueue, inputs put back before every call (plain {plain_ms:.6f} ms, byte "
            f"bound {bound:.6f} ms = {n_bytes} B / 3.35 TB/s for (sessions, votes, applied) "
            f"{work_counts})")
        timing[label] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound)
    return timing


# ── Phases 3-5: the engine on the card against the engine on the CPU ───


def make_engine(dev):
    from hashgraph_tpu_torch import StubConsensusSigner, TorchConsensusEngine
    from hashgraph_tpu_torch.events import BroadcastEventBus

    return TorchConsensusEngine(
        StubConsensusSigner(b"chip-smoke"), CAPACITY, VOTER_CAPACITY,
        event_bus=BroadcastEventBus(max_queued_events=10_000_000),
        max_sessions_per_scope=CAPACITY, device=dev, verify_cache=None,
    )


class Run:
    """One engine's view of a phase: creation-order ids and its events."""

    def __init__(self, engine):
        self.engine = engine
        self.rx = engine.event_bus().subscribe()
        self.pids: dict[str, list[int]] = {}

    def create(self, scope, requests, now, config=None):
        made = self.engine.create_proposals(scope, requests, now, config)
        self.pids.setdefault(scope, []).extend(p.proposal_id for p in made)

    def events_by_session(self):
        """scope -> creation index -> [(type, result, timestamp), ...]."""
        index = {(s, pid): k for s, pids in self.pids.items() for k, pid in enumerate(pids)}
        out: dict = {}
        while (item := self.rx.try_recv()) is not None:
            scope, ev = item
            key = index[(scope, ev.proposal_id)]
            out.setdefault(scope, {}).setdefault(key, []).append(
                (type(ev).__name__, getattr(ev, "result", None), ev.timestamp))
        return out

    def outcome(self, scope):
        from hashgraph_tpu_torch.errors import ConsensusFailed

        results = []
        for pid in self.pids[scope]:
            try:
                results.append(self.engine.get_consensus_result(scope, pid))
            except ConsensusFailed:
                results.append("failed")
        stats = self.engine.get_scope_stats(scope)
        return results, (stats.total_sessions, stats.active_sessions,
                         stats.failed_sessions, stats.consensus_reached)


def requests(n_props, voters, expiry, liveness):
    from hashgraph_tpu_torch import CreateProposalRequest

    return [
        CreateProposalRequest(
            name=f"p{i}", payload=i.to_bytes(4, "little"), proposal_owner=b"smoke",
            expected_voters_count=voters, expiration_timestamp=expiry,
            liveness_criteria_yes=liveness(i),
        )
        for i in range(n_props)
    ]


def compare(label, gpu, cpu):
    if gpu != cpu:
        raise AssertionError(f"{label}: the GPU engine differs from the CPU engine")


def config3_calls(run, seed):
    """Config 3's proposals on ``run``'s engine, and the arguments of its
    five ``ingest_columnar`` calls (see :func:`config3_traffic`)."""
    from hashgraph_tpu_torch import ConsensusConfig

    scope = "config3"
    engine = run.engine
    half = 5_000
    reqs = requests(2 * half, 64, 3600, lambda i: i % 4 < 2)
    run.create(scope, reqs[:half], NOW, ConsensusConfig.gossipsub())
    run.create(scope, reqs[half:], NOW, ConsensusConfig.p2p())
    gids = np.array([engine.voter_gid(b"voter-%d" % i) for i in range(64)])
    rng = np.random.default_rng(seed)
    pids = np.asarray(run.pids[scope], np.int64)
    waves = []
    for w in range(4):
        rows_p = np.repeat(np.arange(2 * half), 16)
        rows_v = (16 * w + np.tile(np.arange(16), 2 * half))
        order = rng.permutation(len(rows_p))
        vals = rng.random(len(rows_p)) < 0.6
        waves.append((rows_p[order], rows_v[order], vals))
    waves.append(waves[1])  # redelivery
    return [(scope, pids[rp], gids[rv], vals, NOW + 1 + w)
            for w, (rp, rv, vals) in enumerate(waves)]


def config3_traffic(run, seed):
    """10,000 proposals × 64 voters, half gossipsub and half P2P; four
    columnar waves of 16 votes per proposal, then wave 2 redelivered.
    Returns each call's statuses."""
    return [run.engine.ingest_columnar(*args, max_depth=8).tolist()
            for args in config3_calls(run, seed)]


def config2_traffic(run, seed):
    """One P2P proposal × 1024 voters in 8 calls of 128 votes."""
    from hashgraph_tpu_torch import ConsensusConfig

    scope = "config2"
    run.create(scope, requests(1, 1024, 3600, lambda i: True), NOW, ConsensusConfig.p2p())
    pid = run.pids[scope][0]
    gids = np.array([run.engine.voter_gid(b"peer-%d" % i) for i in range(1024)])
    vals = np.random.default_rng(seed).random(1024) < 0.9
    statuses = []
    for c in range(8):
        sl = slice(128 * c, 128 * (c + 1))
        st = run.engine.ingest_columnar(
            scope, np.full(128, pid), gids[sl], vals[sl], NOW + 1 + c, max_depth=8)
        statuses.extend(st.tolist())
    return statuses


def timeout_traffic(run, seed):
    """Sessions with silent peers (both liveness settings) swept after
    expiry; one vote arrives after expiry; explicit per-session timeouts."""
    from hashgraph_tpu_torch.errors import InsufficientVotesAtTimeout

    scope = "timeouts"
    rng = np.random.default_rng(seed)
    run.create(scope, requests(64, 16, 30, lambda i: i % 2 == 0), NOW)
    engine = run.engine
    pids = np.asarray(run.pids[scope], np.int64)
    gids = np.array([engine.voter_gid(b"t-%d" % i) for i in range(16)])
    rows_p, rows_v = [], []
    for k in range(64):
        for v in rng.permutation(16)[: int(rng.integers(0, 12))]:
            rows_p.append(k)
            rows_v.append(v)
    rows_p, rows_v = np.array(rows_p), np.array(rows_v)
    log_ = [engine.ingest_columnar(scope, pids[rows_p], gids[rows_v],
                                   rng.random(len(rows_p)) < 0.5, NOW + 1).tolist()]
    late = engine.ingest_columnar(scope, pids[:1], gids[15:16], np.array([True]), NOW + 40)
    log_.append(late.tolist())
    index = {pid: k for k, pid in enumerate(run.pids[scope])}
    log_.append(sorted((index[pid], r) for _, pid, r in engine.sweep_timeouts(NOW + 40)))
    for k in (0, 1, 2, 3):
        try:
            log_.append(engine.handle_consensus_timeout(scope, int(pids[k]), NOW + 41))
        except InsufficientVotesAtTimeout:  # raised after ConsensusFailed is emitted
            log_.append("insufficient votes")
    return log_


# ── Phase 5b: sessions the pool cannot hold, served on the host ────────

SPILL_WIDE = 16  # proposals of 2,000 voters, wider than voter_capacity
SPILL_POOLED = 10_000  # proposals of 64 voters beside them


def spill_traffic(run, seed):
    """16 proposals of 2,000 voters (served on the host) among 10,000 pooled
    proposals of 64 voters, voted in the same calls: one arrival-shuffled
    ingest_columnar call (1,400 votes a wide proposal, 16 a pooled one) and
    one pre-validated ingest_votes call of chained Vote objects; then a
    second engine whose pool of 64 slots overflows by 32 sessions; then
    sweep_timeouts on both. Returns the log of answers."""
    from hashgraph_tpu_torch import ConsensusConfig, StubConsensusSigner, build_vote

    engine = run.engine
    scope = "spill"
    wide_at = set(range(0, SPILL_POOLED + SPILL_WIDE, (SPILL_POOLED + SPILL_WIDE) // SPILL_WIDE))
    reqs = requests(SPILL_POOLED + SPILL_WIDE, 64, 60, lambda i: i % 3 != 0)
    for i in wide_at:
        reqs[i].expected_voters_count = 2_000
    run.create(scope, reqs, NOW, ConsensusConfig.gossipsub())
    log_ = [engine.occupancy()["host_spilled"]]
    pids = np.asarray(run.pids[scope], np.int64)
    wide = np.array(sorted(wide_at))
    pooled = np.array([i for i in range(len(reqs)) if i not in wide_at])
    gids = np.array([engine.voter_gid(b"s-%d" % i) for i in range(2_000)])
    rng = np.random.default_rng(seed)
    rows_p = np.concatenate([np.repeat(wide, 1_400), np.repeat(pooled, 16)])
    rows_v = np.concatenate([np.tile(rng.permutation(2_000)[:1_400], len(wide)),
                             np.tile(np.arange(16), len(pooled))])
    order = rng.permutation(len(rows_p))
    vals = rng.random(len(rows_p)) < 0.6
    log_.append(engine.ingest_columnar(scope, pids[rows_p[order]], gids[rows_v[order]],
                                       vals, NOW + 1).tolist())
    # Pre-validated object votes: 2 wide and 500 pooled proposals, chained,
    # by voters the columnar call did not use.
    targets = [int(wide[0]), int(wide[1])] * 100 + [int(k) for k in pooled[:500]] * 4
    shadows = {k: engine.get_proposal(scope, int(pids[k])) for k in set(targets)}
    items = []
    for j, k in enumerate(targets):
        signer = StubConsensusSigner(b"w-%d-%d" % (k, j))
        vote = build_vote(shadows[k], bool(rng.random() < 0.7), signer, NOW + 2)
        shadows[k].votes.append(vote)
        items.append((scope, vote))
    log_.append(engine.ingest_votes(items, NOW + 2, pre_validated=True).tolist())
    index = {pid: k for k, pid in enumerate(run.pids[scope])}
    log_.append(sorted((index[pid], r) for _, pid, r in engine.sweep_timeouts(NOW + 60)))
    log_.append(engine.occupancy()["host_spilled"])
    return log_


def overflow_traffic(run, seed):
    """A pool of 64 slots (voter_capacity 1,024) takes 96 proposals of 16
    voters: 32 are served on the host. Columnar votes on all, then
    sweep_timeouts after expiry."""
    scope = "overflow"
    engine = run.engine
    run.create(scope, requests(96, 16, 30, lambda i: i % 2 == 0), NOW)
    pids = np.asarray(run.pids[scope], np.int64)
    gids = np.array([engine.voter_gid(b"o-%d" % i) for i in range(16)])
    rng = np.random.default_rng(seed)
    rows_p, rows_v = [], []
    for k in range(96):
        for v in rng.permutation(16)[: int(rng.integers(0, 14))]:
            rows_p.append(k)
            rows_v.append(v)
    order = rng.permutation(len(rows_p))
    rows_p, rows_v = np.array(rows_p)[order], np.array(rows_v)[order]
    log_ = [engine.occupancy()["host_spilled"]]
    log_.append(engine.ingest_columnar(scope, pids[rows_p], gids[rows_v],
                                       rng.random(len(rows_p)) < 0.5, NOW + 1).tolist())
    index = {pid: k for k, pid in enumerate(run.pids[scope])}
    log_.append(sorted((index[pid], r) for _, pid, r in engine.sweep_timeouts(NOW + 40)))
    log_.append(engine.occupancy()["host_spilled"])
    return log_


def overflow_engine(dev):
    from hashgraph_tpu_torch import StubConsensusSigner, TorchConsensusEngine
    from hashgraph_tpu_torch.events import BroadcastEventBus

    return TorchConsensusEngine(
        StubConsensusSigner(b"chip-smoke"), 64, VOTER_CAPACITY,
        event_bus=BroadcastEventBus(max_queued_events=1_000_000),
        max_sessions_per_scope=1_000, device=dev, verify_cache=None,
    )


def phase_spill(dev):
    from hashgraph_tpu_torch.errors import StatusCode

    gpu, cpu = Run(make_engine(dev)), Run(make_engine("cpu"))
    gpu_log = spill_traffic(gpu, 51)
    cpu_log = spill_traffic(cpu, 51)
    compare("spill statuses", gpu_log, cpu_log)
    compare("spill results", gpu.outcome("spill"), cpu.outcome("spill"))
    compare("spill events", gpu.events_by_session(), cpu.events_by_session())
    if gpu_log[0] != SPILL_WIDE or gpu_log[-1] != SPILL_WIDE:
        raise AssertionError(f"spill: host_spilled {gpu_log[0]} then {gpu_log[-1]}, "
                             f"not {SPILL_WIDE}")
    results = gpu.outcome("spill")[0]
    wide = sorted(set(range(0, SPILL_POOLED + SPILL_WIDE,
                            (SPILL_POOLED + SPILL_WIDE) // SPILL_WIDE)))
    if not all(results[k] is not None for k in wide):
        raise AssertionError("a wide proposal served on the host did not decide")
    small_gpu, small_cpu = Run(overflow_engine(dev)), Run(overflow_engine("cpu"))
    o_gpu = overflow_traffic(small_gpu, 52)
    compare("overflow statuses", o_gpu, overflow_traffic(small_cpu, 52))
    compare("overflow results", small_gpu.outcome("overflow"), small_cpu.outcome("overflow"))
    compare("overflow events", small_gpu.events_by_session(), small_cpu.events_by_session())
    if o_gpu[0] != 32:
        raise AssertionError(f"overflow: {o_gpu[0]} sessions on the host, not 32")
    flat = gpu_log[1] + gpu_log[2]
    codes = {StatusCode(c).name: flat.count(c) for c in sorted(set(flat))}
    log(f"[spill] {SPILL_WIDE} proposals x 2000 voters on the host among {SPILL_POOLED} "
        f"pooled x 64, voted in one ingest_columnar and one pre-validated ingest_votes call: "
        f"statuses {codes}; wide results {[results[k] for k in wide]}; swept "
        f"{len(gpu_log[3])}; host_spilled {gpu_log[-1]}")
    log(f"[spill] pool of 64 took 96 proposals: host_spilled {o_gpu[0]}, swept {len(o_gpu[2])}; "
        "statuses, results, events, scope stats and spill counts identical to the CPU engine")


# ── Phase 6: the field-multiply kernel against its plain version ───────

MSM_LANES = 16_384  # the MSM's lane bucket for one batch of 4,096 signatures
DECOMPRESS_LANES = 8_192  # A and R of 4,096 signatures
# Integer instructions a lane, built from the field and point costs of
# ``portbench/counts/msm_windows.py`` (its FE_*, POINT_ADD and POINT_DBL).
# canon: two conditional subtracts of p, each per limb an IADD3 (limb,
# constant, borrow), a mask, a shift and the borrow's 1 - x, and 16 selects;
# is_zero adds an OR of 16 limbs (8 three-input LOP3); the final test is
# three doublings (8 * root), one sub and two is_zero.
FE_IS_ZERO_OPS = 2 * (16 * 4 + 16) + 8
MSM_FINAL_OPS = (3 * msm_windows_counts.POINT_DBL + msm_windows_counts.FE_SUB
                 + 2 * FE_IS_ZERO_OPS)
POW22523_OPS_PER_LANE = 251 * msm_windows_counts.FE_SQR + 11 * msm_windows_counts.FE_MUL
FE_MUL_BYTES_PER_LANE = 3 * 16 * 8  # two int64 operands read, one written
POINT_BYTES = 4 * 16 * 8  # one int64 [4, 16] point


def sass_functions(lib) -> "dict[str, list[tuple[int, str]]]":
    """Kernel name -> its SASS as (address, instruction), from ``cuobjdump
    -sass`` (beside ``nvcc``) of a built library."""
    from hashgraph_tpu_torch import _build

    cuobjdump = str(Path(_build.nvcc()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    parts = re.split(r"Function : (\S+)", text)
    return {name: [(int(a, 16), ins.strip()) for a, ins in
                   re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
            for name, body in zip(parts[1::2], parts[2::2])}


def field_rows(seed, lanes):
    """Carried operands from a seeded ``torch.Generator``, with the
    boundary and carry-ripple rows of the JAX package's field battery in
    the first ten lanes: 0, 1, 19, p-1, p, p+1, 2p, 2^256-1, 2^256-2^240
    and (2^256-2^240)|0xFFFF against 2^256-1."""
    from hashgraph_tpu_torch.crypto_device import field

    gen = torch.Generator().manual_seed(seed)
    a = torch.randint(0, 1 << 16, (lanes, 16), generator=gen, dtype=torch.int64)
    b = torch.randint(0, 1 << 16, (lanes, 16), generator=gen, dtype=torch.int64)
    p = field.P
    edge_a = [0, 1, 19, p - 1, p, p + 1, 2 * p, 2**256 - 1, 2**256 - 2**240,
              (2**256 - 2**240) | 0xFFFF]
    edge_b = [2**256 - 1] * 3 + [1, 0, p, 1, 2**256 - 1, 1, 2**256 - 1]
    for i, (x, y) in enumerate(zip(edge_a, edge_b)):
        a[i] = torch.from_numpy(field._int_to_limbs(x))
        b[i] = torch.from_numpy(field._int_to_limbs(y))
    return a, b


@contextlib.contextmanager
def plain_field_mul():
    """Route ``field.mul`` to the plain version (for the comparison only)."""
    from hashgraph_tpu_torch.crypto_device import field

    kernel_mul = field.mul
    field.mul = field._mul_plain
    try:
        yield
    finally:
        field.mul = kernel_mul


def device_ms(fn, reps):
    """Device time per call of ``fn``: the stream is held by a sleep while
    the host enqueues ``reps`` calls, so the calls run back to back and the
    host's launch cost stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_field(dev):
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.crypto_device import cuda_field, field

    a, b = (t.to(dev) for t in field_rows(6, MSM_LANES))
    plain = field._mul_plain(a, b)
    before = _build.launches[cuda_field.KERNEL]
    kern = cuda_field.fe_mul(a, b)
    torch.cuda.synchronize()
    if _build.launches[cuda_field.KERNEL] != before + 1:
        raise AssertionError("the fe_mul wrapper did not count its launch")
    max_err = int((kern - plain).abs().max())
    if not torch.equal(kern, plain):
        bad = int((kern != plain).any(dim=-1).sum())
        raise AssertionError(f"fe_mul differs from the plain version in {bad} lanes")
    if not bool(((kern >= 0) & (kern < 1 << 16)).all()):
        raise AssertionError("fe_mul left a limb outside [0, 2^16)")
    for i in range(10):
        x, y = field.limbs_to_int(a[i]), field.limbs_to_int(b[i])
        if field.limbs_to_int(kern[i]) % field.P != x * y % field.P:
            raise AssertionError(f"fe_mul boundary row {i} is not the product mod p")
    log(f"[field] fe_mul [{MSM_LANES}, 16] bit-exact against the plain version "
        f"(boundary and ripple rows included); max_abs_err {max_err}")

    z = field_rows(7, DECOMPRESS_LANES)[0].to(dev)
    before = _build.launches[cuda_field.POW_KERNEL]
    chain_kernel = field.pow22523(z)
    torch.cuda.synchronize()
    if _build.launches[cuda_field.POW_KERNEL] != before + 1:
        raise AssertionError("field.pow22523 did not launch the chain kernel once")
    chain_fe_mul = field._pow22523_plain(z)
    with plain_field_mul():
        chain_plain = field._pow22523_plain(z)
    pow_err = int((chain_kernel - chain_plain).abs().max())
    if not torch.equal(chain_kernel, chain_plain) or not torch.equal(chain_fe_mul, chain_plain):
        raise AssertionError("fe_pow22523 or the chain through fe_mul differs from the plain chain")
    for i in range(10):
        x = field.limbs_to_int(z[i])
        if field.limbs_to_int(chain_kernel[i]) % field.P != pow(x % field.P, (field.P - 5) // 8, field.P):
            raise AssertionError(f"fe_pow22523 boundary row {i} is not z^((p-5)/8)")
    log(f"[field] fe_pow22523 [{DECOMPRESS_LANES}, 16] bit-exact against _pow22523_plain "
        "(plain multiply; boundary and ripple rows included), and so is the chain "
        f"through the fe_mul kernel; max_abs_err {pow_err}")

    ms = device_ms(lambda: cuda_field.fe_mul(a, b), 20)
    plain_ms = device_ms(lambda: field._mul_plain(a, b), 5)
    fe_mul_row = kernel_row("fe_mul", ms, plain_ms, MSM_LANES * FE_MUL_BYTES_PER_LANE,
                            MSM_LANES * msm_windows_counts.FE_MUL, max_err)
    pow_ms = device_ms(lambda: cuda_field.fe_pow22523(z), 20)
    with plain_field_mul():
        pow_plain_ms = device_ms(lambda: field._pow22523_plain(z), 1)
    pow_row = kernel_row("fe_pow22523", pow_ms, pow_plain_ms, DECOMPRESS_LANES * 2 * 16 * 8,
                         DECOMPRESS_LANES * POW22523_OPS_PER_LANE, pow_err)
    return fe_mul_row, pow_row


def bound_of(n_bytes, n_ops):
    """(bound ms, what sets it): the larger of ``n_bytes`` over the memory
    rate and ``n_ops`` integer instructions over the issue rate, both of
    ``portbench/counts/peaks.py``."""
    bytes_ms = n_bytes / peaks.HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / peaks.INT_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def kernel_row(name, ms, plain_ms, n_bytes, n_ops, max_err):
    """Log one kernel's time against its bound (:func:`bound_of`) and
    return the timing keys of its row in the kernel table."""
    bound, bound_by = bound_of(n_bytes, n_ops)
    log(f"[{name}] {ms:.6f} ms (plain {plain_ms:.6f} ms); bound {bound:.6f} ms by "
        f"{bound_by}: {n_bytes} B / 3.35 TB/s, {n_ops} integer instructions / "
        f"{peaks.INT_OPS_PER_S:.4g}/s; {ms / bound:.2f}x the bound")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                max_abs_err=max_err)


# ── Phase 6b: the MSM kernels against their plain versions ─────────────

MSM_ODD_FOLDS = (1, 5, 1000)


def msm_inputs(seed, lanes, dev):
    """Real curve points, nibbles and the index of the solved lane, at
    ``lanes`` lanes. Lanes are sums of two of 128 seeded multiples of B,
    added on the card by the plain formulas (extended coordinates, Z != 1);
    lanes 2-65 are the identity and lanes 66-69 the order-4 point (y = 0).
    Nibbles are seeded, with row 0 all 0 and row 1 all 15; the last lane's
    row is then solved so that the combination accepts."""
    from hashgraph_tpu_torch.crypto_device import curve, field, msm
    from hashgraph_tpu_torch.signing import _ed25519 as twin

    rng = random.Random(seed)
    ks = [rng.randrange(1, twin.L) for _ in range(128)]
    base = torch.tensor(np.stack([
        np.stack([field._int_to_limbs(c) for c in twin._mul(twin._BASE, k)]) for k in ks
    ]), device=dev)
    a_idx = np.arange(lanes) % 128
    b_idx = (np.arange(lanes) // 128) % 128
    with plain_field_mul():
        pts = curve.add(base[torch.from_numpy(a_idx).to(dev)],
                        base[torch.from_numpy(b_idx).to(dev)]).contiguous()
    scalars = [(ks[a] + ks[b]) % twin.L for a, b in zip(a_idx.tolist(), b_idx.tolist())]
    pts[2:66] = curve.identity((64,), dev)
    low = twin._decode(bytes(32))
    pts[66:70] = torch.from_numpy(np.stack([field._int_to_limbs(c) for c in low])).to(dev)
    for i in range(2, 70):
        scalars[i] = None

    gen = torch.Generator().manual_seed(seed)
    nib = torch.randint(0, 16, (lanes, msm.WINDOWS), generator=gen, dtype=torch.int32).numpy()
    nib[0], nib[1] = 0, 15
    packed = ((nib[:, 0::2] << 4) | nib[:, 1::2]).astype(np.uint8)  # MSB-first bytes
    last = lanes - 1
    total = sum(int.from_bytes(packed[i].tobytes(), "big") * t
                for i, t in enumerate(scalars[:last]) if t is not None) % twin.L
    nib[last] = msm.scalars_to_nibbles([(-total * pow(scalars[last], -1, twin.L)) % twin.L])[0]
    return pts, torch.from_numpy(nib).to(dev), last


def tree_counts(span):
    """Lane counts the tree is held at beside the batch's: the odd folds,
    below, at and across the block's span and its odd folds, and one past
    span^2, which takes a second pass of spans."""
    return sorted({*MSM_ODD_FOLDS, span - 1, span, span + 1, 2 * span + 1, span * span + 1})


def tree_bound_counts(lanes):
    """Bytes and integer instructions the tree and its test need at
    ``lanes`` lanes: every point read once, the root and verdict written
    once; one ed_add per element of every level (pads with the identity
    included: they change limbs), then the final test."""
    from hashgraph_tpu_torch.crypto_device import msm

    adds = sum((n + 1) // 2 for n in msm.reduce_levels(lanes))
    return (lanes * POINT_BYTES + POINT_BYTES + 4,
            adds * msm_windows_counts.POINT_ADD + MSM_FINAL_OPS)


def phase_msm(dev):
    from hashgraph_tpu_torch.crypto_device import cuda_msm, msm

    pts, nib, last = msm_inputs(61, MSM_LANES, dev)
    acc = cuda_msm.msm_windows(pts, nib)
    with plain_field_mul():
        acc_plain = msm._windows_plain(pts, nib)
    torch.cuda.synchronize()
    windows_err = int((acc - acc_plain).abs().max())
    if not torch.equal(acc, acc_plain):
        bad = int((acc != acc_plain).flatten(1).any(dim=1).sum())
        raise AssertionError(f"msm_windows differs from _windows_plain in {bad} lanes")
    if not bool(((acc >= 0) & (acc < 1 << 16)).all()):
        raise AssertionError("msm_windows left a limb outside [0, 2^16)")
    log(f"[msm] msm_windows [{MSM_LANES}, 4, 16] x {msm.WINDOWS} windows bit-exact against "
        "_windows_plain (plain multiply; identity, order-4, all-0 and all-15 rows included)")

    # Rejecting: flip the last window of the solved lane. Windows are per
    # lane, so the plain accumulators change in that lane only.
    bad_nib = nib.clone()
    bad_nib[last, -1] ^= 1
    bad_acc = cuda_msm.msm_windows(pts, bad_nib)
    bad_plain = acc_plain.clone()
    with plain_field_mul():
        bad_plain[last] = msm._windows_plain(pts[last:], bad_nib[last:])[0]
    if not torch.equal(bad_acc, bad_plain):
        raise AssertionError("rejecting case: msm_windows differs from _windows_plain")

    # The tree's inputs: the batch, accepting and rejecting, and its first
    # lanes at the other counts (one past span^2 repeats lane 0).
    span = cuda_msm._lib().hg_msm_tree_span()
    cases = {"accepting": (acc, acc_plain), "rejecting": (bad_acc, bad_plain)}
    for n in tree_counts(span):
        if n <= MSM_LANES:
            cases[n] = (acc[:n].contiguous(), acc_plain[:n])
        else:
            extra = torch.arange(n - MSM_LANES, device=dev) % MSM_LANES
            cases[n] = (torch.cat([acc, acc[extra]]), torch.cat([acc_plain, acc_plain[extra]]))
    want = {}
    with plain_field_mul():
        for label, (_, plain_in) in cases.items():
            root = msm._reduce_plain(plain_in)
            want[label] = (root, int(msm._final_plain(root)))
    if want["accepting"][1] != 1 or want["rejecting"][1] != 0:
        raise AssertionError(f"plain verdicts: accepting {want['accepting'][1]}, rejecting "
                             f"{want['rejecting'][1]}")
    if not bool(msm.msm_is_identity(pts, nib)) or bool(msm.msm_is_identity(pts, bad_nib)):
        raise AssertionError("msm.msm_is_identity gave the wrong verdict")

    reduce_err = 0
    for label, (kernel_in, _) in cases.items():
        root, verdict = cuda_msm.msm_reduce(kernel_in)
        want_root, want_verdict = want[label]
        if not torch.equal(root, want_root) or int(verdict) != want_verdict:
            raise AssertionError(
                f"msm_reduce, {label} ({kernel_in.shape[0]} lanes): root equal "
                f"{torch.equal(root, want_root)}, verdict {int(verdict)} against plain "
                f"{want_verdict}")
        reduce_err = max(reduce_err, int((root - want_root).abs().max()))
    log(f"[msm] msm_reduce root limbs and verdict equal to _reduce_plain and _final_plain, "
        f"accepting and rejecting at {MSM_LANES} lanes and at {tree_counts(span)} lanes "
        f"(span {span})")

    windows_ms = device_ms(lambda: cuda_msm.msm_windows(pts, nib), 3)
    reduce_ms = device_ms(lambda: cuda_msm.msm_reduce(acc), 20)
    with plain_field_mul():
        windows_plain_ms = device_ms(lambda: msm._windows_plain(pts, nib), 1)
        reduce_plain_ms = device_ms(lambda: msm._final_plain(msm._reduce_plain(acc_plain)), 2)
    windows_row = kernel_row(
        "msm_windows", windows_ms, windows_plain_ms,
        MSM_LANES * (2 * POINT_BYTES + 4 * msm.WINDOWS),
        MSM_LANES * msm_windows_counts.PER_POINT, windows_err)
    reduce_row = kernel_row("msm_reduce", reduce_ms, reduce_plain_ms,
                            *tree_bound_counts(MSM_LANES), reduce_err)
    reduce_row["points_per_block"] = span
    reduce_row["launches_per_call"] = len(cuda_msm.tree_passes(MSM_LANES, span))
    # The call's two launches apart: the span pass, then the root block.
    lib, stream = cuda_msm._lib(), torch.cuda.current_stream().cuda_stream
    partials = torch.empty((MSM_LANES // span, 4, 16), dtype=torch.int64, device=dev)
    root = torch.empty((4, 16), dtype=torch.int64, device=dev)
    verdict = torch.empty((), dtype=torch.int32, device=dev)
    reduce_row["span_pass_ms"] = device_ms(lambda: lib.hg_msm_tree_partials(
        acc.data_ptr(), partials.data_ptr(), MSM_LANES, stream), 20)
    reduce_row["root_pass_ms"] = device_ms(lambda: lib.hg_msm_tree_root(
        partials.data_ptr(), partials.shape[0], root.data_ptr(), verdict.data_ptr(), stream), 20)
    log(f"[msm] msm_reduce times are for the whole tree and the final test: "
        f"{reduce_row['launches_per_call']} launches at {MSM_LANES} lanes, the span pass "
        f"{reduce_row['span_pass_ms']:.6f} ms and the root block {reduce_row['root_pass_ms']:.6f} "
        "ms alone")
    return windows_row, reduce_row


# ── Phase 6c: the SHA-512 kernel against its plain version ────────────

# Integer instructions a SHA-512 block needs on the card's 32-bit units: a
# 64-bit rotate is two funnel shifts (SHF), a 64-bit shift two, a 64-bit
# add two (IADD3 and its carry), a 64-bit three-input XOR or select two
# LOP3. A round: Sigma1 and Sigma0 three rotates and an XOR each (8 + 8),
# Ch and Maj a LOP3 a half each (2 + 2), t1 four adds (8), e one add and
# a two (2 + 4): 34. A schedule step: sigma0 and sigma1 two rotates, a
# shift and an XOR each (8 + 8), three adds (6): 22. 80 rounds, 64 steps
# and the 8 feed-forward adds. The message build (byte loads and packing)
# is left out, so the bound is a floor.
SHA512_OPS_PER_BLOCK = 80 * 34 + 64 * 22 + 8 * 2
# The signed cell's R || A || M lengths span 147-193 bytes (two blocks).
SHA512_SIGNED_LENGTHS = (147, 194)


def sha512_cases(lanes, seed):
    """Seeded messages at ``lanes`` lanes: (label, messages, max_blocks).
    Eight lanes of the padding boundaries (1-4 blocks); a batch of the
    signed cell's lengths (2 blocks); a ragged batch of 0-495 bytes (1-4
    blocks)."""
    rng = np.random.default_rng(seed)

    def msgs(lengths):
        return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]

    if lanes == 8:
        return [("boundaries", msgs([0, 1, 111, 112, 239, 240, 367, 495]), 4)]
    return [
        ("signed lengths", msgs(rng.integers(*SHA512_SIGNED_LENGTHS, lanes)), 2),
        ("ragged 0-495 B", msgs(rng.integers(0, 496, lanes)), 4),
    ]


def phase_sha512(dev):
    """The kernel of ``csrc/sha512.cu`` against ``sha512._sha512_blocks``
    on the card and against hashlib, bit for bit, at 8 and 16,384 lanes of
    1-4 blocks; its launch count; its time at the signed cell's batch
    beside its bound and the plain version's time."""
    import hashlib

    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.crypto_device import sha512 as sh

    checked = []
    for lanes, seed in ((8, 90), (MSM_LANES, 91)):
        for label, messages, max_blocks in sha512_cases(lanes, seed):
            before = _build.launches[sh.KERNEL]
            words = sh.sha512_batch_dispatch(messages, max_blocks, dev)
            torch.cuda.synchronize()
            if _build.launches[sh.KERNEL] != before + 1:
                raise AssertionError("sha512_batch_dispatch did not launch the kernel once")
            nblocks = sh._checked_blocks(sh._lengths(messages), max_blocks)
            w32 = torch.from_numpy(sh._packed_words(messages, nblocks, max_blocks)).to(dev)
            plain = sh._sha512_blocks(w32, torch.from_numpy(nblocks).to(dev))
            if not torch.equal(words, plain):
                bad = int((words != plain).any(dim=1).sum())
                raise AssertionError(f"sha512 {label} at {lanes} lanes differs from "
                                     f"_sha512_blocks in {bad} lanes")
            digests = sh.digest_bytes(words)
            wrong = [i for i, m in enumerate(messages)
                     if digests[i].tobytes() != hashlib.sha512(m).digest()]
            if wrong:
                raise AssertionError(f"sha512 {label}: lanes {wrong[:8]} differ from hashlib")
            checked.append(f"{label} at {lanes} lanes ({int(nblocks.min())}-"
                           f"{int(nblocks.max())} blocks)")
    log(f"[sha512] bit-exact against _sha512_blocks on the card and hashlib: "
        f"{'; '.join(checked)}; one launch a call")

    # The signed cell's batch: 16,384 lanes of two blocks.
    messages = sha512_cases(MSM_LANES, 92)[0][1]
    host, head = sh._ragged(messages, sh._lengths(messages))
    buf = torch.from_numpy(host).to(dev)
    out = torch.empty((MSM_LANES, 16), dtype=torch.int64, device=dev)
    kernel = sh._kernel()

    def launch():
        err = kernel(buf.data_ptr(), buf.data_ptr() + head, out.data_ptr(), MSM_LANES,
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sha512: kernel launch failed (cudaError {err})")

    ms = device_ms(launch, 20)
    nblocks = sh._checked_blocks(sh._lengths(messages), 2)
    w32 = torch.from_numpy(sh._packed_words(messages, nblocks, 2)).to(dev)
    nb = torch.from_numpy(nblocks).to(dev)
    plain_ms = device_ms(lambda: sh._sha512_blocks(w32, nb), 1)
    row = kernel_row("sha512", ms, plain_ms, host.nbytes + MSM_LANES * 16 * 8,
                     int(nblocks.sum()) * SHA512_OPS_PER_BLOCK, 0)
    sass = sass_functions(_build._target(sh.KERNEL))
    row["sass_instructions"] = len(next(r for name, r in sass.items() if "sha512" in name))
    log(f"[sha512] {MSM_LANES} lanes of the signed cell's lengths: {SHA512_OPS_PER_BLOCK} "
        f"instructions a block counted for the bound, {row['sass_instructions']} in the "
        f"kernel's SASS (the 80 rounds unrolled)")
    return row


# ── Phase 7: validated ingest through device verification ──────────────

VERIFY_PROPOSALS = 256
VERIFY_VOTERS = 16
VERIFY_KEYS = 64
# Every kernel a device-verified batch launches.
VERIFY_KERNELS = ("fe_mul", "fe_pow22523", "msm_windows", "msm_reduce")


def verify_engine(dev, signer):
    from hashgraph_tpu_torch import TorchConsensusEngine
    from hashgraph_tpu_torch.events import BroadcastEventBus

    return TorchConsensusEngine(
        signer, CAPACITY, VOTER_CAPACITY,
        event_bus=BroadcastEventBus(max_queued_events=1_000_000),
        max_sessions_per_scope=CAPACITY, device=dev, verify_cache=None,
    )


def create_seeded(run, scope, n, seed):
    """``n`` proposals of 16 voters whose ids come from seeded entropy, so
    two engines hold the same proposal ids and take the same vote bytes."""
    from hashgraph_tpu_torch import protocol

    rng = random.Random(seed)
    protocol.set_id_entropy(lambda: rng.getrandbits(128))
    try:
        for req in requests(n, VERIFY_VOTERS, 3600, lambda i: i % 2 == 0):
            proposal = run.engine.create_proposal(scope, req, NOW)
            run.pids.setdefault(scope, []).append(proposal.proposal_id)
    finally:
        protocol.set_id_entropy(None)


def signed_votes(engine, scope, pids, keys, seed, corrupt=None):
    """Encoded votes, 16 per proposal from distinct keys, each chained onto
    the proposal's previous one and interleaved across proposals.
    ``corrupt`` maps a proposal's index to a damage applied to its last
    vote (nothing chains onto it)."""
    from hashgraph_tpu_torch import build_vote, compute_vote_hash, protocol
    from hashgraph_tpu_torch.signing._ed25519 import L

    rng = random.Random(seed)
    protocol.set_id_entropy(lambda: rng.getrandbits(128))
    try:
        shadows = [engine.get_proposal(scope, pid) for pid in pids]
        out = []
        for j in range(VERIFY_VOTERS):
            for k, prop in enumerate(shadows):
                vote = build_vote(prop, rng.random() < 0.8,
                                  keys[(4 * k + j) % len(keys)], NOW + 1)
                kind = (corrupt or {}).get(k) if j == VERIFY_VOTERS - 1 else None
                sig, s_int = vote.signature, int.from_bytes(vote.signature[32:], "little")
                if kind == "scalar":
                    vote.signature = sig[:32] + ((s_int + 7) % L).to_bytes(32, "little")
                elif kind == "s>=L":
                    vote.signature = sig[:32] + (s_int + L).to_bytes(32, "little")
                elif kind == "bad-A":
                    vote.vote_owner = b"\xff" * 32
                    vote.vote_hash = compute_vote_hash(vote)
                elif kind == "R-sign":
                    vote.signature = sig[:31] + bytes([sig[31] ^ 0x80]) + sig[32:]
                prop.votes.append(vote)
                out.append(vote.encode())
        return out
    finally:
        protocol.set_id_entropy(None)


def torch_ops(fn) -> int:
    """PyTorch operator calls that ``fn`` makes (on the card each non-view
    call is a launch; the fe_mul wrapper's ctypes launch is not one)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.calls


def phase_verify(dev):
    from hashgraph_tpu_torch import _build, native
    from hashgraph_tpu_torch.crypto_device import cuda_field, cuda_msm, sha512
    from hashgraph_tpu_torch.errors import StatusCode
    from hashgraph_tpu_torch.signing import (
        Ed25519ConsensusSigner,
        Ed25519DeviceConsensusSigner,
    )
    from hashgraph_tpu_torch.signing import _ed25519 as twin
    from hashgraph_tpu_torch.wire import Vote

    scope = "verify"
    rng = random.Random(70)
    keys = [Ed25519ConsensusSigner(rng.randbytes(32)) for _ in range(VERIFY_KEYS)]
    gpu = Run(verify_engine(dev, Ed25519DeviceConsensusSigner(rng.randbytes(32))))
    cpu = Run(verify_engine("cpu", Ed25519ConsensusSigner(rng.randbytes(32))))
    if torch.device(type(gpu.engine.signer()).device).type != torch.device(dev).type:
        raise AssertionError("the device signer does not verify on the card")
    n_main, n_blame = VERIFY_PROPOSALS, 4
    for run in (gpu, cpu):
        create_seeded(run, scope, n_main + n_blame, 71)
    if gpu.pids != cpu.pids:
        raise AssertionError("the two engines minted different proposal ids")
    pids = gpu.pids[scope]
    main_bytes = signed_votes(gpu.engine, scope, pids[:n_main], keys, 72)
    blame_bytes = signed_votes(gpu.engine, scope, pids[n_main:], keys, 73,
                               corrupt={0: "scalar", 1: "s>=L", 2: "bad-A", 3: "R-sign"})

    def ingest(run, data, now):
        return run.engine.ingest_votes([(scope, Vote.decode(b)) for b in data], now).tolist()

    # Warm the pipeline (allocator, first launches) on a batch of its own.
    warm = [Vote.decode(b) for b in blame_bytes[:32]]
    Ed25519DeviceConsensusSigner.verify_batch(
        [v.vote_owner for v in warm], [v.signing_payload() for v in warm],
        [v.signature for v in warm])

    # The main path: counts are zeroed just before it and read just after.
    _build.launches.clear()
    st_main = ingest(gpu, main_bytes, NOW + 2)
    phases_main = Ed25519DeviceConsensusSigner.device_phase_seconds()
    main_launches = dict(_build.launches)
    _build.launches.clear()
    st_blame = ingest(gpu, blame_bytes, NOW + 3)
    phases_blame = Ed25519DeviceConsensusSigner.device_phase_seconds()
    blame_launches = dict(_build.launches)
    # One MSM a batch: one window launch and the tree's, exactly (the main
    # call's batch has MSM_LANES lanes; the blame call's at most one span).
    tree_launches = len(cuda_msm.tree_passes(MSM_LANES, cuda_msm._lib().hg_msm_tree_span()))
    for label, counts, tree in (("main", main_launches, tree_launches),
                                ("blame", blame_launches, 1)):
        missing = [k for k in VERIFY_KERNELS if not counts.get(k)]
        msm_counts = [counts.get(k, 0) for k in cuda_msm.KERNELS]
        if (missing or msm_counts != [1, tree] or counts[cuda_field.KERNEL] > 20
                or counts.get(sha512.KERNEL) != 1):
            raise AssertionError(f"{label} call: launches {counts}; kernels never launched "
                                 f"{missing}; MSM launches {msm_counts} (want [1, {tree}]); "
                                 f"SHA-512 launches {counts.get(sha512.KERNEL)} (want 1, one "
                                 "a batch)")
    if phases_main["fallback"] != 0.0 or not phases_blame["fallback"] > 0.0:
        raise AssertionError(f"blame fallback: main {phases_main}, second call {phases_blame}")

    cpu_main = ingest(cpu, main_bytes, NOW + 2)
    cpu_blame = ingest(cpu, blame_bytes, NOW + 3)
    compare("verify statuses", [st_main, st_blame], [cpu_main, cpu_blame])
    compare("verify results", gpu.outcome(scope), cpu.outcome(scope))
    compare("verify events", gpu.events_by_session(), cpu.events_by_session())
    codes = {StatusCode(c).name: st_main.count(c) for c in sorted(set(st_main))}
    blame_codes = {StatusCode(c).name: st_blame.count(c) for c in sorted(set(st_blame))}
    if set(codes) - {"OK", "ALREADY_REACHED"} or not codes.get("OK"):
        raise AssertionError(f"the valid batch was not accepted: {codes}")
    if blame_codes.get("INVALID_VOTE_SIGNATURE") != 4:
        raise AssertionError(f"the damaged votes were not all rejected: {blame_codes}")
    _, stats = gpu.outcome(scope)

    # The host verifiers accept the batch: the twin a slice of it, the
    # native runtime's batch verification all of it.
    sample = [Vote.decode(b) for b in main_bytes[:256]]
    if not all(twin.verify(v.vote_owner, v.signing_payload(), v.signature) for v in sample):
        raise AssertionError("the twin rejected a valid signature")
    everything = [Vote.decode(b) for b in main_bytes]
    native_ok = native.ed25519_verify_batch(
        [v.vote_owner for v in everything], [v.signing_payload() for v in everything],
        [v.signature for v in everything])
    if native_ok is None or not native_ok.all():
        raise AssertionError("the native batch verification rejected a valid signature")

    # The hash stage is the kernel's wrapper: one copy, one allocation and
    # a ctypes launch, where the plain version made some 27,500 calls.
    hash_ops = torch_ops(lambda: sha512.sha512_batch_dispatch([b"m" * 150] * 8, 2, dev))
    if hash_ops > 4:
        raise AssertionError(f"the hash stage made {hash_ops} PyTorch operator "
                             "calls (want at most 4: the kernel's copy and output)")
    log(f"[verify] {len(main_bytes)} votes in one ingest_votes call on the GPU engine, one "
        f"device batch: launches per kernel {json.dumps(main_launches)}; statuses {codes}")
    log(f"[verify] second call, 64 votes with 4 damaged, the host blame: launches per kernel "
        f"{json.dumps(blame_launches)}; statuses {blame_codes}")
    log(f"[verify] the twin and the native batch verification accept the batch; the hash "
        f"stage makes {hash_ops} PyTorch operator calls; stats (total, active, failed, "
        f"reached) {stats}; statuses, results and events identical to the CPU engine's")
    return dict(launches=main_launches, launches_blame=blame_launches)


# ── Phase 8: proposals from peers (ingest, delivery, redelivery) ───────

PROP_KEYS = 64
PROP_MAIN = 64  # proposals of PROP_VOTERS expected voters, half gossipsub, half P2P
PROP_VOTERS = 64
PROP_FIRST = 32  # votes each chain carries in (a)
PROP_WAVE = 16  # votes each wave of (b) tries to add to every chain
PROP_SCOPES = ("gossip", "p2p")
# Proposal-path kernels: the verification batch's and the scan's.
PROPOSAL_KERNELS = VERIFY_KERNELS + ("ingest_scan",)


def counting_device_signer():
    """The device Ed25519 scheme, counting each (payload, signature) it is
    asked to verify and keeping every batch's phase seconds (with its item
    count and the kernel launches, of every thread, from submit to
    collected) as the batch is collected."""
    from collections import Counter

    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.signing import Ed25519DeviceConsensusSigner, PendingVerdicts

    class CountingDeviceSigner(Ed25519DeviceConsensusSigner):
        submitted: Counter = Counter()
        batches: list = []

        @classmethod
        def verify_batch_submit(cls, identities, payloads, signatures):
            cls.submitted.update(p + s for p, s in zip(payloads, signatures))
            before = dict(_build.launches)
            pending = super().verify_batch_submit(identities, payloads, signatures)

            def collect():
                out = pending.collect()
                cls.batches.append(dict(
                    cls.device_phase_seconds(), items=len(payloads),
                    launches={k: v - before.get(k, 0) for k, v in _build.launches.items()
                              if v != before.get(k, 0)}))
                return out

            return PendingVerdicts(collect)

    return CountingDeviceSigner


class KernelInputs:
    """While :meth:`active`, keeps the first inputs (cloned) that each
    verification kernel's wrapper is given at each shape, so that every
    kernel can be held against its plain version at the shapes the path
    gave it. The callers look the wrappers up on their modules at every
    call (``field.mul`` calls ``cuda_field.fe_mul``, ``msm.msm_is_identity``
    ``cuda_msm.msm_windows`` and ``cuda_msm.msm_reduce``), so every launch
    passes here; the spy itself launches nothing."""

    def __init__(self):
        from hashgraph_tpu_torch.crypto_device import cuda_field, cuda_msm

        self.wrappers = [(cuda_field, "fe_mul"), (cuda_field, "fe_pow22523"),
                         (cuda_msm, "msm_windows"), (cuda_msm, "msm_reduce")]
        self.seen = {}

    @contextlib.contextmanager
    def active(self):
        saved = [getattr(module, name) for module, name in self.wrappers]
        for (module, name), fn in zip(self.wrappers, saved):
            setattr(module, name, self._spy(name, fn))
        try:
            yield self
        finally:
            for (module, name), fn in zip(self.wrappers, saved):
                setattr(module, name, fn)

    def _spy(self, name, fn):
        def spy(*args):
            key = (name, tuple(args[0].shape))
            if key not in self.seen:
                self.seen[key] = tuple(a.clone() for a in args)
            return fn(*args)

        return spy


def hold_captured(captured):
    """Each kernel on the inputs the path gave it, against its plain
    version: fe_mul and fe_pow22523 limb for limb at every shape;
    msm_windows limb for limb, then with the last window of lane 0 changed
    (a rejecting combination), and msm_reduce's root and verdict on both
    (accepting on the path's input, rejecting on the changed one), at the
    fewest and the most lanes (the plain window pass takes seconds a call,
    whatever the lanes). Returns the shapes held per kernel."""
    from hashgraph_tpu_torch.crypto_device import cuda_field, cuda_msm, field, msm

    msm_lanes = sorted(shape[0] for name, shape in captured.seen if name == "msm_windows")
    held = {}
    for (name, shape), args in sorted(captured.seen.items()):
        if name.startswith("msm_") and shape[0] not in (msm_lanes[0], msm_lanes[-1]):
            continue
        if name == "fe_mul":
            ok = torch.equal(cuda_field.fe_mul(*args), field._mul_plain(*args))
        elif name == "fe_pow22523":
            with plain_field_mul():
                want = field._pow22523_plain(*args)
            ok = torch.equal(cuda_field.fe_pow22523(*args), want)
        elif name == "msm_windows":
            pts, nib = args
            bad_nib = nib.clone()
            bad_nib[0, -1] ^= 1
            with plain_field_mul():
                # Both cases in one plain pass: lane 0 again, changed, last.
                both = msm._windows_plain(torch.cat([pts, pts[:1]]),
                                          torch.cat([nib, bad_nib[:1]]))
                acc_plain = both[:-1]
                bad_plain = acc_plain.clone()
                bad_plain[0] = both[-1]
                root_plain = msm._reduce_plain(bad_plain)
                verdict_plain = int(msm._final_plain(root_plain))
            bad = cuda_msm.msm_windows(pts, bad_nib)
            root, verdict = cuda_msm.msm_reduce(bad)
            ok = (torch.equal(cuda_msm.msm_windows(pts, nib), acc_plain)
                  and torch.equal(bad, bad_plain) and torch.equal(root, root_plain)
                  and int(verdict) == verdict_plain == 0)
        else:
            (acc,) = args
            with plain_field_mul():
                root_plain = msm._reduce_plain(acc)
                verdict_plain = int(msm._final_plain(root_plain))
            root, verdict = cuda_msm.msm_reduce(acc)
            ok = torch.equal(root, root_plain) and int(verdict) == verdict_plain == 1
        if not ok:
            raise AssertionError(f"{name} at {list(shape)} on the path's inputs differs "
                                 "from its plain version")
        held.setdefault(name, []).append(list(shape))
    return held


class _Unsigned:
    """A key that builds votes with an empty signature; the signatures are
    made afterwards, all at once, by the native runtime."""

    def __init__(self, key):
        self.key = key

    def identity(self):
        return self.key.identity()

    def sign(self, payload):
        return b""


def proposal_engine(dev, signer, cache, capacity=CAPACITY, voter_capacity=VOTER_CAPACITY):
    from hashgraph_tpu_torch import TorchConsensusEngine
    from hashgraph_tpu_torch.events import BroadcastEventBus

    engine = TorchConsensusEngine(
        signer, capacity, voter_capacity,
        event_bus=BroadcastEventBus(max_queued_events=1_000_000),
        max_sessions_per_scope=capacity, device=dev, verify_cache=cache,
    )
    engine.scope("p2p").p2p_preset().initialize()
    return engine


def proposal_traffic_data(n_main=PROP_MAIN, first=PROP_FIRST, wave=PROP_WAVE,
                          wide_voters=2000):
    """The senders' side of phase 8, as encoded wire bytes.

    A sender engine on the CPU (pre-validated votes) holds ``n_main``
    proposals of PROP_VOTERS expected voters with seeded ids, half in the
    gossipsub scope and half in the P2P one. PROP_KEYS keys vote on each in
    a rotating order; a vote joins a chain only where the sender accepts it,
    so every gossiped chain is a chain its sender holds (a chain stops
    growing at its decision). Stage (a) is ``first`` votes a chain, then two
    waves of ``wave`` more. Returns the stages' items, the keys' seeds, the
    expected (a) statuses, and the count of signatures made."""
    from hashgraph_tpu_torch import (
        CreateProposalRequest,
        Ed25519ConsensusSigner,
        StubConsensusSigner,
        build_vote,
        native,
        protocol,
    )
    from hashgraph_tpu_torch.errors import StatusCode
    from hashgraph_tpu_torch.signing._ed25519 import L

    rng = random.Random(80)
    keys = [Ed25519ConsensusSigner(rng.randbytes(32)) for _ in range(PROP_KEYS)]
    unsigned = [_Unsigned(k) for k in keys]
    seed_of = {k.identity(): k.private_key_bytes() for k in keys}
    protocol.set_id_entropy(lambda: rng.getrandbits(128))
    try:
        sender = proposal_engine("cpu", StubConsensusSigner(b"sender"), None,
                                 capacity=2 * n_main + 8, voter_capacity=PROP_VOTERS)

        def create(scope, n, expiry, live, name):
            return sender.create_proposal(scope, CreateProposalRequest(
                name=name, payload=name.encode(), proposal_owner=b"phase8",
                expected_voters_count=n, expiration_timestamp=expiry,
                liveness_criteria_yes=live), NOW)

        main = []  # (scope, base proposal, yes probability)
        for k in range(n_main):
            scope = PROP_SCOPES[k * 2 // n_main]
            live = k % 2 == 0
            # Gossipsub chains lean against their liveness side so that the
            # silent peers do not decide them at the quorum; P2P chains
            # (capped at 43 votes) lean with it and decide at the quorum.
            p_yes = (0.3 if live else 0.7) if scope == "gossip" else (0.8 if live else 0.2)
            main.append((scope, create(scope, PROP_VOTERS, 3600, live, f"m{k}"), p_yes))
        chains = [[] for _ in main]

        def extend(count, t0):
            for i in range(count):
                batch = []
                for k, (scope, base, p_yes) in enumerate(main):
                    shadow = base.clone()
                    shadow.votes = chains[k]
                    pos = len(chains[k])
                    vote = build_vote(shadow, rng.random() < p_yes,
                                      unsigned[(k + pos) % PROP_KEYS], t0 + i)
                    batch.append((scope, vote))
                statuses = sender.ingest_votes(batch, t0 + i, pre_validated=True)
                for k, ((_, vote), st) in enumerate(zip(batch, statuses)):
                    if st == int(StatusCode.OK):
                        chains[k].append(vote)

        extend(first, NOW + 1)
        lengths = [[len(c) for c in chains]]
        extend(wave, NOW + 1 + first)
        lengths.append([len(c) for c in chains])
        extend(wave, NOW + 1 + first + wave)
        lengths.append([len(c) for c in chains])

        def chain_of(base, votes):
            p = base.clone()
            p.votes = list(votes)
            return p

        def fresh_chain(scope, n, n_votes, expiry, name):
            base = create(scope, n, expiry, True, name)
            p = base.clone()
            for i in range(n_votes):
                p.votes.append(build_vote(p, True, unsigned[i], NOW + 1 + i))
            return p

        # Stage (a): the main chains at ``first`` votes, some damaged.
        items_a = [(scope, chain_of(base, chains[k][:lengths[0][k]]))
                   for k, (scope, base, _) in enumerate(main)]
        expected = [int(StatusCode.OK)] * len(items_a)
        extra_sign = []
        damage = {1: "link", 3: "link", 5: "parent", 7: "shadow", 9: "s>=L", 11: "R"}
        for k, kind in damage.items():
            p = items_a[k][1]
            p.votes = [v.clone() for v in p.votes]  # signed on their own below
            if kind == "link":
                p.votes[20].received_hash = b"\x13" * 32
                p.votes[20].vote_hash = protocol.compute_vote_hash(p.votes[20])
                extra_sign.append(p.votes[20])
                expected[k] = int(StatusCode.RECEIVED_HASH_MISMATCH)
            elif kind == "parent":
                p.votes[20].parent_hash = p.votes[3].vote_hash  # another owner's vote
                p.votes[20].vote_hash = protocol.compute_vote_hash(p.votes[20])
                extra_sign.append(p.votes[20])
                expected[k] = int(StatusCode.PARENT_HASH_MISMATCH)
            elif kind == "shadow":
                # Vote 5's owner votes again at 30 (parent link to vote 5),
                # and a copy of vote 5 comes last: the hash index resolves
                # to that last copy, after 30, so the link at 30 fails —
                # under first-occurrence lookup it would pass, and the
                # copy's received link would fail at 31 instead.
                p.votes = p.votes[:30]
                owner = next(u for u in unsigned if u.identity() == p.votes[5].vote_owner)
                again = build_vote(p, True, owner, NOW + 40)
                p.votes.append(again)
                p.votes.append(p.votes[5].clone())
                extra_sign.append(again)
                expected[k] = int(StatusCode.PARENT_HASH_MISMATCH)
            else:
                expected[k] = int(StatusCode.INVALID_VOTE_SIGNATURE)
        expired = [fresh_chain(PROP_SCOPES[j], PROP_VOTERS, first, 5, f"x{j}") for j in range(2)]
        wide = fresh_chain("gossip", wide_voters, first, 3600, "wide")
        decided = fresh_chain("gossip", 16, 16, 3600, "decided")
        items_a += [(PROP_SCOPES[j], p) for j, p in enumerate(expired)]
        expected += [int(StatusCode.PROPOSAL_EXPIRED)] * 2
        items_a += [items_a[0], items_a[n_main // 2]]  # redelivered pids
        expected += [int(StatusCode.PROPOSAL_ALREADY_EXIST)] * 2
        items_a += [("gossip", wide), ("gossip", decided)]
        expected += [int(StatusCode.OK)] * 2
    finally:
        protocol.set_id_entropy(None)
    if lengths[0] != [first] * n_main:
        raise AssertionError(f"the sender decided a chain before {first} votes: {lengths[0]}")

    # Sign every vote at once, with the native runtime.
    to_sign = {id(v): v for c in chains for v in c}
    for p in expired + [wide, decided]:
        to_sign.update((id(v), v) for v in p.votes)
    for k in damage:
        to_sign.update((id(v), v) for v in items_a[k][1].votes)
    todo = list(to_sign.values())
    for vote in todo:
        vote.signature = native.ed25519_sign(seed_of[vote.vote_owner], vote.signing_payload())
        if vote.signature is None:
            raise AssertionError("the native runtime did not sign")
    for k, kind in damage.items():
        p = items_a[k][1]
        if kind in ("s>=L", "R"):
            v = p.votes[20]
            s_int = int.from_bytes(v.signature[32:], "little")
            v.signature = (v.signature[:32] + (s_int + L).to_bytes(32, "little")
                           if kind == "s>=L" else b"\xff" * 32 + v.signature[32:])

    def wire(items):
        return [(scope, p.encode()) for scope, p in items]

    stage_b = [wire((scope, chain_of(base, chains[k][:lengths[w][k]]))
                    for k, (scope, base, _) in enumerate(main)) for w in (1, 2)]
    return dict(
        a=wire(items_a), b=stage_b, c=stage_b[1], expected_a=expected,
        lengths=lengths, signed=len(todo),
        chains=[[v.vote_hash for v in p.votes] for _, p in items_a],
        chain_pids=[(scope, p.proposal_id) for scope, p in items_a],
    )


class ProposalRun:
    """One receiving engine's results in phase 8."""

    def __init__(self, engine):
        self.engine = engine
        self.rx = engine.event_bus().subscribe()

    def events(self):
        out = []
        while (item := self.rx.try_recv()) is not None:
            scope, ev = item
            out.append((scope, type(ev).__name__, ev.proposal_id,
                        getattr(ev, "result", None), ev.timestamp))
        return out

    def state(self, keys):
        """Per session: the result (or what raised) and the vote hashes;
        then each scope's stats and the engine's spill count."""
        out = []
        for scope, pid in keys:
            try:
                result = self.engine.get_consensus_result(scope, pid)
                votes = [v.vote_hash for v in self.engine.get_proposal(scope, pid).votes]
            except Exception as exc:  # the exception type is the state compared
                result, votes = type(exc).__name__, None
            out.append((scope, pid, result, votes))
        for scope in PROP_SCOPES:
            st = self.engine.get_scope_stats(scope)
            out.append((scope, st.total_sessions, st.active_sessions, st.failed_sessions,
                        st.consensus_reached))
        out.append(("host_spilled", self.engine.occupancy()["host_spilled"]))
        return out


def proposal_traffic(run, data):
    """Phase 8's deliveries on one engine: (a) one ingest_proposals call,
    (b) two deliver_proposals waves, (c) the final chains redelivered.
    Returns the statuses and events of each stage, the final state, and
    per stage its kernel launches, signatures submitted and device batches
    (each batch's phase seconds)."""
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.wire import Proposal

    engine = run.engine
    scheme = type(engine.signer())
    submitted = getattr(scheme, "submitted", None)
    batches = getattr(scheme, "batches", None)
    log, stages = [], []

    def stage(fn, payload, now):
        items = [(scope, Proposal.decode(b)) for scope, b in payload]
        n0 = sum(submitted.values()) if submitted is not None else 0
        b0 = len(batches) if batches is not None else 0
        _build.launches.clear()
        out = fn(items, now)
        stages.append(dict(
            launches=dict(_build.launches),
            verified=sum(submitted.values()) - n0 if submitted is not None else None,
            batches=batches[b0:] if batches is not None else None,
        ))
        log.append(out)
        log.append(run.events())

    stage(engine.ingest_proposals, data["a"], NOW + 100)
    for w, wave in enumerate(data["b"]):
        stage(engine.deliver_proposals, wave, NOW + 101 + w)
    stage(engine.deliver_proposals, data["c"], NOW + 103)
    return log, run.state(data["chain_pids"]), stages


def stub_chains(n_votes, distinct):
    """``distinct`` stub-signed chains of ``n_votes`` votes, every signer
    voting twice (the second time with a parent link), one in four with a
    broken received link and one in four with an unknown parent."""
    from hashgraph_tpu_torch import CreateProposalRequest, StubConsensusSigner, build_vote

    rng = random.Random(85 + n_votes)
    chains = []
    for c in range(distinct):
        p = CreateProposalRequest(f"c{c}", b"", b"o", n_votes, 3600, True).into_proposal(
            NOW, pid=c + 1)
        signers = [StubConsensusSigner(b"s%d" % (i % max(n_votes // 2, 1)))
                   for i in range(n_votes)]
        for i in range(n_votes):
            p.votes.append(build_vote(p, rng.random() < 0.5, signers[i], NOW + 1 + i))
        if c % 4 == 1:
            p.votes[rng.randrange(1, n_votes)].received_hash = b"\x13" * 32
        elif c % 4 == 2:
            p.votes[rng.randrange(1, n_votes)].parent_hash = b"\x42" * 32
        chains.append(p.votes)
    return chains


def chain_check(dev, chains, n_chains):
    """The chain check alone on ``chains``, tiled to ``n_chains`` and packed
    on the card: statuses against the same function on the CPU and, chain
    by chain, against the scalar oracle. Returns the shape and the
    statuses."""
    from hashgraph_tpu_torch.convert import chain_pack_from_numpy
    from hashgraph_tpu_torch.errors import ConsensusError
    from hashgraph_tpu_torch.ops.chain import (
        CHAIN_FIELDS,
        chain_kernel_batch,
        first_chain_error,
        pack_chains,
    )
    from hashgraph_tpu_torch.protocol import validate_vote_chain

    codes = []
    for votes in chains:
        try:
            validate_vote_chain(votes)
            codes.append(0)
        except ConsensusError as exc:
            codes.append(int(exc.code))
    packed = pack_chains(chains)
    reps = -(-n_chains // len(chains))
    gpu = chain_pack_from_numpy(
        {k: np.concatenate([a] * reps)[:n_chains] for k, a in packed.items()}, dev)
    args = [gpu[k] for k in CHAIN_FIELDS]
    shape = list(args[0].shape[:2])
    statuses = chain_kernel_batch(*args)
    plain = chain_kernel_batch(*(a.cpu() for a in args))
    if not torch.equal(statuses.cpu(), plain):
        raise AssertionError(f"chain check at {shape}: the card differs from the CPU")
    got = [first_chain_error(s) for s in plain[:len(chains)].numpy()]
    if got != codes or (len(chains) >= 4 and (not any(codes) or all(codes))):
        raise AssertionError(f"chain check at {shape}: {got}, oracle {codes}")
    return shape, got


def phase_proposals(dev):
    from hashgraph_tpu_torch.convert import chain_pack_from_numpy
    from hashgraph_tpu_torch.errors import StatusCode
    from hashgraph_tpu_torch.ops.chain import CHAIN_FIELDS, chain_kernel_batch, pack_chains
    from hashgraph_tpu_torch.signing import (
        Ed25519ConsensusSigner,
        Ed25519DeviceConsensusSigner,
    )
    from hashgraph_tpu_torch.wire import Proposal

    data = proposal_traffic_data()
    rng = random.Random(86)
    on = ProposalRun(proposal_engine(dev, counting_device_signer()(rng.randbytes(32)),
                                     "default"))
    off = ProposalRun(proposal_engine(dev, counting_device_signer()(rng.randbytes(32)), None))
    cpu = ProposalRun(proposal_engine("cpu", Ed25519ConsensusSigner(rng.randbytes(32)),
                                      "default"))
    # Warm the pipeline (allocator, first launches at (a)'s lane buckets)
    # and the chain check outside the engines, which keep their caches cold.
    warm = [v for _, p in data["a"] for v in Proposal.decode(p).votes]
    Ed25519DeviceConsensusSigner.verify_batch(
        [v.vote_owner for v in warm], [v.signing_payload() for v in warm],
        [v.signature for v in warm])
    packed = chain_pack_from_numpy(pack_chains([warm[:PROP_FIRST]]), dev)
    chain_kernel_batch(*(packed[k] for k in CHAIN_FIELDS)).cpu()
    captured = KernelInputs()
    with captured.active():
        on_log, on_state, on_stages = proposal_traffic(on, data)
        off_log, off_state, off_stages = proposal_traffic(off, data)
    cpu_log, cpu_state, _ = proposal_traffic(cpu, data)
    compare("proposal statuses and events", on_log, cpu_log)
    compare("proposal sessions, votes and stats", on_state, cpu_state)
    compare("proposal statuses and events, cache off", off_log, on_log)
    compare("proposal sessions, votes and stats, cache off", off_state, on_state)

    a, b1, b2, c = on_stages
    if on_log[0] != data["expected_a"]:
        raise AssertionError(f"(a) statuses {on_log[0]}, expected {data['expected_a']}")
    never = [k for k in VERIFY_KERNELS if not a["launches"].get(k)]
    if never:
        raise AssertionError(f"(a) launches {a['launches']}: kernels never launched {never}")
    # (a) is one device batch. A wave of (b) is one with the cache on; with
    # it off, one for the known chains' suffixes and one per run of chains
    # the engine does not hold (those rejected in (a) arrive whole, between
    # known ones). Every signature that reaches the MSM is valid (the
    # damaged ones stop at the s < L check and at decompression), so no
    # batch on either GPU engine may fall back to the host blame: the
    # kernels' own verdict is the one the engines used, one MSM a batch.
    for label, stages in (("cache on", on_stages), ("cache off", off_stages)):
        for name, st in zip(("a", "b1", "b2"), stages):
            n = len(st["batches"])
            one = name == "a" or label == "cache on"
            if not n or (one and n != 1) or st["launches"].get("msm_windows") != n:
                raise AssertionError(f"({name}, {label}): {n} device batches, launches "
                                     f"{st['launches']}")
            for batch in st["batches"]:
                if batch["fallback"] != 0.0 or not batch["msm"] > 0.0:
                    raise AssertionError(f"({name}, {label}): batch {batch} fell back to the "
                                         "host blame or ran no MSM")
    held = hold_captured(captured)
    if set(held) != set(VERIFY_KERNELS) or min(x[0] for x in held["msm_windows"]) > 128:
        raise AssertionError(f"kernel inputs captured on the path: {held}")
    if set(on_log[6]) != {int(StatusCode.PROPOSAL_ALREADY_EXIST)}:
        raise AssertionError(f"(c) statuses {set(on_log[6])}")
    if any(c["launches"].get(k) for k in PROPOSAL_KERNELS) or c["verified"] or c["batches"]:
        raise AssertionError(f"(c) launched {c['launches']}, verified {c['verified']}")
    on_counts = type(on.engine.signer()).submitted
    off_counts = type(off.engine.signer()).submitted
    if max(on_counts.values()) != 1 or set(on_counts) != set(off_counts):
        raise AssertionError("with the cache on a vote was verified twice, or the two "
                             "engines verified different votes")
    decided_pid = data["chain_pids"][-1][1]
    if ("gossip", "ConsensusReached", decided_pid, True, NOW + 100) not in on_log[1]:
        raise AssertionError("the proposal decided on arrival emitted no ConsensusReached")
    results = [r for _, _, r, _ in on_state[:PROP_MAIN]]
    decided = sum(r is True or r is False for r in results)
    if decided < PROP_MAIN // 2 or on_state[-1] != ("host_spilled", 1):
        raise AssertionError(f"{decided} of {PROP_MAIN} decided; {on_state[-1]}")

    # (e): the chain check alone, at (a)'s chains (the items (a) does not
    # leave out, as ingest_proposals packs them), at [1,024, 64] and at one
    # 1,024-vote chain.
    a_items = [Proposal.decode(b) for _, b in data["a"]]
    a_chains = [p.votes for p in a_items if NOW + 100 < p.expiration_timestamp and len(p.votes) > 1]
    for label, chain_votes, n_chains in (("(a)'s chains", a_chains, len(a_chains)),
                                         ("stub chains", stub_chains(64, 16), 1024),
                                         ("one stub chain", stub_chains(1024, 1), 1)):
        shape, codes = chain_check(dev, chain_votes, n_chains)
        log(f"[proposals] (e) chain check at {shape} ({label}): statuses equal to the CPU's "
            f"and the oracle's {sorted(set(codes))}")

    launches = {}
    for s in on_stages:
        for k, n in s["launches"].items():
            launches[k] = launches.get(k, 0) + n
    b_votes = [sum(data["lengths"][w][k] - data["lengths"][w - 1][k] for k in range(PROP_MAIN))
               for w in (1, 2)]
    codes_a = {StatusCode(x).name: on_log[0].count(x) for x in sorted(set(on_log[0]))}
    codes_b = [{StatusCode(x).name: st.count(x) for x in sorted(set(st))}
               for st in (on_log[2], on_log[4])]
    log(f"[proposals] senders: {PROP_MAIN} proposals x {PROP_VOTERS} voters ({PROP_KEYS} "
        f"Ed25519 keys), {data['signed']} votes built and signed with the native runtime; "
        f"chain lengths after (a), (b1), (b2): {[sum(x) for x in data['lengths']]} votes in all")
    log(f"[proposals] (a) one ingest_proposals call of {len(data['a'])} proposals: "
        f"{a['verified']} signatures in one device batch; launches "
        f"{json.dumps(a['launches'])}; statuses {codes_a}")
    for w, (s, votes, codes) in enumerate(zip((b1, b2), b_votes, codes_b)):
        log(f"[proposals] (b{w + 1}) deliver_proposals of {PROP_MAIN} chains adding "
            f"{votes} votes: {s['verified']} signatures verified in one batch; launches "
            f"{json.dumps(s['launches'])}; statuses {codes}")
    log(f"[proposals] (c) {len(data['c'])} full chains redelivered: all "
        f"PROPOSAL_ALREADY_EXIST, launches {json.dumps(c['launches'])}, signatures verified "
        f"{c['verified']}")
    log(f"[proposals] (d) cache off: the same statuses, events, sessions and votes; "
        f"{sum(off_counts.values())} signatures verified against {sum(on_counts.values())} "
        f"unique with the cache on (each once); batches of (b1) and (b2) "
        f"{[[x['items'] for x in s['batches']] for s in off_stages[1:3]]}")
    log(f"[proposals] every device batch of (a) and (b) on both GPU engines "
        f"({len(a['batches']) + len(b1['batches']) + len(b2['batches'])} and "
        f"{sum(len(st['batches']) for st in off_stages)}) ran the MSM "
        f"and none fell back to the host blame; each kernel held against its plain version "
        f"on the inputs the path gave it (both GPU engines), at {json.dumps(held)}; the MSM kernels "
        f"also rejecting with lane 0's last window changed")
    log(f"[proposals] CPU engine (native batch verification): identical statuses, events, "
        f"results, votes, scope stats and spill count; {decided} of {PROP_MAIN} main "
        f"sessions decided; launches over (a)-(c) {json.dumps(launches)}")
    return dict(launches=launches)


# ── Phase 9: the service layer (ConsensusService over TorchBackedStorage) ──

# BASELINE config 1's backlog, cut from the README's 1,000 scopes so that two
# services' host ECDSA checks fit the run (on the H100 machine the phase took
# 155 s at 128 scopes and 61-64 s at 64; it is held under 60 s); the voters
# and the retention are the README's.
SERVICE_SCOPES = 48
SERVICE_PROPOSALS = 11  # per scope; the 11th evicts the oldest (retention 10)
SERVICE_VOTERS = 64
SERVICE_VOTES = 48  # votes a proposal, 70% YES
SERVICE_WIDE = 8  # scopes that also take one proposal wider than voter_capacity
SERVICE_WIDE_VOTERS = 100
SERVICE_WIDE_VOTES = 70
SERVICE_KEYS = 70  # the first 64 vote on the pooled proposals, all 70 on the wide
SERVICE_EXPIRY = 600  # seconds from a proposal's creation
SERVICE_CAPACITY = 4096
SERVICE_VOTER_CAPACITY = 64


def backlog_plan(seed, scopes=SERVICE_SCOPES, proposals=SERVICE_PROPOSALS,
                 voters=SERVICE_VOTERS, votes=SERVICE_VOTES, wide=SERVICE_WIDE,
                 wide_voters=SERVICE_WIDE_VOTERS, wide_votes=SERVICE_WIDE_VOTES,
                 keys=SERVICE_KEYS):
    """Phase 9's traffic as plain data, the same for any package.

    Half the scopes take the Gossipsub preset and half the P2P one, with
    thresholds 2/3, 0.75 and 1.0 and both liveness settings in turn. Each
    scope takes ``proposals`` proposals of ``voters`` expected voters, one a
    second, and ``wide`` scopes spread over the range one more of
    ``wide_voters``. A proposal takes ``votes`` (``wide_votes``) votes from
    distinct keys, 70% YES. The stream: half of the first proposals' votes
    in one seeded shuffle across scopes; then the last proposal of every
    scope and the wide ones are created (each evicting its scope's oldest);
    then the rest, shuffled. 1% of the votes are delivered again later and
    2% arrive one second after their session's expiry. Then every session
    still active times out at its expiry + 1."""
    rng = random.Random(seed)
    scope_list = [dict(name=f"scope{j:04d}", p2p=j >= scopes // 2,
                       threshold=(2 / 3, 0.75, 1.0)[j % 3], liveness=(j // 3) % 2 == 0)
                  for j in range(scopes)]
    # (scope index, expected voters, created_at, created mid-stream)
    props = [(j, voters, NOW + i, i == proposals - 1)
             for j in range(scopes) for i in range(proposals)]
    props += [(j * scopes // wide, wide_voters, NOW + proposals, True) for j in range(wide)]
    vote_list = []  # (proposal index, key index, choice, timestamp)
    for p, (_, n, created, _) in enumerate(props):
        count = votes if n == voters else wide_votes
        for k in rng.sample(range(min(keys, n)), count):
            vote_list.append((p, k, rng.random() < 0.7, created + 1 + rng.randrange(60)))
    early = [i for i, v in enumerate(vote_list) if not props[v[0]][3]]
    rng.shuffle(early)
    half = len(early) // 2
    rest = early[half:] + [i for i, v in enumerate(vote_list) if props[v[0]][3]]
    rng.shuffle(rest)
    late = set(rng.sample(range(len(vote_list)), len(vote_list) * 2 // 100))
    stream = [("vote", i) for i in early[:half]]
    stream += [("create", p) for p, prop in enumerate(props) if prop[3]]
    stream += [("vote", i) for i in rest]
    # A redelivery goes at a seeded place after the vote's first delivery.
    at = {item: k for k, item in enumerate(stream)}
    keyed = [((k, 0), item) for k, item in enumerate(stream)]
    for i in rng.sample(range(len(vote_list)), len(vote_list) // 100):
        keyed.append(((rng.randrange(at[("vote", i)], len(stream)), 1), ("vote", i)))
    stream = [item for _, item in sorted(keyed)]
    deliveries = []
    for kind, i in stream:
        if kind == "create":
            deliveries.append((kind, i, props[i][2]))
        else:
            p, _, _, ts = vote_list[i]
            now = props[p][2] + SERVICE_EXPIRY + 1 if i in late else ts
            deliveries.append((kind, i, now))
    return dict(scopes=scope_list, props=props, votes=vote_list, stream=deliveries,
                first=[p for p, prop in enumerate(props) if not prop[3]])


def backlog_request(ht, plan, p):
    scope = plan["scopes"][plan["props"][p][0]]
    return ht.CreateProposalRequest(
        name=f"{scope['name']}-p{p}", payload=p.to_bytes(4, "little"),
        proposal_owner=b"backlog", expected_voters_count=plan["props"][p][1],
        expiration_timestamp=SERVICE_EXPIRY, liveness_criteria_yes=scope["liveness"])


def backlog_service(ht, storage, signer):
    """A service over ``storage`` whose event bus keeps a whole run's events."""
    return ht.ConsensusService(storage, ht.BroadcastEventBus(max_queued_events=1_000_000),
                               signer)


def configure_scopes(service, plan):
    for scope in plan["scopes"]:
        builder = service.scope(scope["name"])
        builder = builder.p2p_preset() if scope["p2p"] else builder.gossipsub_preset()
        builder.with_threshold(scope["threshold"]).initialize()


class BacklogIds:
    """Proposal ids minted from the plan's seed, the same in every run."""

    def __init__(self, ht, seed):
        self.ht, self.rng = ht, random.Random(seed)

    def __enter__(self):
        self.ht.protocol.set_id_entropy(lambda: self.rng.getrandbits(128))

    def __exit__(self, *exc):
        self.ht.protocol.set_id_entropy(None)


def backlog_proposals(ht, plan, seed):
    """The proposals the plan's creations give under its seed (a dry run on
    an in-memory service): what the voters build their votes on."""
    service = backlog_service(ht, ht.InMemoryConsensusStorage(), ht.StubConsensusSigner(b"dry"))
    configure_scopes(service, plan)
    out = {}
    with BacklogIds(ht, seed):
        order = plan["first"] + [i for kind, i, _ in plan["stream"] if kind == "create"]
        for p in order:
            scope = plan["scopes"][plan["props"][p][0]]["name"]
            out[p] = service.create_proposal(scope, backlog_request(ht, plan, p),
                                             plan["props"][p][2])
    return out


def backlog_votes(ht, plan, proposals, keys, sign):
    """Every vote of the plan as wire bytes: built unsigned on its
    proposal (no chain: the service checks none), then signed by
    ``sign([(key index, payload), ...])`` all at once."""
    built = [ht.build_vote(proposals[p], choice, _Unsigned(keys[k]), ts)
             for p, k, choice, ts in plan["votes"]]
    sigs = sign([(k, v.signing_payload()) for (_, k, _, _), v in zip(plan["votes"], built)])
    for vote, sig in zip(built, sigs):
        vote.signature = sig
    return [v.encode() for v in built]


def outcome_of(fn):
    """A call's return value, or its exception's type name."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - compared across services
        return type(exc).__name__


def drive_backlog(ht, service, plan, wire, seed, clock=time.perf_counter):
    """Drive the plan through ``service``: the first proposals, the stream,
    then the timeouts. Returns the outcome of every call in order, each
    ``process_incoming_vote`` call's seconds, and each proposal's id."""
    configure_scopes(service, plan)
    votes = [ht.Vote.decode(b) for b in wire]
    outcomes, seconds, pids = [], [], {}
    with BacklogIds(ht, seed):
        for p in plan["first"]:
            scope = plan["scopes"][plan["props"][p][0]]["name"]
            pids[p] = service.create_proposal(scope, backlog_request(ht, plan, p),
                                              plan["props"][p][2]).proposal_id
        for kind, i, now in plan["stream"]:
            if kind == "create":
                scope = plan["scopes"][plan["props"][i][0]]["name"]
                pids[i] = service.create_proposal(scope, backlog_request(ht, plan, i),
                                                  now).proposal_id
                outcomes.append(("create", pids[i]))
                continue
            scope = plan["scopes"][plan["props"][plan["votes"][i][0]][0]]["name"]
            vote = votes[i]
            t = clock()
            result = outcome_of(lambda: service.process_incoming_vote(scope, vote, now))
            seconds.append(clock() - t)
            outcomes.append(("vote", i, result))
    for p in sorted(pids, key=lambda p: (plan["props"][p][0], p)):
        scope = plan["scopes"][plan["props"][p][0]]["name"]
        session = service.storage().get_session(scope, pids[p])
        if session is not None and session.is_active():
            outcomes.append(("timeout", p, outcome_of(lambda: service.handle_consensus_timeout(
                scope, pids[p], session.proposal.expiration_timestamp + 1))))
    return outcomes, seconds, pids


def backlog_state(service, plan, pids, events):
    """What a run leaves: the events per scope (from a receiver subscribed
    before it), each scope's stats and each proposal's result."""
    by_scope = {}
    while (item := events.try_recv()) is not None:
        scope, ev = item
        by_scope.setdefault(scope, []).append(
            (type(ev).__name__, ev.proposal_id, getattr(ev, "result", None), ev.timestamp))
    stats = {}
    for scope in plan["scopes"]:
        st = service.get_scope_stats(scope["name"])
        stats[scope["name"]] = (st.total_sessions, st.active_sessions, st.failed_sessions,
                                st.consensus_reached)
    results = [(p, outcome_of(lambda: service.storage().get_consensus_result(
        plan["scopes"][plan["props"][p][0]]["name"], pids[p]))) for p in sorted(pids)]
    return by_scope, stats, results


def native_eth_sign(jobs):
    """Ethereum signatures of ``[(private key, payload), ...]`` from the
    native runtime, on 8 threads: its calls release the GIL (8 spawned
    processes spent most of 15 s starting up for 68,144 signatures)."""
    from concurrent.futures import ThreadPoolExecutor

    from hashgraph_tpu_torch import native

    with ThreadPoolExecutor(8) as pool:
        sigs = list(pool.map(lambda job: native.eth_sign(*job), jobs, chunksize=256))
    if any(sig is None for sig in sigs):
        raise AssertionError("the native runtime did not sign")
    return sigs


def expected_rows(storage, memory_storage):
    """For each pooled session of ``storage``: its row read back from the
    card, and the row ``allocate_slot`` + ``load_session_rows`` build from
    the in-memory service's session in a fresh CPU pool."""
    from hashgraph_tpu_torch.convert import DEVICE_ARRAYS, pool_to_numpy
    from hashgraph_tpu_torch.engine import ProposalPool
    from hashgraph_tpu_torch.engine.session_sync import allocate_slot, load_session_rows

    arrays, _ = pool_to_numpy(storage.pool())
    for (scope, pid), slot in sorted(storage._slots.items()):
        session = memory_storage.get_session(scope, pid)
        fresh = ProposalPool(1, storage.pool().voter_capacity, device="cpu")
        row = allocate_slot(fresh, (scope, pid), session.proposal, session.config,
                            session.created_at)
        if not load_session_rows(fresh, row, session):
            raise AssertionError(f"session {(scope, pid)} is pooled but too wide to load")
        want, _ = pool_to_numpy(fresh)
        for name in DEVICE_ARRAYS:
            yield (scope, pid), name, arrays[name][slot], want[name][row]


def phase_service(dev):
    import hashgraph_tpu_torch as ht
    from hashgraph_tpu_torch import _build, native
    from hashgraph_tpu_torch.convert import DEVICE_ARRAYS
    from hashgraph_tpu_torch.ops.decide import STATE_REACHED_YES

    # (a) The README quick-start through the port: three peers share one
    # storage on the card and one event bus.
    storage = ht.TorchBackedStorage(device=dev)
    bus = ht.BroadcastEventBus()
    rng = random.Random(90)
    peers = [ht.ConsensusService(storage, bus, ht.EthereumConsensusSigner(rng.randbytes(32)))
             for _ in range(3)]
    rx = bus.subscribe()
    proposal = peers[0].create_proposal("deployments", ht.CreateProposalRequest(
        name="ship-v2", payload=b"git:abc123", proposal_owner=peers[0].signer().identity(),
        expected_voters_count=3, expiration_timestamp=60, liveness_criteria_yes=True), NOW)
    pid = proposal.proposal_id
    peers[0].cast_vote("deployments", pid, True, NOW)
    if rx.try_recv() is not None:
        raise AssertionError("quick-start: an event after the first vote")
    peers[1].cast_vote("deployments", pid, True, NOW)
    reached = rx.try_recv()
    if reached is None or reached[1] != ht.ConsensusReached(pid, True, NOW):
        raise AssertionError(f"quick-start: {reached} after the second YES")
    late = ht.build_vote(storage.get_proposal("deployments", pid), False, peers[2].signer(), NOW)
    peers[0].process_incoming_vote("deployments", late, NOW)
    if (storage.get_consensus_result("deployments", pid) is not True
            or storage.device_state_of("deployments", pid) != STATE_REACHED_YES
            or storage.pool().device.type != torch.device(dev).type):
        raise AssertionError("quick-start: the late NO changed the result, or the card's "
                             "row is not REACHED_YES")
    log("[service] (a) quick-start: 3 Ethereum-signed peers over one TorchBackedStorage on "
        f"the card: ConsensusReached(result=True) after the second YES, the late NO a no-op, "
        f"device state REACHED_YES")

    # (b) The backlog.
    plan = backlog_plan(91)
    keys = [ht.EthereumConsensusSigner(rng.randbytes(32)) for _ in range(SERVICE_KEYS)]
    proposals = backlog_proposals(ht, plan, 92)
    wire = backlog_votes(ht, plan, proposals, keys, lambda jobs: native_eth_sign(
        [(keys[k].private_key_bytes(), payload) for k, payload in jobs]))
    signer_seed = rng.randbytes(32)

    def run(storage):
        """One service over ``storage`` takes the plan."""
        service = backlog_service(ht, storage, ht.EthereumConsensusSigner(signer_seed))
        events = service.event_bus().subscribe()
        outcomes, _, pids = drive_backlog(ht, service, plan, wire, 92)
        return dict(outcomes=outcomes, pids=pids,
                    state=backlog_state(service, plan, pids, events))

    card_storage = ht.TorchBackedStorage(SERVICE_CAPACITY, SERVICE_VOTER_CAPACITY, device=dev)
    if any(getattr(card_storage.pool(), attr).device.type != torch.device(dev).type
           for attr, _ in DEVICE_ARRAYS.values()):
        raise AssertionError("the storage's pool tensors are not on the card")
    memory_storage = ht.InMemoryConsensusStorage()
    _build.launches.clear()
    card = run(card_storage)
    card_launches = dict(_build.launches)
    memory = run(memory_storage)
    compare("service outcomes", card["outcomes"], memory["outcomes"])
    compare("service events per scope", card["state"][0], memory["state"][0])
    compare("service scope stats", card["state"][1], memory["state"][1])
    compare("service results", card["state"][2], memory["state"][2])
    if card["pids"] != memory["pids"]:
        raise AssertionError("the two services minted different proposal ids")
    if card_launches:
        raise AssertionError(f"the service path launched hand kernels: {card_launches}")
    rows = 0
    for key, name, got, want in expected_rows(card_storage, memory_storage):
        if not np.array_equal(got, want):
            raise AssertionError(f"session {key}: the card's {name} row {got} differs from "
                                 f"the row built from the in-memory session {want}")
        rows += name == "state"
    wide_keys = [(plan["scopes"][plan["props"][p][0]]["name"], card["pids"][p])
                 for p, prop in enumerate(plan["props"]) if prop[1] > SERVICE_VOTER_CAPACITY]
    wide_live = [k for k in wide_keys if card_storage.get_session(*k) is not None]
    if not wide_live or any(card_storage.device_state_of(*k) is not None for k in wide_live):
        raise AssertionError(f"host-only sessions: {len(wide_live)} live, some pooled")

    # The native eth_verify accepts every vote the services verified (all
    # but those for evicted sessions).
    decoded = [ht.Vote.decode(b) for b in wire]
    verified = [decoded[o[1]] for o in card["outcomes"]
                if o[0] == "vote" and o[2] != "SessionNotFound"]
    codes = [native.eth_verify(v.vote_owner, v.signing_payload(), v.signature) for v in verified]
    if set(codes) != {1}:
        raise AssertionError(f"eth_verify rejected a signed vote: {sorted(set(codes))}")

    kinds = {}
    for o in card["outcomes"]:
        label = o[0] if o[0] == "create" else f"{o[0]}:{o[2]}"
        kinds[label] = kinds.get(label, 0) + 1
    log(f"[service] (b) {SERVICE_SCOPES} scopes x {SERVICE_PROPOSALS} proposals x "
        f"{SERVICE_VOTERS} voters ({SERVICE_VOTES} votes each) + {SERVICE_WIDE} of "
        f"{SERVICE_WIDE_VOTERS} voters ({SERVICE_WIDE_VOTES} votes, host-only), "
        f"{SERVICE_KEYS} Ethereum keys: {len(wire)} votes signed by the native runtime on 8 "
        f"threads; outcomes {json.dumps(kinds, sort_keys=True)}; "
        f"identical outcomes, events, stats and results on both services; {rows} pooled rows "
        f"equal to the rows built from the in-memory sessions; {len(wide_live)} host-only "
        f"sessions; hand-kernel launches {card_launches}")


# ── Phase 10: the wire path and the write-ahead log ─────────────────

# (a): config 3 over wire bytes. (b): 16 scopes of config 3's voters.
# Both cut in depth to fit the phase's 60 s: (a) from config 3's 10,000
# proposals to 2,000 and (b) from 625 proposals a scope to 125 (at full
# depth the phase took 204.093 s on the H100, (a) 128.956 of it); the
# voters (64), the waves (four of 16 votes a proposal, one redelivered)
# and the scopes (16) are config 3's and the issue's.
WAL_PROPOSALS = 2_000  # half gossipsub, half P2P
WAL_VOTERS = 64
WAL_WAVES = 4  # of WAL_PER_WAVE votes a proposal; wave 2 is redelivered after
WAL_PER_WAVE = 16
MULTI_SCOPES = 16
MULTI_PROPOSALS = 125  # a scope
MULTI_DELETED = 2  # scopes deleted after the second wave
MULTI_SHORT = 4  # scopes whose proposals expire before the mid-run sweep
# (b)'s odd scopes take the P2P preset, the even ones the gossipsub default.
WAL_DIR = Path(__file__).resolve().parent / "_chip_smoke_wal"
# The sizes the crashing child takes from its parent.
WAL_SIZES = ("WAL_PROPOSALS", "CAPACITY", "VOTER_CAPACITY")
CHILD_EXIT = 41  # the crashed child's exit code


@contextlib.contextmanager
def seeded_ids(seed):
    """Seeded proposal and vote ids (``protocol.set_id_entropy`` and the
    batch id draw's ``os.urandom``), so engines in two processes mint the
    same bytes."""
    import os

    from hashgraph_tpu_torch import protocol

    ids, draws = random.Random(seed), random.Random(seed + 1_000_003)
    saved = os.urandom
    protocol.set_id_entropy(lambda: ids.getrandbits(128))
    os.urandom = draws.randbytes
    try:
        yield
    finally:
        os.urandom = saved
        protocol.set_id_entropy(None)


def wire_waves(pids, seed, scope_of=None):
    """Stub-signed votes on ``pids`` as wire bytes: WAL_WAVES waves of
    WAL_PER_WAVE votes a proposal, interleaved across proposals (vote j of
    every proposal, then vote j + 1), each vote chained onto the
    proposal's previous one; voter ``16 w + j`` casts vote j of wave w, 60%
    YES. Returns per wave (rows, scope index per row, pid and owner per
    row, values)."""
    from hashgraph_tpu_torch import StubConsensusSigner, compute_vote_hash
    from hashgraph_tpu_torch.wire import Vote

    rng = np.random.default_rng(seed)
    signers = [StubConsensusSigner(b"voter-%d" % i) for i in range(WAL_VOTERS)]
    owners = [s.identity() for s in signers]
    n = len(pids)
    pid_list = [int(p) for p in pids]
    sidx = [0] * n if scope_of is None else list(scope_of)
    tail = [b""] * n
    vote_id = 1
    waves = []
    for w in range(WAL_WAVES):
        yes = rng.random((WAL_PER_WAVE, n)) < 0.6
        rows, row_sidx, row_pid, row_owner, values = [], [], [], [], []
        for j in range(WAL_PER_WAVE):
            v = WAL_PER_WAVE * w + j
            signer, owner = signers[v], owners[v]
            for k in range(n):
                vote = Vote(vote_id=vote_id, vote_owner=owner, proposal_id=pid_list[k],
                            timestamp=NOW + 1 + w, vote=bool(yes[j, k]),
                            parent_hash=b"", received_hash=tail[k])
                vote_id += 1
                vote.vote_hash = compute_vote_hash(vote)
                vote.signature = signer.sign(vote.encode())
                tail[k] = vote.vote_hash
                rows.append(vote.encode())
                row_sidx.append(sidx[k])
                row_pid.append(pid_list[k])
                row_owner.append(v)
                values.append(vote.vote)
        waves.append((rows, np.asarray(row_sidx, np.int64), np.asarray(row_pid, np.int64),
                      np.asarray(row_owner, np.int64), np.asarray(values, bool)))
    waves.append(waves[2])  # redelivery
    return waves


_FRAMES: dict = {}


def config3_frames(pids, seed=102):
    """:func:`wire_waves` over ``pids`` parsed into frames, built once a
    run: phase 10 (a) and phase 12 (e) take the same waves."""
    key = (np.asarray(pids, np.int64).tobytes(), seed)
    if key not in _FRAMES:
        _FRAMES[key] = [parse_frame(w[0]) for w in wire_waves(pids, seed)]
    return _FRAMES[key]


def parse_frame(rows):
    """Encoded votes as one parsed frame (data, offsets, cols), with the
    native parser (the pure-Python twin is refused here)."""
    from hashgraph_tpu_torch import native
    from hashgraph_tpu_torch.bridge import columnar

    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offsets[1:])
    data = np.frombuffer(b"".join(rows), np.uint8)
    out = native.parse_vote_columns(data, offsets)
    if out is None:
        raise AssertionError("the native vote-column parser did not run")
    cols, flags = out
    if not flags.all() or not np.array_equal(
            cols, columnar.parse_vote_columns(data, offsets)[0]):
        raise AssertionError("a wire row is not canonical, or the parser's dispatch differs")
    return data, offsets, cols


def wal_engine(dev):
    from hashgraph_tpu_torch import StubConsensusSigner, TorchConsensusEngine
    from hashgraph_tpu_torch.events import BroadcastEventBus

    return TorchConsensusEngine(
        StubConsensusSigner(b"chip-smoke"), CAPACITY, VOTER_CAPACITY,
        event_bus=BroadcastEventBus(max_queued_events=10_000_000),
        max_sessions_per_scope=CAPACITY, device=dev, verify_cache=None,
    )


def config3_proposals(engine):
    """Config 3's proposals on ``engine`` (bare or durable), seeded: the
    first half gossipsub, the second P2P."""
    from hashgraph_tpu_torch import ConsensusConfig

    reqs = requests(WAL_PROPOSALS, WAL_VOTERS, 3600, lambda i: i % 4 < 2)
    half = WAL_PROPOSALS // 2
    pids = []
    with seeded_ids(101):
        for part, config in ((reqs[:half], ConsensusConfig.gossipsub()),
                             (reqs[half:], ConsensusConfig.p2p())):
            pids += [p.proposal_id for p in engine.create_proposals("config3", part, NOW, config)]
    return np.asarray(pids, np.int64)


def config3_wire(engine, frames):
    """The waves through ``ingest_wire_columnar``: each call's statuses."""
    return [engine.ingest_wire_columnar(["config3"], np.zeros(len(cols), np.int64), cols,
                                        data, offsets, NOW + 1 + w).tolist()
            for w, (data, offsets, cols) in enumerate(frames)]


def sync_of(dev):
    """``torch.cuda.synchronize`` on the card, nothing on the CPU."""
    return torch.cuda.synchronize if torch.device(dev).type == "cuda" else (lambda: None)


def wal_child(root, dev, sizes):
    """Phase 10 (a)'s crashing node: a GPU engine under a durable wrapper
    with ``fsync_policy="always"`` takes config 3's proposals and waves,
    writes what it acknowledged and its launch counts, and dies with
    ``os._exit`` after its last acknowledged call. ``sizes`` carries the
    parent's sizes (``WAL_SIZES``)."""
    import os

    globals().update(sizes)
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.tracing import tracer
    from hashgraph_tpu_torch.wal import DurableEngine

    root = Path(root)
    tracer.enable()  # the writer's wal.* counts, reported below
    durable = DurableEngine(wal_engine(dev), root / "crashed", fsync_policy="always")
    pids = config3_proposals(durable)
    frames = [parse_frame(w[0]) for w in wire_waves(pids, 102)]
    sync_of(dev)()
    _build.launches.clear()
    statuses = config3_wire(durable, frames)
    (root / "child.json").write_text(json.dumps(dict(
        statuses=statuses, launches=dict(_build.launches),
        stats={k: v for k, v in tracer.counters().items() if k.startswith("wal.")})))
    os._exit(CHILD_EXIT)


def wal_snapshot(engine):
    """``save_to_storage`` into an InMemoryConsensusStorage, as comparable
    data: per scope its config and, per proposal id, the session's state
    (active, reached, result) and the rest (proposal bytes, signed votes,
    tallies, created_at and config)."""
    from hashgraph_tpu_torch import InMemoryConsensusStorage
    from hashgraph_tpu_torch.wal import format as F

    storage = InMemoryConsensusStorage()
    engine.save_to_storage(storage)
    out = {}
    for scope in storage.list_scopes() or []:
        config = storage.get_scope_config(scope)
        out[F.encode_scope(scope)] = (
            F.encode_scope_config(config) if config is not None else None,
            {s.proposal.proposal_id: (
                (s.state.is_active, s.state.is_reached,
                 s.state.result if s.state.is_reached else None),
                (s.proposal.encode(), tuple(sorted((k, v.encode()) for k, v in s.votes.items())),
                 tuple(sorted(s.tallies.items())), s.created_at,
                 F.encode_consensus_config(s.config)))
             for s in storage.list_scope_sessions(scope) or []})
    return out


def pooled_rows(engine):
    """Every pooled session's device row, keyed by (scope, proposal id),
    read back from the pool in one gather."""
    keys = sorted((k for k, slot in engine._index.items() if slot >= 0), key=repr)
    rows = engine.pool().read_slots([engine._index[k] for k in keys])
    return keys, rows


def compare_rows(label, a, b, lost=frozenset()):
    """``a``'s and ``b``'s pooled rows equal key by key, except the state of
    the keys in ``lost`` (see :func:`compare_recovered`)."""
    from hashgraph_tpu_torch.ops.decide import STATE_ACTIVE, STATE_FAILED

    keys_a, rows_a = pooled_rows(a)
    keys_b, rows_b = pooled_rows(b)
    if keys_a != keys_b:
        raise AssertionError(f"{label}: the pooled sessions differ")
    lost_rows = np.asarray([k in lost for k in keys_a], bool)
    for name in rows_a:
        x, y = rows_a[name], rows_b[name]
        if name == "state":
            if not (np.array_equal(x[~lost_rows], y[~lost_rows])
                    and (x[lost_rows] == STATE_ACTIVE).all()
                    and (y[lost_rows] == STATE_FAILED).all()):
                raise AssertionError(f"{label}: the pooled rows' states differ")
        elif not np.array_equal(x, y):
            raise AssertionError(f"{label}: the pooled rows' {name} differ")
    return len(keys_a)


def round_cap_failures(frames, statuses, scope=None, scopes=None):
    """(scope, proposal id) of every session that a row failed with
    MAX_ROUNDS_EXCEEDED in these calls: the columnar records log only
    accepted rows, so recovery does not see these failures (a fault of the
    JAX package's log that the port's byte-identical log keeps; ROADMAP
    queue 3)."""
    from hashgraph_tpu_torch.bridge.columnar import COL_PID
    from hashgraph_tpu_torch.errors import StatusCode

    out = set()
    for (pids, sidx), st in zip(frames, statuses):
        hit = np.asarray(st) == int(StatusCode.MAX_ROUNDS_EXCEEDED)
        for k in np.nonzero(hit)[0].tolist():
            out.add((scope if scopes is None else scopes[int(sidx[k])], int(pids[k])))
    return out


def compare_recovered(label, recovered, live, lost, rows=True):
    """A recovered engine against the engine that took the calls live:
    snapshots equal session by session, except that the sessions in
    ``lost`` (failed live by a MAX_ROUNDS_EXCEEDED row the log does not
    hold) are active after recovery with everything else equal; and, when
    ``rows`` (neither engine holds demoted sessions), the pooled rows
    likewise. Returns (sessions, rows) compared."""
    from hashgraph_tpu_torch.wal import format as F

    rec = wal_snapshot(recovered)
    ref = wal_snapshot(live)
    if rec.keys() != ref.keys():
        raise AssertionError(f"{label}: the scopes differ")
    lost_by_scope = {}
    for scope, pid in lost:
        lost_by_scope.setdefault(F.encode_scope(scope), set()).add(pid)
    n = 0
    for scope in ref:
        (cfg_a, sessions_a), (cfg_b, sessions_b) = rec[scope], ref[scope]
        if cfg_a != cfg_b or sessions_a.keys() != sessions_b.keys():
            raise AssertionError(f"{label}: scope {scope!r} differs")
        gone = lost_by_scope.get(scope, set())
        for pid, (state_b, rest_b) in sessions_b.items():
            state_a, rest_a = sessions_a[pid]
            want_a = (True, False, None) if pid in gone else state_b
            if rest_a != rest_b or state_a != want_a or (
                    pid in gone and state_b != (False, False, None)):
                raise AssertionError(f"{label}: session {pid} of scope {scope!r} differs")
            n += 1
    return n, compare_rows(label, recovered, live, lost) if rows else 0


def require_launches(label, counts, kernels, exact=None):
    """Fail unless every kernel of ``kernels`` launched in ``counts``, and
    each kernel of ``exact`` (name -> count) launched that many times."""
    never = [k for k in kernels if not counts.get(k)]
    wrong = {k: counts.get(k, 0) for k, n in (exact or {}).items() if counts.get(k, 0) != n}
    if never or wrong:
        raise AssertionError(f"{label}: launches {counts}; never launched {never}; "
                             f"launched other than {exact}: {wrong}")


def segment_files(path):
    return {p.name: p.read_bytes() for p in sorted(Path(path).glob("wal-*.seg"))}


def wal_recover(dev, path, storage=None):
    """A fresh GPU engine recovered from the log at ``path`` (and
    ``storage``), and the replay's stats. The durable wrapper stays open:
    the caller closes it."""
    from hashgraph_tpu_torch.wal import DurableEngine

    durable = DurableEngine(wal_engine(dev), path, fsync_policy="batch")
    return durable, durable.recover(storage)


def phase_wal_config3(dev, root):
    """(a): config 3 over wire bytes with a real crash, against a CPU
    engine; the same waves on a bare GPU engine and on durable ones at
    ``fsync_policy="batch"`` and ``"always"``."""
    import subprocess

    from hashgraph_tpu_torch import InMemoryConsensusStorage, _build
    from hashgraph_tpu_torch.bridge.columnar import COL_PID
    from hashgraph_tpu_torch.errors import StatusCode
    from hashgraph_tpu_torch.ops import cuda_ingest
    from hashgraph_tpu_torch.wal import DurableEngine
    from hashgraph_tpu_torch.wal.segment import list_segments

    child = subprocess.Popen(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(Path(__file__).resolve().parent)!r}); "
         f"import chip_smoke; chip_smoke.wal_child({str(root)!r}, {str(dev)!r}, "
         f"{ {name: globals()[name] for name in WAL_SIZES}!r})"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cpu = DurableEngine(wal_engine("cpu"), root / "cpu", fsync_policy="batch")
        pids = config3_proposals(cpu)
        frames = config3_frames(pids)
        out, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != CHILD_EXIT:
        raise AssertionError(f"the crashing child exited {child.returncode}: {err[-3000:]}")
    n_votes = sum(len(f[2]) for f in frames)
    cpu_st = config3_wire(cpu, frames)
    bare = wal_engine(dev)
    config3_proposals(bare)
    bare_st = config3_wire(bare, frames)
    del bare
    for policy in ("batch", "always"):
        durable = DurableEngine(wal_engine(dev), root / policy, fsync_policy=policy)
        config3_proposals(durable)
        st = config3_wire(durable, frames)
        durable.close()
        compare(f"(a) statuses, durable GPU engine ({policy})", st, cpu_st)
        del durable
    crashed = json.loads((root / "child.json").read_text())
    compare("(a) statuses, crashed GPU engine", crashed["statuses"], cpu_st)
    compare("(a) statuses, bare GPU engine", bare_st, cpu_st)
    flat = np.concatenate([np.asarray(s) for s in cpu_st])
    codes = {StatusCode(c).name: int((flat == c).sum()) for c in np.unique(flat)}
    if not {"OK", "DUPLICATE_VOTE", "ALREADY_REACHED"} <= set(codes):
        raise AssertionError(f"(a) did not reach the expected statuses: {codes}")
    require_launches("(a) the waves", crashed["launches"], [cuda_ingest.KERNEL])
    cpu.close()
    if not segment_files(root / "crashed") == segment_files(root / "cpu") == segment_files(
            root / "always"):
        raise AssertionError("(a) the GPU engines' logs differ from the CPU engine's")

    # Recovery of the crashed node into a fresh GPU engine.
    _build.launches.clear()
    rec, stats = wal_recover(dev, root / "crashed")
    replay_launches = dict(_build.launches)
    if stats.errors or stats.torn:
        raise AssertionError(f"(a) recovery: {stats}")
    require_launches("(a) the replay", replay_launches, [cuda_ingest.KERNEL])
    lost = round_cap_failures([(f[2][:, COL_PID], None) for f in frames], cpu_st, "config3")
    n_sessions, n_rows = compare_recovered("(a) recovered", rec.engine, cpu.engine, lost)
    # A recovered vote of a session still active on both engines, again.
    data, offsets, cols = frames[0]
    active = {p.proposal_id for p in cpu.engine.get_active_proposals("config3")}
    k = next(k for k in range(len(cols)) if int(cols[k, COL_PID]) in active)
    row = data[offsets[k]:offsets[k + 1]]
    again = [e.ingest_wire_columnar(["config3"], np.zeros(1, np.int64), *parse_frame(
        [row.tobytes()])[2:], row, np.array([0, len(row)]), NOW + 10).tolist()
        for e in (rec.engine, cpu.engine)]
    if again != [[int(StatusCode.DUPLICATE_VOTE)]] * 2:
        raise AssertionError(f"(a) a recovered vote re-ingested gave {again}")
    wal_bytes = sum(len(b) for b in segment_files(root / "crashed").values())
    storage = InMemoryConsensusStorage()
    rec.checkpoint(storage)
    if len(list_segments(str(root / "crashed"))) != 1:
        raise AssertionError("(a) the checkpoint left more than one segment")
    rec.close()
    loaded = wal_engine(dev)
    loaded.load_from_storage(storage)
    compare_recovered("(a) loaded", loaded, rec.engine, set())
    del loaded

    log(f"[wal] (a) config 3 over wire bytes: {WAL_PROPOSALS} proposals x {WAL_VOTERS} voters, "
        f"{n_votes} stub-signed votes in {len(frames)} ingest_wire_columnar calls, built and "
        f"parsed natively; statuses {codes}, equal on the bare GPU engine, the durable ones "
        f"at batch and always and the crashed child at always (launches "
        f"{json.dumps(crashed['launches'])})")
    log(f"[wal] (a) the child died with exit {child.returncode} after its last acknowledged "
        f"call; its log ({wal_bytes} B in {len(segment_files(root / 'cpu'))} segment(s), "
        f"writer stats {json.dumps(crashed['stats'])}) equals the CPU engine's byte for byte; "
        f"recovery into a fresh GPU engine replayed {stats.records_applied} records, "
        f"{stats.votes_replayed} votes, launches {json.dumps(replay_launches)}; {n_sessions} "
        f"sessions and {n_rows} pooled rows equal to the CPU engine's but for the state of "
        f"the {len(lost)} sessions failed live by a MAX_ROUNDS_EXCEEDED row, which the log "
        f"does not hold (active after recovery, as in the JAX package); a recovered vote "
        f"re-ingested: DUPLICATE_VOTE; checkpoint left one segment; load_from_storage into a "
        f"fresh GPU engine: same snapshot and rows")
    return dict(launches=crashed["launches"], replay_launches=replay_launches)


def multi_traffic(engine):
    """(b)'s calls on ``engine`` (durable): create_proposals_multi over
    MULTI_SCOPES scopes, two waves of ingest_columnar_multi with the rows'
    bytes, two scopes deleted, a sweep, a checkpoint, two more waves.
    Returns statuses and the checkpoint's storage."""
    from hashgraph_tpu_torch import InMemoryConsensusStorage

    scopes = [f"m{i}" for i in range(MULTI_SCOPES)]
    for scope in scopes[1::2]:
        engine.scope(scope).p2p_preset().initialize()
    reqs = [requests(MULTI_PROPOSALS, WAL_VOTERS, 30 if i < MULTI_SHORT else 3600,
                     lambda k: k % 2 == 0) for i in range(MULTI_SCOPES)]
    with seeded_ids(103):
        made = engine.create_proposals_multi(list(zip(scopes, reqs)), NOW)
    pids = np.asarray([p.proposal_id for props in made for p in props], np.int64)
    scope_of = np.repeat(np.arange(MULTI_SCOPES), MULTI_PROPOSALS)
    waves = wire_waves(pids, 104, scope_of)
    gids = np.asarray([engine.voter_gid(b"voter-%d" % i) for i in range(WAL_VOTERS)])
    log_ = []
    storage = InMemoryConsensusStorage()
    tail = []  # (pids, scope index) of the waves after the checkpoint
    for w, (rows, sidx, row_pid, owner, values) in enumerate(waves[:WAL_WAVES]):
        if w == 2:
            engine.delete_scopes(scopes[-MULTI_DELETED:])
            log_.append(sorted((s, p, r) for s, p, r in engine.sweep_timeouts(NOW + 40)))
            engine.checkpoint(storage)
        offsets = np.zeros(len(rows) + 1, np.int64)
        np.cumsum([len(r) for r in rows], out=offsets[1:])
        st = engine.ingest_columnar_multi(scopes, sidx, row_pid, gids[owner], values,
                                          NOW + 1 + w, wire_votes=(b"".join(rows), offsets))
        log_.append(st.tolist())
        if w >= 2:
            tail.append(((row_pid, sidx), st.tolist()))
    return log_, storage, sum(len(w[0]) for w in waves[:WAL_WAVES]), (scopes, tail)


def phase_wal_multi(dev, root):
    """(b): the multi-scope entry points, durable, recovered after the
    writer is abandoned (a simulated crash), against a CPU engine."""
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.errors import StatusCode
    from hashgraph_tpu_torch.ops import cuda_ingest
    from hashgraph_tpu_torch.wal import DurableEngine

    cpu = DurableEngine(wal_engine("cpu"), root / "multi-cpu", fsync_policy="batch")
    cpu_log, _, n_votes, (scopes, tail) = multi_traffic(cpu)
    cpu.close()
    gpu = DurableEngine(wal_engine(dev), root / "multi-gpu", fsync_policy="batch")
    _build.launches.clear()
    gpu_log, storage, _, _ = multi_traffic(gpu)
    launches = dict(_build.launches)
    gpu.abandon()
    compare("(b) statuses and sweep", gpu_log, cpu_log)
    if segment_files(root / "multi-gpu") != segment_files(root / "multi-cpu"):
        raise AssertionError("(b) the GPU engine's log differs from the CPU engine's")
    require_launches("(b)", launches, [cuda_ingest.KERNEL])
    rec, stats = wal_recover(dev, root / "multi-gpu", storage)
    rec.close()
    lost = round_cap_failures([f for f, _ in tail], [st for _, st in tail], scopes=scopes)
    n_sessions, n_rows = compare_recovered("(b) recovered", rec.engine, cpu.engine, lost)
    flat = np.concatenate([np.asarray(s) for s in gpu_log if s and isinstance(s[0], int)])
    codes = {StatusCode(c).name: int((flat == c).sum()) for c in np.unique(flat)}
    log(f"[wal] (b) {MULTI_SCOPES} scopes x {MULTI_PROPOSALS} proposals x {WAL_VOTERS} voters "
        f"through create_proposals_multi and {WAL_WAVES} ingest_columnar_multi calls with "
        f"wire_votes ({n_votes} votes) under the WAL at batch; {MULTI_DELETED} scopes deleted, "
        f"a sweep deciding {len(gpu_log[2])} sessions, one checkpoint; statuses {codes}; "
        f"launches {json.dumps(launches)}; logs byte-identical; recovered from the "
        f"checkpoint and {stats.records_applied} records to the CPU engine's {n_sessions} "
        f"sessions and {n_rows} pooled rows but for the state of the {len(lost)} sessions "
        f"failed by MAX_ROUNDS_EXCEEDED after the checkpoint")
    return dict(launches=launches)


def phase_wal_verify(dev):
    """(c): phase 7's signed votes as validated wire frames through device
    verification, against a CPU engine on the native host batch."""
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.errors import StatusCode
    from hashgraph_tpu_torch.signing import Ed25519ConsensusSigner

    scope = "wire-verify"
    rng = random.Random(110)
    keys = [Ed25519ConsensusSigner(rng.randbytes(32)) for _ in range(VERIFY_KEYS)]
    signer_cls = counting_device_signer()
    gpu = Run(verify_engine(dev, signer_cls(rng.randbytes(32))))
    cpu = Run(verify_engine("cpu", Ed25519ConsensusSigner(rng.randbytes(32))))
    n_main, n_blame = VERIFY_PROPOSALS, 4
    for run in (gpu, cpu):
        create_seeded(run, scope, n_main + n_blame, 111)
    if gpu.pids != cpu.pids:
        raise AssertionError("(c) the two engines minted different proposal ids")
    pids = gpu.pids[scope]
    main_frame = parse_frame(signed_votes(gpu.engine, scope, pids[:n_main], keys, 112))
    blame_frame = parse_frame(signed_votes(
        gpu.engine, scope, pids[n_main:], keys, 113,
        corrupt={0: "scalar", 1: "s>=L", 2: "bad-A", 3: "R-sign"}))

    def ingest(run, frame, now):
        data, offsets, cols = frame
        return run.engine.ingest_wire_columnar([scope], np.zeros(len(cols), np.int64), cols,
                                               data, offsets, now).tolist()

    captured = KernelInputs()
    _build.launches.clear()
    with captured.active():
        st_main = ingest(gpu, main_frame, NOW + 2)
    main_launches = dict(_build.launches)
    main_batches = list(signer_cls.batches)
    _build.launches.clear()
    st_blame = ingest(gpu, blame_frame, NOW + 3)
    blame_launches = dict(_build.launches)
    blame_batches = signer_cls.batches[len(main_batches):]
    cpu_main = ingest(cpu, main_frame, NOW + 2)
    cpu_blame = ingest(cpu, blame_frame, NOW + 3)
    compare("(c) statuses", [st_main, st_blame], [cpu_main, cpu_blame])
    compare("(c) results", gpu.outcome(scope), cpu.outcome(scope))
    compare("(c) events", gpu.events_by_session(), cpu.events_by_session())
    # One device batch: one MSM window launch.
    require_launches("(c) the main frame", main_launches, VERIFY_KERNELS, {"msm_windows": 1})
    if len(main_batches) != 1:
        raise AssertionError(f"(c) main frame: {len(main_batches)} device batches")
    # The main frame's batch must be the kernels' own verdict: no fallback
    # to the host. The damaged frame's batch fails its MSM by design (a
    # corrupted scalar passes every check before it) and the host blame
    # then names the bad signatures, as in phase 7.
    if main_batches[0]["fallback"] != 0.0 or not main_batches[0]["msm"] > 0.0:
        raise AssertionError(f"(c) the main frame's batch fell back: {main_batches[0]}")
    if len(blame_batches) != 1 or not blame_batches[0]["fallback"] > 0.0:
        raise AssertionError(f"(c) damaged frame batches {blame_batches}")
    codes = {StatusCode(c).name: st_main.count(c) for c in sorted(set(st_main))}
    blame_codes = {StatusCode(c).name: st_blame.count(c) for c in sorted(set(st_blame))}
    if set(codes) - {"OK", "ALREADY_REACHED"} or blame_codes.get("INVALID_VOTE_SIGNATURE") != 4:
        raise AssertionError(f"(c) statuses {codes}, damaged frame {blame_codes}")
    held = hold_captured(captured)
    if set(held) != set(VERIFY_KERNELS):
        raise AssertionError(f"(c) kernel inputs captured on the path: {held}")
    log(f"[wal] (c) {len(main_frame[2])} Ed25519-signed wire rows in one ingest_wire_columnar "
        f"call on the GPU engine: one device batch, launches {json.dumps(main_launches)}, "
        f"statuses {codes}; the damaged frame: launches {json.dumps(blame_launches)}, "
        f"statuses {blame_codes}, host blame after the MSM rejected its batch; statuses, "
        f"results and events identical to the CPU engine's (native batch); each kernel held "
        f"against its plain version on the frame's inputs at {json.dumps(held)}")
    return dict(launches=main_launches, launches_blame=blame_launches)


def phase_wal(dev):
    """Phase 10: (a), (b) and (c), their logs under WAL_DIR (removed after)."""
    import shutil

    shutil.rmtree(WAL_DIR, ignore_errors=True)
    WAL_DIR.mkdir()
    try:
        a = phase_wal_config3(dev, WAL_DIR)
        b = phase_wal_multi(dev, WAL_DIR)
    finally:
        shutil.rmtree(WAL_DIR, ignore_errors=True)
    c = phase_wal_verify(dev)
    return dict(a=a, b=b, c=c)


TIER_PROPOSALS = 10_000  # (a): config 3's scope, half gossipsub, half P2P
TIER_DURABLE_PROPOSALS = 2_000  # (b), cut in depth as phase 10 (a) is
TIER_VOTERS = 64
TIER_EXPIRY = 300  # seconds after creation
TIER_DEMOTE = 60.0  # the tiered scope's demote_after
TIER_EVICT = 600.0  # evict_decided_after, on the tiered engines and the twin
TIER_SCOPE = "tier"
TIER_DIR = Path(__file__).resolve().parent / "_chip_smoke_tier"


class TierPlan:
    """Phase 11's traffic over proposal ids ``pids`` (a multiple of 20 of
    them), by proposal index ``i``: ``i % 20`` in (0, 3) takes its waves
    with ``wire_votes`` (the session retains its rows' bytes, so it pages
    back into a pool slot), the rest as plain columns (tallies: such a
    session pages back in on the host, as in the JAX package) — or every
    proposal with ``wire_votes`` when ``all_wire`` (a durable engine logs
    columnar rows by their bytes); ``i % 5 == 0`` (a fifth) takes waves 1-2
    only and stays active, the rest all four waves. The late call at NOW +
    130 carries wave 3 to ``i % 20`` in (0, 5) (half the active sessions)
    and wave 2 again to ``i % 20`` in (3, 8) (as many decided ones); the
    reads touch 50 other active sessions (``i % 20 == 10``) and 50 decided
    ones (``i % 20 == 13``)."""

    def __init__(self, pids, seed, all_wire=False):
        n = len(pids)
        self.pids = np.asarray(pids, np.int64)
        m = np.arange(n) % 20
        self.wire = np.ones(n, bool) if all_wire else np.isin(m, (0, 3))
        active = np.arange(n) % 5 == 0
        self.reads = np.concatenate([np.nonzero(m == 10)[0][:50], np.nonzero(m == 13)[0][:50]])
        rng = np.random.default_rng(seed)
        wire_idx = np.nonzero(self.wire)[0]
        index_of = {int(self.pids[i]): int(i) for i in wire_idx}
        waves = wire_waves(self.pids[wire_idx], seed + 1)[:4]
        # Per wave: (proposal index, voter, value, row bytes or None) of
        # every plain proposal, shuffled, and of every retaining one.
        plain, wired = [], []
        for w, (rows, _, row_pid, owner, values) in enumerate(waves):
            p = np.repeat(np.arange(n), 16)
            v = 16 * w + np.tile(np.arange(16), n)
            order = rng.permutation(len(p))
            val = rng.random(len(p)) < 0.6
            keep = ~self.wire[p[order]]
            plain.append((p[order][keep], v[order][keep], val[order][keep], None))
            wired.append((np.asarray([index_of[int(x)] for x in row_pid], np.int64),
                          owner, values, rows))
        self.calls = []  # per wave: the plain call, the retaining call
        for w in range(4):
            self.calls.append(tuple(self._cut(part, (w < 2) | ~active[part[0]])
                                    for part in (plain[w], wired[w])))
        parts = []
        for w, chosen in ((2, np.isin(m, (0, 5))), (1, np.isin(m, (3, 8)))):
            for part in (plain[w], wired[w]):
                parts.append(self._cut(part, chosen[part[0]]))
        order = rng.permutation(sum(len(x[0]) for x in parts))
        self.late = tuple(np.concatenate([x[k] for x in parts])[order] for k in range(3))
        self.late_wire = None
        if all_wire:
            rows = [r for x in parts for r in x[3] or []]
            self.late_wire = [rows[k] for k in order.tolist()]

    @staticmethod
    def _cut(part, keep):
        p, v, val, rows = part
        return (p[keep], v[keep], val[keep],
                None if rows is None else [r for r, k in zip(rows, keep) if k])

    def gids(self, engine):
        """The voters' gids on ``engine``, interned now: a demotion that
        releases every slot a voter holds frees its gid."""
        return np.asarray([engine.voter_gid(b"voter-%d" % i) for i in range(TIER_VOTERS)])


def tier_engine(dev, tiered, durable_root=None):
    """A phase 11 engine: config 3's scope with ``evict_decided_after`` and,
    when ``tiered``, ``demote_after``; under a durable wrapper at
    ``batch`` when ``durable_root`` is given. Returns the Run."""
    engine = wal_engine(dev)
    if durable_root is not None:
        from hashgraph_tpu_torch.wal import DurableEngine

        engine = DurableEngine(engine, durable_root, fsync_policy="batch")
    builder = engine.scope(TIER_SCOPE).with_evict_decided_after(TIER_EVICT)
    if tiered:
        builder = builder.with_demote_after(TIER_DEMOTE)
    builder.initialize()
    return Run(engine)


def tier_create(run, n):
    """``n`` proposals (seeded ids), half gossipsub and half P2P."""
    from hashgraph_tpu_torch import ConsensusConfig

    reqs = requests(n, TIER_VOTERS, TIER_EXPIRY, lambda i: i % 4 < 2)
    with seeded_ids(121):
        run.create(TIER_SCOPE, reqs[:n // 2], NOW, ConsensusConfig.gossipsub())
        run.create(TIER_SCOPE, reqs[n // 2:], NOW, ConsensusConfig.p2p())
    return run.pids[TIER_SCOPE]


def tier_fingerprints(engine, skip=frozenset()):
    """(``state_fingerprint``, the same digest over the session items
    alone) from one ``save_to_storage``: the untiered twin's scope config
    differs by its ``demote_after``, so the twin is held to the sessions'
    digest and the tiered CPU engine to the whole one. Sessions keyed in
    ``skip`` (scope, proposal id) are left out of both."""
    import hashlib

    from hashgraph_tpu_torch.sync.snapshot import (
        ITEM_SCOPE_CONFIG, ITEM_SESSION, encode_frame, encode_scope_config_item,
        encode_session_item)

    class Sink:
        sessions, configs = [], []

        def save_session(self, scope, session):
            if (scope, session.proposal.proposal_id) in skip:
                return
            self.sessions.append(hashlib.sha256(encode_frame(
                ITEM_SESSION, encode_session_item(scope, session))).digest())

        def set_scope_config(self, scope, config):
            self.configs.append(hashlib.sha256(encode_frame(
                ITEM_SCOPE_CONFIG, encode_scope_config_item(scope, config))).digest())

    sink = Sink()
    sink.sessions, sink.configs = [], []
    engine.save_to_storage(sink)
    digest = lambda items: hashlib.sha256(b"".join(sorted(items))).hexdigest()  # noqa: E731
    return digest(sink.sessions + sink.configs), digest(sink.sessions)


def tier_view(run):
    """What the engines must agree on after a step: events per session,
    scope stats, session keys and the fingerprints (see
    :func:`tier_fingerprints`)."""
    engine = run.engine
    stats = engine.get_scope_stats(TIER_SCOPE)
    keys = sorted(pid for _, pid in engine.session_keys())
    return [run.events_by_session(), (stats.total_sessions, stats.active_sessions,
                                      stats.failed_sessions, stats.consensus_reached),
            keys, *tier_fingerprints(engine)]


def tier_steps(run, plan, until=None):
    """Phase 11's steps on one engine (bare or durable). Yields (label,
    answer) after each step, before the next starts, so the caller can read
    the engine between steps; stops after the step ``until``."""
    engine = run.engine
    pids = plan.pids
    gids = plan.gids(engine)
    answers = []
    for w, call in enumerate(plan.calls):
        for p, v, val, wire in call:
            if len(p) == 0:
                continue
            answers.append(engine.ingest_columnar(TIER_SCOPE, pids[p], gids[v], val,
                                                  NOW + 1 + w, wire_votes=wire).tolist())
    yield "waves", answers
    # Pinned, the scope is left alone; unpinned, the sweep demotes.
    engine.pin_scope(TIER_SCOPE)
    pinned = engine.lifecycle_sweep(NOW + 120)
    engine.unpin_scope(TIER_SCOPE)
    yield "pinned", pinned
    yield "sweep 120", sorted(engine.sweep_timeouts(NOW + 120))
    p, v, val = plan.late
    yield "late votes 130", engine.ingest_columnar(
        TIER_SCOPE, pids[p], plan.gids(engine)[v], val, NOW + 130,
        wire_votes=plan.late_wire).tolist()
    reads = []
    for i in plan.reads.tolist():
        reads.append(engine.get_proposal(TIER_SCOPE, int(pids[i])).encode())
        try:
            reads.append(engine.get_consensus_result(TIER_SCOPE, int(pids[i])))
        except Exception as exc:  # the exception type is the answer compared
            reads.append(type(exc).__name__)
    yield "reads", reads
    if until == "reads":
        return
    yield "sweep 400", sorted(engine.sweep_timeouts(NOW + 400))
    yield "sweep 1000", sorted(engine.sweep_timeouts(NOW + 1000))


def phase_tier_compare(dev):
    """(a): the tiered GPU engine against an untiered GPU twin and a tiered
    CPU engine, step by step."""
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.errors import StatusCode
    from hashgraph_tpu_torch.ops import cuda_ingest
    from hashgraph_tpu_torch.sync import state_fingerprint

    runs = {"tiered": tier_engine(dev, True), "twin": tier_engine(dev, False),
            "cpu": tier_engine("cpu", True)}
    pids = {name: tier_create(run, TIER_PROPOSALS) for name, run in runs.items()}
    if not pids["tiered"] == pids["twin"] == pids["cpu"]:
        raise AssertionError("(a) the engines minted different proposal ids")
    plan = TierPlan(pids["tiered"], 122)
    steps = {name: tier_steps(run, plan) for name, run in runs.items()}
    report = {}
    while True:
        out = {}
        for name, gen in steps.items():
            if name == "tiered":
                _build.launches.clear()
            out[name] = next(gen, None)
            if name == "tiered":
                launches = dict(_build.launches)
        if out["tiered"] is None:
            break
        label, answer = out["tiered"]
        views = {name: tier_view(run) for name, run in runs.items()}
        for name in ("twin", "cpu"):
            compare(f"(a) {label}: answers, {name}", out[name][1], answer)
            # The twin's scope config differs: its sessions' digest only.
            held = 3 if name == "twin" else 4
            compare(f"(a) {label}: events, stats, keys and fingerprint, {name}",
                    views[name][:held] + views[name][4:], views["tiered"][:held]
                    + views["tiered"][4:])
        occ = runs["tiered"].engine.occupancy()
        report[label] = dict(answer=answer, occ=occ, launches=launches, stats=views["tiered"][1])
        if label == "pinned" and (answer != {"demoted": 0, "gc_live": 0, "gc_tier": 0}
                                  or occ["tier_sessions"] != 0):
            raise AssertionError(f"(a) a pinned scope was swept: {answer}, {occ}")
        if label == "sweep 120" and not (occ["tier_sessions"] == TIER_PROPOSALS
                                         and occ["live_sessions"] == 0
                                         and occ["device_slots_used"] == 0):
            raise AssertionError(f"(a) the sweep at NOW + 120 left {occ}")
    if state_fingerprint(runs["tiered"].engine) != tier_fingerprints(runs["tiered"].engine)[0]:
        raise AssertionError("(a) tier_fingerprints disagrees with state_fingerprint")
    del runs, steps
    demote, late = report["sweep 120"], report["late votes 130"]
    require_launches("(a) the late votes", late["launches"], [cuda_ingest.KERNEL])
    flat = np.asarray(late["answer"])
    codes = {StatusCode(c).name: int((flat == c).sum()) for c in np.unique(flat)}
    if not {"OK", "DUPLICATE_VOTE", "ALREADY_REACHED"} <= set(codes):
        raise AssertionError(f"(a) the late call's statuses {codes}")
    final = report["sweep 1000"]["occ"]
    if final["tier_gc_total"] == 0 or report["sweep 400"]["occ"]["tier_promotions_total"] <= (
            late["occ"]["tier_promotions_total"]):
        raise AssertionError(f"(a) the sweeps neither promoted nor collected: {final}")
    tier_bytes = demote["occ"]["tier_bytes"]
    log(f"[tier] (a) {TIER_PROPOSALS} proposals x {TIER_VOTERS} voters (half gossipsub, half "
        f"P2P; {int(plan.wire.sum())} retaining their rows' bytes), demote_after "
        f"{TIER_DEMOTE:g} s, evict_decided_after {TIER_EVICT:g} s; every step equal on the "
        f"tiered GPU engine, the untiered GPU twin and the tiered CPU engine (answers, events "
        f"per session, stats, session keys, state_fingerprint); pin_scope held the sweep, "
        f"unpin_scope released it")
    log(f"[tier] (a) the sweep at NOW + 120 demoted {TIER_PROPOSALS} sessions: tier_bytes "
        f"{tier_bytes} = {tier_bytes / TIER_PROPOSALS:.1f} B a session")
    log(f"[tier] (a) the late call at NOW + 130: {len(plan.late[0])} rows, statuses {codes}; "
        f"{late['occ']['device_slots_used']} sessions back in pool slots, "
        f"{late['occ']['host_spilled']} on the host; launches {json.dumps(late['launches'])}")
    log(f"[tier] (a) occupancy after the sweep at NOW + 400 "
        f"{json.dumps(report['sweep 400']['occ'])}, after NOW + 1000 {json.dumps(final)}; "
        f"stats after each step {[(k, report[k]['stats']) for k in report]}")
    return dict(launches=late["launches"])


def phase_tier_durable(dev, root):
    """(b): the traffic on a tiered GPU engine under ``DurableEngine`` at
    ``batch``, abandoned (a simulated crash) after the reads and recovered
    on the card; the recovered engine takes the sweeps at NOW + 400 and a
    standalone ``lifecycle_sweep`` at NOW + 700 (KIND_LIFECYCLE, and
    KIND_GC for what it collects), is abandoned again and recovered from
    the whole log."""
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.errors import StatusCode
    from hashgraph_tpu_torch.ops import cuda_ingest
    from hashgraph_tpu_torch.sync import state_fingerprint
    from hashgraph_tpu_torch.wal import format as F
    from hashgraph_tpu_torch.wal import scan

    path = root / "tier"
    live = tier_engine(dev, True, path)
    plan = TierPlan(tier_create(live, TIER_DURABLE_PROPOSALS), 123, all_wire=True)
    calls = [part for call in plan.calls for part in call if len(part[0])] + [plan.late]
    answers = []
    for label, answer in tier_steps(live, plan, until="reads"):
        if label in ("waves", "late votes 130"):
            answers += answer if label == "waves" else [answer]
    late_st = answers[-1]
    # The columnar records hold accepted rows only (the JAX package's log,
    # ROADMAP queue 3): a session a MAX_ROUNDS_EXCEEDED row failed live
    # comes back active. Everything else must be equal.
    lost = round_cap_failures([(plan.pids[c[0]], None) for c in calls], answers, TIER_SCOPE)
    live_fp = tier_fingerprints(live.engine.engine, skip=lost)
    live.engine.abandon()
    _build.launches.clear()
    rec, stats1 = wal_recover(dev, path)
    launches = dict(_build.launches)
    compare_recovered("(b) the first recovery", rec.engine, live.engine.engine, lost,
                      rows=False)
    if stats1.errors or tier_fingerprints(rec.engine, skip=lost) != live_fp:
        raise AssertionError(f"(b) the first recovery differs from the live engine: {stats1}")
    require_launches("(b) the first replay", launches, [cuda_ingest.KERNEL])
    # Two late votes accepted live, again, on sessions still active.
    p, v, val = plan.late
    active = {q.proposal_id for q in rec.get_active_proposals(TIER_SCOPE)}
    again = []
    for k in [k for k in range(len(p)) if late_st[k] == int(StatusCode.OK)
              and int(plan.pids[p[k]]) in active
              and (TIER_SCOPE, int(plan.pids[p[k]])) not in lost][:2]:
        again += rec.engine.ingest_columnar(TIER_SCOPE, plan.pids[p[k:k + 1]],
                                            plan.gids(rec.engine)[v[k:k + 1]], val[k:k + 1],
                                            NOW + 131).tolist()
    if again != [int(StatusCode.DUPLICATE_VOTE)] * 2:
        raise AssertionError(f"(b) recovered votes re-ingested gave {again}")
    rec.sweep_timeouts(NOW + 400)
    swept = rec.lifecycle_sweep(NOW + 700)
    kinds = [kind for _, kind, _ in scan(str(path)).records]
    if kinds[-2:] != [F.KIND_LIFECYCLE, F.KIND_GC] or not swept["gc_live"] + swept["gc_tier"]:
        raise AssertionError(f"(b) the standalone sweep {swept} logged {kinds[-2:]}")
    live_fp = state_fingerprint(rec)
    n_live = len(rec.session_keys())
    rec.abandon()
    rec2, stats2 = wal_recover(dev, path)
    if stats2.errors or state_fingerprint(rec2) != live_fp:
        raise AssertionError(f"(b) the second recovery differs from the live engine: {stats2}")
    compare_recovered("(b) the second recovery", rec2.engine, rec.engine, set(), rows=False)
    rec2.close()
    log(f"[tier] (b) {TIER_DURABLE_PROPOSALS} proposals, the same traffic under DurableEngine "
        f"at batch, every row with its bytes (a durable engine logs columnar rows so); "
        f"abandoned after the reads and recovered on the card "
        f"({stats1.records_applied} records, launches {json.dumps(launches)}) to the live "
        f"engine's sessions and its state_fingerprint over every session "
        f"but the {len(lost)} a MAX_ROUNDS_EXCEEDED row failed live (active after recovery, "
        f"as in the JAX package); two recovered late votes re-ingested: DUPLICATE_VOTE; then "
        f"sweep_timeouts at NOW + 400 and lifecycle_sweep at NOW + 700 ({swept}), abandoned "
        f"again and recovered from the whole log ({stats2.records_applied} records, kinds "
        f"{sorted(set(F.KIND_NAMES[k] for k in kinds))}) to the live "
        f"state_fingerprint ({n_live} sessions left)")
    return dict(launches=launches)


def phase_tier(dev):
    """Phase 11: (a) and (b), (b)'s log under TIER_DIR (removed after)."""
    import shutil

    a = phase_tier_compare(dev)
    shutil.rmtree(TIER_DIR, ignore_errors=True)
    TIER_DIR.mkdir()
    try:
        b = phase_tier_durable(dev, TIER_DIR)
    finally:
        shutil.rmtree(TIER_DIR, ignore_errors=True)
    return dict(a=a, b=b)


# ── Phase 12: observability on the card ───────────────────────────────

OBS_EXPLAINED = 10  # seeded decided proposals explained on both engines
# Kernel table name -> the names its launches carry in a profiler trace.
PROFILED_KERNELS = {
    "ingest_scan": ("ingest_scan_kernel",),
    "fe_mul": ("fe_mul_kernel",),
    "fe_pow22523": ("fe_pow22523_kernel",),
    "msm_windows": ("msm_windows_kernel",),
    "msm_reduce": ("msm_tree_span_kernel", "msm_tree_root_kernel"),
}
# Counters that only the device signer's batches move.
DEVICE_VERIFY_COUNTERS = ("hashgraph_device_verify_batches_total",
                          "hashgraph_device_verify_signatures_total",
                          "hashgraph_device_verify_fallbacks_total")


def obs_engine(dev, signer=None):
    """A phase-12 engine: the README's single-chip size, its own
    ``HealthMonitor(registry=MetricsRegistry())``, no verify cache."""
    from hashgraph_tpu_torch import StubConsensusSigner, TorchConsensusEngine
    from hashgraph_tpu_torch.events import BroadcastEventBus
    from hashgraph_tpu_torch.obs import HealthMonitor, MetricsRegistry

    return TorchConsensusEngine(
        signer or StubConsensusSigner(b"chip-smoke"), CAPACITY, VOTER_CAPACITY,
        event_bus=BroadcastEventBus(max_queued_events=10_000_000),
        max_sessions_per_scope=CAPACITY, device=dev, verify_cache=None,
        health_monitor=HealthMonitor(registry=MetricsRegistry()),
    )


def registry_delta(before, after):
    """What changed between two ``export_state``s of a registry: every
    counter that moved, and each histogram's count and bucket counts."""
    counters = {name: value - before["counters"].get(name, 0)
                for name, value in after["counters"].items()
                if value != before["counters"].get(name, 0)}
    histograms = {}
    for name, h in after["histograms"].items():
        b = before["histograms"].get(name, {"count": 0, "counts": [0] * len(h["counts"])})
        histograms[name] = {"count": h["count"] - b["count"],
                            "buckets": [x - y for x, y in zip(h["counts"], b["counts"])]}
    return counters, histograms


def masked_explain(engine, scope, pid):
    """``explain_decision`` with the wall-clock latencies and generated
    trace ids masked (their presence kept)."""
    out = engine.explain_decision(scope, pid)
    timeline = dict(out["timeline"] or {})
    for key in ("first_vote_latency_s", "decision_latency_s"):
        if key in timeline:
            timeline[key] = "masked"
    out["timeline"] = timeline
    if out["trace"] is not None:
        out["trace"] = dict.fromkeys(out["trace"], "masked")
    return out


def scrape(sidecar):
    """GET ``/metrics`` and ``/healthz`` of a running sidecar: the sample
    names of the text (every line must parse as ``name value``) and the
    health status and body."""
    import urllib.request

    host, port = sidecar.address
    with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10) as r:
        text = r.read().decode()
    names = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        sample, value = line.split(" # ", 1)[0].rsplit(" ", 1)
        float(value)
        names.add(sample.split("{", 1)[0])
    with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=10) as r:
        health = (r.status, json.loads(r.read()))
    return names, health


def profiled_kernels(path):
    """Per kernel of :data:`PROFILED_KERNELS`: the CUDA kernel events of a
    Chrome trace that name it, as (launches, total device ms)."""
    doc = json.loads(Path(path).read_text())
    kernels = [e for e in doc.get("traceEvents", [])
               if str(e.get("cat", "")).lower() == "kernel" and e.get("ph") == "X"]
    out = {}
    for name, needles in PROFILED_KERNELS.items():
        hits = [e for e in kernels if any(n in e.get("name", "") for n in needles)]
        if not hits or not all(float(e.get("dur", 0)) > 0 for e in hits):
            raise AssertionError(f"the device trace holds no timed {name} launch "
                                 f"({len(kernels)} kernel events)")
        out[name] = (len(hits), sum(float(e["dur"]) for e in hits) / 1e3)
    return out, len(kernels)


def phase_obs_config3(dev):
    """(a) config 3 on a GPU and a CPU engine, registry deltas and explains
    equal; (b) again on a GPU engine with the tracer, the trace store, an
    ambient trace context and the profiler on, and a sidecar scrape."""
    from hashgraph_tpu_torch import _build, obs
    from hashgraph_tpu_torch.obs.trace import TraceContext, trace_store, use_context
    from hashgraph_tpu_torch.ops import cuda_ingest
    from hashgraph_tpu_torch.sync import state_fingerprint
    from hashgraph_tpu_torch.tracing import tracer

    registry = obs.registry
    runs = {}
    for label, d in (("gpu", dev), ("cpu", "cpu")):
        run = Run(obs_engine(d))
        before = registry.export_state()
        _build.launches.clear()
        with seeded_ids(120):
            statuses = config3_traffic(run, 3)
        launches = dict(_build.launches)
        runs[label] = dict(run=run, statuses=statuses,
                           delta=registry_delta(before, registry.export_state()),
                           launches=launches)
    gpu, cpu = runs["gpu"], runs["cpu"]
    require_launches("(a) config 3", gpu["launches"], [cuda_ingest.KERNEL])
    compare("(a) statuses", gpu["statuses"], cpu["statuses"])
    compare("(a) results", gpu["run"].outcome("config3"), cpu["run"].outcome("config3"))
    events_a = gpu["run"].events_by_session()
    compare("(a) events", events_a, cpu["run"].events_by_session())
    (g_counters, g_hist), (c_counters, c_hist) = gpu["delta"], cpu["delta"]
    compare("(a) counter deltas", g_counters, c_counters)
    for name in (obs.INGEST_BATCH_SIZE, obs.CHAIN_SUFFIX_LENGTH):
        compare(f"(a) {name}", g_hist[name], c_hist[name])
    latency = g_hist[obs.DECISION_LATENCY]["count"]
    if latency <= 0 or latency != c_hist[obs.DECISION_LATENCY]["count"]:
        raise AssertionError(f"(a) decision latencies: {latency} on the GPU engine, "
                             f"{c_hist[obs.DECISION_LATENCY]['count']} on the CPU engine")
    calls = len(gpu["statuses"])
    if g_hist[obs.DEVICE_INGEST_SECONDS]["count"] != calls:
        raise AssertionError(f"(a) hashgraph_device_ingest_seconds counted "
                             f"{g_hist[obs.DEVICE_INGEST_SECONDS]['count']} dispatches of "
                             f"{calls} calls")
    results, _ = gpu["run"].outcome("config3")
    decided = [k for k, r in enumerate(results) if r in (True, False)]
    picks = sorted(random.Random(121).sample(decided, OBS_EXPLAINED))
    pids = gpu["run"].pids["config3"]
    if pids != cpu["run"].pids["config3"]:
        raise AssertionError("(a) the two engines minted different proposal ids")
    for k in picks:
        compare(f"(a) explain_decision of proposal {k}",
                masked_explain(gpu["run"].engine, "config3", pids[k]),
                masked_explain(cpu["run"].engine, "config3", pids[k]))
    log(f"[obs] (a) config 3 with the hooks on a GPU and a CPU engine: counter deltas equal "
        f"{json.dumps(g_counters, sort_keys=True)}; batch-size buckets equal; {latency} "
        f"decision latencies on each; device-ingest spans {calls}; {OBS_EXPLAINED} explains "
        f"equal")

    # (b) the same traffic with every listener on.
    run_b = Run(obs_engine(dev))
    tracer.reset()
    tracer.enable()
    trace_store.clear()
    trace_store.enabled = True
    profiler = obs.default_profiler
    profiler.reset()
    profiler.enabled = True
    profiler.start()
    root = TraceContext.generate()
    try:
        with seeded_ids(120), use_context(root):
            statuses_b = config3_traffic(run_b, 3)
    finally:
        profiler.stop()
        tracer.disable()
    compare("(b) statuses", statuses_b, gpu["statuses"])
    compare("(b) results", run_b.outcome("config3"), gpu["run"].outcome("config3"))
    compare("(b) events", run_b.events_by_session(), events_a)
    compare("(b) state_fingerprint", state_fingerprint(run_b.engine),
            state_fingerprint(gpu["run"].engine))
    counts = tracer.counters()
    spans = trace_store.spans(trace_id=root.trace_id)
    if not counts.get("engine.votes_in") or not spans:
        raise AssertionError(f"(b) the tracer or the trace store saw nothing: {counts}, "
                             f"{len(spans)} spans")
    report = obs.attribution_report()
    sidecar = obs.MetricsSidecar(registry, health_fn=lambda: {"ok": True})
    sidecar.start()
    try:
        names, health = scrape(sidecar)
    finally:
        sidecar.stop()
    base = {n[: -len(sfx)] for n in names for sfx in ("_bucket", "_sum", "_count")
            if n.endswith(sfx)} | names
    missing = [f for f in obs.documented_families() if f not in base]
    if missing or health[0] != 200:
        raise AssertionError(f"(b) the scrape lacks {missing}, /healthz {health}")
    snap = profiler.snapshot()
    log(f"[obs] (b) with the tracer, the trace store and the profiler on: outcomes, events "
        f"and state_fingerprint equal to (a); tracer counts {json.dumps(counts, sort_keys=True)}; "
        f"{len(spans)} spans on the ambient trace; profiler {snap['samples']} samples at "
        f"{snap['rate_hz']} Hz; /metrics holds all {len(obs.documented_families())} documented "
        f"families ({len(names)} sample names), /healthz {health[0]}")
    log(f"[obs] (b) attribution_report(): {json.dumps(report, sort_keys=True)}")
    tracer.reset()
    trace_store.clear()
    return dict(launches=gpu["launches"])


def equivocate(run, key, now):
    """Recipe 5 of the verify skill: one vote, then a conflicting one by the
    same signer, both validated; the statuses."""
    from hashgraph_tpu_torch import build_vote

    scope = "equivocation"
    with seeded_ids(123):  # both engines mint the same proposal and vote ids
        base = run.engine.create_proposal(
            scope, requests(1, 3, 10_000, lambda i: True)[0], NOW)
        first = build_vote(base, True, key, now)
        second = build_vote(base, False, key, now)
    return [run.engine.ingest_votes([(scope, v)], now).tolist() for v in (first, second)]


def phase_obs_verify(dev):
    """(c) phase 7's batch and its damaged call on a device-signed GPU
    engine and a CPU engine, then the equivocation recipe on both."""
    from hashgraph_tpu_torch import _build, obs
    from hashgraph_tpu_torch.errors import StatusCode
    from hashgraph_tpu_torch.signing import (
        Ed25519ConsensusSigner,
        Ed25519DeviceConsensusSigner,
    )
    from hashgraph_tpu_torch.wire import Vote

    scope = "verify"
    rng = random.Random(70)
    keys = [Ed25519ConsensusSigner(rng.randbytes(32)) for _ in range(VERIFY_KEYS)]
    runs = {"gpu": Run(obs_engine(dev, Ed25519DeviceConsensusSigner(rng.randbytes(32)))),
            "cpu": Run(obs_engine("cpu", Ed25519ConsensusSigner(rng.randbytes(32))))}
    for run in runs.values():
        create_seeded(run, scope, VERIFY_PROPOSALS + 4, 71)
    pids = runs["gpu"].pids[scope]
    main_bytes = signed_votes(runs["gpu"].engine, scope, pids[:VERIFY_PROPOSALS], keys, 72)
    blame_bytes = signed_votes(runs["gpu"].engine, scope, pids[VERIFY_PROPOSALS:], keys, 73,
                               corrupt={0: "scalar", 1: "s>=L", 2: "bad-A", 3: "R-sign"})
    out = {}
    for label, run in runs.items():
        steps, statuses = [], []
        _build.launches.clear()
        for data, now in ((main_bytes, NOW + 2), (blame_bytes, NOW + 3)):
            before = obs.registry.export_state()
            sync_of(run.engine.device)()
            statuses.append(run.engine.ingest_votes(
                [(scope, Vote.decode(b)) for b in data], now).tolist())
            sync_of(run.engine.device)()
            steps.append(registry_delta(before, obs.registry.export_state())[0])
        out[label] = dict(steps=steps, statuses=statuses, launches=dict(_build.launches),
                          equivocation=equivocate(run, keys[5], NOW + 4))
    gpu, cpu = out["gpu"], out["cpu"]
    require_launches("(c) the batches", gpu["launches"], VERIFY_KERNELS)
    compare("(c) statuses", gpu["statuses"], cpu["statuses"])
    for k, want in enumerate(({"batches": 1, "signatures": len(main_bytes), "fallbacks": 0},
                              {"batches": 1, "signatures": len(blame_bytes), "fallbacks": 1})):
        got = {name.split("_")[-2]: gpu["steps"][k].get(name, 0)
               for name in DEVICE_VERIFY_COUNTERS}
        if got != want or any(cpu["steps"][k].get(n) for n in DEVICE_VERIFY_COUNTERS):
            raise AssertionError(f"(c) call {k}: device verify counters {got}, want {want}")
        compare(f"(c) call {k} verified signatures",
                gpu["steps"][k].get(obs.VERIFIED_SIGNATURES_TOTAL),
                cpu["steps"][k].get(obs.VERIFIED_SIGNATURES_TOTAL))
    dup = int(StatusCode.DUPLICATE_VOTE)
    reports = {}
    for label, run in runs.items():
        if out[label]["equivocation"] != [[0], [dup]]:
            raise AssertionError(f"(c) equivocation on the {label} engine: "
                                 f"{out[label]['equivocation']}")
        report = run.engine.health_report(NOW + 4)
        card = report["peers"][keys[5].identity().hex()]
        evidence = [e for e in report["evidence"] if e["kind"] == "equivocation"]
        if card["grade"] != "faulty" or len(evidence) != 1 or not evidence[0]["verified"]:
            raise AssertionError(f"(c) the {label} engine graded {card['grade']} with "
                                 f"evidence {evidence}")
        report.pop("identity")
        reports[label] = report
    compare("(c) health_report", reports["gpu"], reports["cpu"])
    log(f"[obs] (c) phase 7's batches: counter changes on the GPU engine "
        f"{json.dumps(gpu['steps'], sort_keys=True)}; verified signatures equal on the CPU "
        f"engine ({cpu['steps'][0].get(obs.VERIFIED_SIGNATURES_TOTAL)} + "
        f"{cpu['steps'][1].get(obs.VERIFIED_SIGNATURES_TOTAL)}); the equivocator graded "
        f"faulty with one verified evidence record; health_report equal on both engines "
        f"({len(reports['gpu']['peers'])} peers, firing "
        f"{[a['rule'] for a in reports['gpu']['alerts']['firing']]})")
    return dict(main_bytes=main_bytes, keys=keys, launches=gpu["launches"])


def phase_obs_profile(dev, main_bytes, root):
    """(d) ``tracing.device_profile`` around one config-3 wave that runs
    the scan and one signed batch: every hand kernel in the trace."""
    from hashgraph_tpu_torch import _build, tracing
    from hashgraph_tpu_torch.signing import Ed25519DeviceConsensusSigner
    from hashgraph_tpu_torch.wire import Vote

    run = Run(obs_engine(dev))
    with seeded_ids(122):
        calls = config3_calls(run, 3)
    run.engine.ingest_columnar(*calls[0], max_depth=8)  # wave 1: the scan-free fresh path
    verifier = Run(obs_engine(dev, Ed25519DeviceConsensusSigner(random.Random(70).randbytes(32))))
    create_seeded(verifier, "verify", VERIFY_PROPOSALS + 4, 71)
    items = [("verify", Vote.decode(b)) for b in main_bytes]
    torch.cuda.synchronize()
    _build.launches.clear()
    with tracing.device_profile(str(root)):
        run.engine.ingest_columnar(*calls[1], max_depth=8)
        verifier.engine.ingest_votes(items, NOW + 2)
    launches = dict(_build.launches)
    require_launches("(d) the profiled calls", launches, list(PROFILED_KERNELS))
    profiled, n_events = profiled_kernels(Path(root) / "device_trace.json")
    log(f"[obs] (d) device_profile: {n_events} CUDA kernel events; per kernel "
        f"(trace launches, device ms a launch; wrapper launches): " + "; ".join(
            f"{k} ({n}, {ms / n:.6f}; {launches.get(k, 0)})" for k, (n, ms) in profiled.items()))
    return {k: dict(launches=n, ms=ms / n, wrapper_launches=launches.get(k, 0))
            for k, (n, ms) in profiled.items()}


def phase_obs_recovery(dev, root):
    """(e) a durable GPU engine's log of phase 10 (a)'s shape recovered on
    the card under replay mode: decisions and timeouts hold still, one
    recovery counted, the recovered monitor clean."""
    from hashgraph_tpu_torch import _build, obs
    from hashgraph_tpu_torch.ops import cuda_ingest
    from hashgraph_tpu_torch.wal import DurableEngine

    durable = DurableEngine(obs_engine(dev), Path(root) / "wal", fsync_policy="batch")
    pids = config3_proposals(durable)
    frames = config3_frames(pids)
    before = obs.registry.export_state()
    config3_wire(durable, frames)
    live, _ = registry_delta(before, obs.registry.export_state())
    durable.close()
    fresh = obs_engine(dev)
    recovering = DurableEngine(fresh, Path(root) / "wal", fsync_policy="batch")
    before = obs.registry.export_state()
    _build.launches.clear()
    stats = recovering.recover()
    launches = dict(_build.launches)
    replayed, hist = registry_delta(before, obs.registry.export_state())
    recovering.close()
    require_launches("(e) the replay", launches, [cuda_ingest.KERNEL])
    held = {n: replayed.get(n, 0) for n in (obs.DECISIONS_TOTAL, obs.TIMEOUTS_FIRED_TOTAL)}
    if (not live.get(obs.DECISIONS_TOTAL) or any(held.values())
            or hist[obs.WAL_RECOVER_SECONDS]["count"] != 1
            or hist[obs.DECISION_LATENCY]["count"] != 0):
        raise AssertionError(f"(e) live {live}; the replay moved {replayed}, "
                             f"{hist[obs.WAL_RECOVER_SECONDS]}")
    report = fresh.health_report()
    if report["peers"] or report["evidence"] or report["alerts"]["firing"]:
        raise AssertionError(f"(e) the recovered engine's monitor is not clean: {report}")
    log(f"[obs] (e) recovery of {stats.records_applied} records under replay "
        f"mode: decisions and timeouts held still ({held}; the live run decided "
        f"{live[obs.DECISIONS_TOTAL]}), votes counted {replayed.get(obs.VOTES_TOTAL, 0)}, "
        f"wal_recover_seconds one observation, the recovered monitor clean")
    return dict(launches=launches)


def phase_obs(dev):
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="chip-smoke-obs-"))
    try:
        out = phase_obs_config3(dev)
        verify = phase_obs_verify(dev)
        out["profile"] = phase_obs_profile(dev, verify["main_bytes"], root / "profile")
        out["verify_launches"] = verify["launches"]
        out["recovery"] = phase_obs_recovery(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ── Phase 13: the bridge ───────────────────────────────────────────────

# (b): config 3 over a socket, cut in depth from 10,000 to 5,000 once phase
# 16 came, to keep the whole run under 1,000 s.
BRIDGE_PROPOSALS = 5_000
BRIDGE_CUT = 2_000  # (b)'s CPU arm and (e), cut in depth as phase 10 (a) is
BRIDGE_FRAME_ROWS = 1_024  # rows of one OP_VOTE_BATCH frame
BRIDGE_CONNECTIONS = 4  # pipelined vote connections, a quarter of the proposals each
BRIDGE_SMALL_CALLS = 2_000  # (c): OP_PROCESS_VOTE frames sent one at a time
BRIDGE_SCOPES = ("config3", "config3-p2p")  # connections 0-1, 2-3
BRIDGE_PEER = 1  # the first ADD_PEER of a fresh server
# Frames a pipelined client keeps in flight: under the server's admission
# limit (3/4 of its 256-frame window), so no frame is shed (retry-after).
BRIDGE_INFLIGHT = 128
BRIDGE_COUNTERS = ("WIRE_FALLBACK_FRAMES_TOTAL", "BRIDGE_ERRORS_TOTAL", "BRIDGE_RETRY_AFTER_TOTAL",
                   "WIRE_DEVICE_DISPATCHES_TOTAL", "WIRE_APPLY_ROWS_TOTAL")


def bridge_factory(dev, capacity=CAPACITY, voter_capacity=VOTER_CAPACITY):
    """The engines of (b)-(e)'s servers: config 3's engine (phase 10's:
    one scope may hold every proposal, the events queue deep), with
    ``BRIDGE_SCOPES[1]`` on the P2P preset. The server's default engine
    keeps the reference's 10 sessions a scope, so these servers build
    theirs through ``engine_factory``. Phase 14's engines are smaller
    (``capacity``, ``voter_capacity``)."""
    from hashgraph_tpu_torch import TorchConsensusEngine
    from hashgraph_tpu_torch.events import BroadcastEventBus

    def factory(signer):
        engine = TorchConsensusEngine(
            signer, capacity, voter_capacity,
            event_bus=BroadcastEventBus(max_queued_events=10_000_000),
            max_sessions_per_scope=capacity, device=dev, verify_cache=None,
        )
        engine.scope(BRIDGE_SCOPES[1]).p2p_preset().initialize()
        return engine

    return factory


def bridge_server(dev, signer_cls=None, factory=None, **kwargs):
    """A started port server on ``dev`` over :func:`bridge_factory`'s
    engines, or ``factory``'s (stub-signed peers unless ``signer_cls``)."""
    from hashgraph_tpu_torch import StubConsensusSigner
    from hashgraph_tpu_torch.bridge import BridgeServer

    server = BridgeServer(
        engine_factory=factory or bridge_factory(dev), device=dev, verify_cache=None,
        signer_factory=signer_cls or StubConsensusSigner, **kwargs)
    server.start()
    return server


def bridge_counters():
    import hashgraph_tpu_torch.obs as obs

    return {name: obs.registry.counter(getattr(obs, name)).value for name in BRIDGE_COUNTERS}


def bridge_traffic(seed=130):
    """(b)'s traffic, built once: the proposals' wire bytes (seeded ids;
    the first half for the gossipsub scope, the second for the P2P one)
    and phase 10's waves over them (:func:`wire_waves`: four waves of 16
    stub-signed votes a proposal, then wave 2 again), cut per connection:
    connection ``c`` owns the ``c``-th quarter of the proposals, and its
    rows of a wave keep the wave's order (vote j of each of its proposals,
    then vote j + 1). ``rows[w][c]`` are those rows; ``cut(w, c)`` the
    indices into them of the first ``BRIDGE_CUT / 4`` proposals of the
    quarter (the CPU arm's and (e)'s)."""
    from hashgraph_tpu_torch.wire import Proposal

    rng = random.Random(seed)
    n, q = BRIDGE_PROPOSALS, BRIDGE_PROPOSALS // BRIDGE_CONNECTIONS
    pids = rng.sample(range(1, 2**32), n)
    proposals = [Proposal(
        name=f"p{i}", payload=i.to_bytes(4, "little"), proposal_id=pid,
        proposal_owner=b"smoke", expected_voters_count=WAL_VOTERS, timestamp=NOW,
        expiration_timestamp=NOW + 3600, liveness_criteria_yes=i % 4 < 2,
    ).encode() for i, pid in enumerate(pids)]
    waves = wire_waves(pids, seed + 1)
    rows = []
    for wave in waves:
        flat = wave[0]
        rows.append([[flat[j * n + k] for j in range(WAL_PER_WAVE)
                      for k in range(c * q, (c + 1) * q)]
                     for c in range(BRIDGE_CONNECTIONS)])
    share = BRIDGE_CUT // BRIDGE_CONNECTIONS
    cut = [j * q + k for j in range(WAL_PER_WAVE) for k in range(share)]
    return dict(pids=pids, proposals=proposals, rows=rows, cut=cut, share=share)


def scope_of(c):
    return BRIDGE_SCOPES[c * 2 // BRIDGE_CONNECTIONS]


def bridge_frames(traffic, keep=None, waves=None, rows_a_frame=None):
    """The encoded OP_VOTE_BATCH payloads per connection, in send order
    (wave by wave): ``keep`` picks the rows of each (wave, connection)
    list (the cut), all by default; ``waves`` how many waves, all five
    by default; frames of ``rows_a_frame`` rows (``BRIDGE_FRAME_ROWS``).

    A wire call's chain guard walks a session's votes within a frame but
    checks a later frame's against the tail the session kept, so a vote
    after one refused as ALREADY_REACHED passes in the same frame and is
    RECEIVED_HASH_MISMATCH in the next (the JAX engine's rule). Statuses
    compare across arms only where every frame holds at most one vote of
    a proposal: a quarter is wider than a frame, and the cut's frames are
    no wider than its share of a quarter."""
    from hashgraph_tpu_torch.bridge import protocol as P

    rows_a_frame = rows_a_frame or BRIDGE_FRAME_ROWS
    width = len(keep) if keep is not None else len(traffic["rows"][0][0])
    if rows_a_frame > width // WAL_PER_WAVE:
        raise AssertionError("a frame would hold two votes of one proposal")
    out = []
    for c in range(BRIDGE_CONNECTIONS):
        frames = []
        for w, wave in enumerate(traffic["rows"][:waves]):
            rows = wave[c] if keep is None else [wave[c][i] for i in keep]
            for i in range(0, len(rows), rows_a_frame):
                frames.append(P.encode_vote_batch(
                    NOW + 1 + w, [(BRIDGE_PEER, scope_of(c), rows[i:i + rows_a_frame])]))
        out.append(frames)
    return out


def send_proposals(server, items, now=NOW):
    """``items`` ((scope, proposal bytes)) as pipelined OP_PROCESS_PROPOSAL
    frames on one connection; fails on any non-OK answer."""
    from hashgraph_tpu_torch.bridge import PipelinedBridgeClient
    from hashgraph_tpu_torch.bridge import protocol as P

    with PipelinedBridgeClient(*server.address, timeout=300, max_inflight=BRIDGE_INFLIGHT) as pc:
        futures = [pc.submit(P.OP_PROCESS_PROPOSAL, P.u32(BRIDGE_PEER) + P.string(scope)
                             + P.u64(now) + P.blob(blob)) for scope, blob in items]
        for f in futures:
            f.result(300)


def send_vote_frames(server, frames, dev):
    """One pipelined connection a list of ``frames``, all sending at once;
    returns the statuses per connection (flattened in send order)."""
    from hashgraph_tpu_torch.bridge import PipelinedBridgeClient
    from hashgraph_tpu_torch.bridge import protocol as P
    from hashgraph_tpu_torch.bridge.client import parse_status_list

    clients = [PipelinedBridgeClient(*server.address, timeout=300, max_inflight=BRIDGE_INFLIGHT) for _ in frames]
    out = [None] * len(frames)
    errors = []
    start = threading.Barrier(len(frames) + 1)

    def run(c):
        try:
            start.wait()
            futures = [clients[c].submit(P.OP_VOTE_BATCH, f) for f in frames[c]]
            out[c] = [s for f in futures for s in parse_status_list(f.result(300))]
        except Exception as exc:  # surfaced below: any failed frame fails the phase
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(c,)) for c in range(len(frames))]
    for t in threads:
        t.start()
    start.wait()
    for t in threads:
        t.join()
    for c in clients:
        c.close()
    if errors:
        raise AssertionError(f"a vote frame failed: {errors[0]!r}")
    return out


def phase_bridge_arm(dev, frames, proposals, reactor):
    """(b) on one fresh server: ADD_PEER, the proposals, the vote frames
    of every connection at once. Returns the server (still running) and
    what it answered."""
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.bridge import BridgeClient
    from hashgraph_tpu_torch.obs import REACTOR_ROWS_PER_DISPATCH, registry
    from hashgraph_tpu_torch.ops import cuda_ingest

    server = bridge_server(dev, apply_reactor=reactor)
    with BridgeClient(*server.address, timeout=300) as client:
        peer, _ = client.add_peer(b"\x13" * 32)
    if peer != BRIDGE_PEER:
        raise AssertionError(f"(b) the first peer is {peer}")
    send_proposals(server, proposals)
    before, hist = bridge_counters(), registry.histogram(REACTOR_ROWS_PER_DISPATCH).snapshot()
    _build.launches.clear()
    statuses = send_vote_frames(server, frames, dev)
    launches = dict(_build.launches)
    after, hist_after = bridge_counters(), registry.histogram(REACTOR_ROWS_PER_DISPATCH).snapshot()
    moved = {k: after[k] - before[k] for k in after}
    if (moved["WIRE_FALLBACK_FRAMES_TOTAL"] or moved["BRIDGE_ERRORS_TOTAL"]
            or moved["BRIDGE_RETRY_AFTER_TOTAL"]):
        raise AssertionError(f"(b) counters moved on canonical traffic: {moved}")
    with BridgeClient(*server.address, timeout=300) as client:
        stats = [client.get_stats(BRIDGE_PEER, s) for s in BRIDGE_SCOPES]
        fingerprint = client.state_fingerprint(BRIDGE_PEER)
    n_rows = sum(len(s) for s in statuses)
    dispatches = moved["WIRE_DEVICE_DISPATCHES_TOTAL"]
    reactor_rows = hist_after["sum"] - hist["sum"]
    reactor_windows = hist_after["count"] - hist["count"]
    return server, dict(
        statuses=statuses, n_rows=n_rows,
        launches=launches, scan=launches.get(cuda_ingest.KERNEL, 0), moved=moved,
        stats=stats, fingerprint=fingerprint, dispatches=dispatches,
        rows_per_dispatch=moved["WIRE_APPLY_ROWS_TOTAL"] / max(dispatches, 1),
        reactor_rows_per_dispatch=(reactor_rows / reactor_windows) if reactor_windows else None)


def small_calls(server, seed):
    """(c): fresh proposals of 64 voters, then one OP_PROCESS_VOTE frame a
    proposal, each sent after the previous answered. Returns the statuses
    and the launches of the calls."""
    from hashgraph_tpu_torch import StubConsensusSigner, _build, build_vote, protocol
    from hashgraph_tpu_torch.bridge import BridgeClient, BridgeError
    from hashgraph_tpu_torch.wire import Proposal

    rng = random.Random(seed)
    pids = rng.sample(range(1, 2**32), BRIDGE_SMALL_CALLS)
    props = [Proposal(name=f"s{i}", payload=b"", proposal_id=pid, proposal_owner=b"smoke",
                      expected_voters_count=WAL_VOTERS, timestamp=NOW,
                      expiration_timestamp=NOW + 3600, liveness_criteria_yes=True)
             for i, pid in enumerate(pids)]
    ids = random.Random(seed + 1)
    protocol.set_id_entropy(lambda: ids.getrandbits(128))
    try:
        signer = StubConsensusSigner(b"small-voter")
        votes = [build_vote(p, True, signer, NOW + 1).encode() for p in props]
    finally:
        protocol.set_id_entropy(None)
    send_proposals(server, [("small", p.encode()) for p in props])
    codes = []
    _build.launches.clear()
    with BridgeClient(*server.address, timeout=300) as client:
        for vote in votes:
            try:
                client.process_vote(BRIDGE_PEER, "small", vote, NOW + 1)
                codes.append(0)
            except BridgeError as exc:
                codes.append(exc.status)
    return dict(codes=codes, launches=dict(_build.launches))


def phase_bridge_quickstart(dev):
    """(a): the C embedder and the port's client run the README
    quick-start against a port server on the card (default engines and
    Ethereum signers), then the read opcodes."""
    import shutil

    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.bridge import BridgeClient, BridgeServer
    from hashgraph_tpu_torch.bridge import protocol as P
    from hashgraph_tpu_torch.sync import state_fingerprint

    root = Path(__file__).resolve().parent
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise AssertionError("(a) no C compiler")
    binary = root / "hashgraph_tpu_torch" / "_build" / "bridge_client"
    binary.parent.mkdir(exist_ok=True)
    built = subprocess.run([cc, "-O2", "-o", str(binary), str(root / "native" / "bridge_client.c")],
                           capture_output=True, text=True, timeout=120)
    if built.returncode != 0:
        raise AssertionError(f"(a) the C client did not build: {built.stderr[-2000:]}")
    _build.launches.clear()
    with BridgeServer(device=dev) as server:
        proc = subprocess.run([str(binary), *map(str, server.address)], capture_output=True,
                              text=True, timeout=120)
        if proc.returncode != 0 or "QUICKSTART PASS" not in proc.stdout or not all(
                f"{name}: consensus YES" in proc.stdout for name in ("alice", "bob", "carol")):
            raise AssertionError(f"(a) the C client: {proc.returncode} {proc.stdout[-2000:]} "
                                 f"{proc.stderr[-2000:]}")
        with BridgeClient(*server.address) as cl:
            peers = [cl.add_peer()[0] for _ in range(3)]
            pid, _ = cl.create_proposal(peers[0], "qs", NOW, "upgrade", b"ship", 3, 600)
            cl.cast_vote(peers[0], "qs", pid, True, NOW + 1)
            proposal = cl.get_proposal(peers[0], "qs", pid)
            for peer in peers[1:]:
                cl.process_proposal(peer, "qs", proposal, NOW + 2)
            for i, voter in enumerate(peers[1:], start=1):
                vote = cl.cast_vote(voter, "qs", pid, True, NOW + 2 + i)
                for other in peers:
                    if other != voter:
                        try:
                            cl.process_vote(other, "qs", vote, NOW + 3 + i)
                        except Exception as exc:  # the last vote lands after the decision
                            if getattr(exc, "status", None) != 28:
                                raise
            for peer in peers:
                engine = server.peer_engine(peer)
                if engine.pool().device.type != torch.device(dev).type:
                    raise AssertionError("(a) the server's engine is not on the card")
                if cl.get_result(peer, "qs", pid) is not True or not any(
                        e.kind == P.EVENT_REACHED and e.proposal_id == pid and e.result
                        for e in cl.poll_events(peer)):
                    raise AssertionError(f"(a) peer {peer} did not reach YES with an event")
            explain = cl.explain(peers[0], "qs", pid)
            health = cl.health(peers[0], NOW + 10)
            metrics = cl.get_metrics()
            fingerprint = cl.state_fingerprint(peers[0])
            tally = cl.fleet_tally(peers[0])
            if (explain["status"] != "reached" or "peers" not in health
                    or "bridge_errors_total" not in metrics or sum(tally.values()) != 256
                    or fingerprint != state_fingerprint(server.peer_engine(peers[0]))):
                raise AssertionError("(a) a read opcode answered wrong")
    return dict(launches=dict(_build.launches))


def phase_bridge_config3(dev):
    """(b) and (c): config 3 over a socket, reactor off, reactor on (each
    on a fresh server on the card) and on a CPU-engine server cut to
    ``BRIDGE_CUT`` proposals; then (c)'s small calls on the two servers
    on the card."""
    from hashgraph_tpu_torch.bridge.reactor import ApplyReactor
    from hashgraph_tpu_torch.errors import StatusCode

    # A frame that fills a default window alone keeps the reactor from
    # merging two frames of one connection: a merged call walks the chain
    # guard across a refused vote that separate calls check against the
    # session's kept tail (the JAX package's rule, ROADMAP queue 3), and
    # the arms' statuses would differ.
    if BRIDGE_FRAME_ROWS < ApplyReactor().max_rows:
        raise AssertionError("(b) a frame must fill a default reactor window")
    traffic = bridge_traffic()
    frames = bridge_frames(traffic)
    share = traffic["share"]
    cut_frames = bridge_frames(traffic, traffic["cut"], rows_a_frame=share)
    q = BRIDGE_PROPOSALS // BRIDGE_CONNECTIONS
    items = [(scope_of(k // q), blob) for k, blob in enumerate(traffic["proposals"])]
    cut_items = [items[c * q + k] for c in range(BRIDGE_CONNECTIONS) for k in range(share)]
    arms, small = {}, {}
    for name, reactor in (("off", False), ("on", True)):
        server, arms[name] = phase_bridge_arm(dev, frames, items, reactor)
        try:
            if name == "off":
                skip = {(scope_of(k // q), traffic["pids"][k]) for k in range(BRIDGE_PROPOSALS)
                        if k % q >= share}
                arms[name]["cut_fingerprint"] = tier_fingerprints(
                    server.peer_engine(BRIDGE_PEER), skip)[0]
            small[name] = small_calls(server, 140)
        finally:
            server.stop()
        del server
    server, cpu = phase_bridge_arm("cpu", cut_frames, cut_items, False)
    server.stop()
    del server
    off, on = arms["off"], arms["on"]
    compare("(b) statuses, reactor on", on["statuses"], off["statuses"])
    compare("(b) fingerprint, reactor on", on["fingerprint"], off["fingerprint"])
    compare("(b) scope stats, reactor on", on["stats"], off["stats"])
    cut_statuses = []
    for c in range(BRIDGE_CONNECTIONS):
        per_wave = len(off["statuses"][c]) // len(traffic["rows"])
        cut_statuses.append([off["statuses"][c][w * per_wave + i]
                             for w in range(len(traffic["rows"])) for i in traffic["cut"]])
    for c, (got, want) in enumerate(zip(cpu["statuses"], cut_statuses)):
        if got != want:
            diff = [(i // (len(got) // len(traffic["rows"])), i % (len(got) // len(traffic["rows"])),
                     got[i], want[i]) for i in range(len(got)) if got[i] != want[i]]
            raise AssertionError(f"(b) statuses, CPU engine: connection {c} differs at "
                                 f"{len(diff)} rows, first (wave, row, cpu, gpu) {diff[:8]}")
    compare("(b) fingerprint over the cut, CPU engine", cpu["fingerprint"], off["cut_fingerprint"])
    flat = np.concatenate([np.asarray(s) for s in off["statuses"]])
    codes = {StatusCode(c).name: int((flat == c).sum()) for c in np.unique(flat)}
    if not {"OK", "DUPLICATE_VOTE", "ALREADY_REACHED"} <= set(codes):
        raise AssertionError(f"(b) did not reach the expected statuses: {codes}")
    if torch.device(dev).type == "cuda":
        for name in ("off", "on"):
            require_launches(f"(b) reactor {name}", arms[name]["launches"], ["ingest_scan"])
    for name, calls in small.items():
        if set(calls["codes"]) != {0}:
            raise AssertionError(f"(c) reactor {name}: statuses {sorted(set(calls['codes']))}")
    return dict(arms=arms, cpu=cpu, small=small, codes=codes,
                n_frames=sum(len(f) for f in frames),
                cut_traffic=(cut_items, bridge_frames(traffic, traffic["cut"], waves=2,
                                                      rows_a_frame=share)))


def phase_bridge_verify(dev):
    """(d): phase 7's traffic as signed frames on a server whose peers
    verify on the card, against a CPU-engine server with the host signer:
    one OP_PROCESS_VOTES frame of 4,096 votes; on a fresh peer, the same
    votes as one canonical OP_VOTE_BATCH frame through a pipelined
    connection (the reader thread starts its signature batch), then the
    damaged 64-vote frame; on a third peer, the 4,096 votes from four
    pipelined connections at once, each its quarter of the proposals in
    one frame of 1,024, their device batches overlapping (checked against
    the CPU server fed the frames one at a time)."""
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.bridge import BridgeClient, PipelinedBridgeClient
    from hashgraph_tpu_torch.bridge import protocol as P
    from hashgraph_tpu_torch.bridge.client import parse_status_list
    from hashgraph_tpu_torch.errors import StatusCode
    from hashgraph_tpu_torch.signing import Ed25519ConsensusSigner

    scope = "bridge-verify"
    rng = random.Random(150)
    keys = [Ed25519ConsensusSigner(rng.randbytes(32)) for _ in range(VERIFY_KEYS)]
    builder = Run(verify_engine("cpu", Ed25519ConsensusSigner(rng.randbytes(32))))
    n_main = VERIFY_PROPOSALS
    create_seeded(builder, scope, n_main + 4, 151)
    pids = builder.pids[scope]
    blobs = [builder.engine.get_proposal(scope, pid).encode() for pid in pids]
    main_bytes = signed_votes(builder.engine, scope, pids[:n_main], keys, 152)
    blame_bytes = signed_votes(builder.engine, scope, pids[n_main:], keys, 153,
                               corrupt={0: "scalar", 1: "s>=L", 2: "bad-A", 3: "R-sign"})
    del builder
    # Rows of main_bytes: vote j of proposal k at j * n_main + k.
    quarter = n_main // 4
    conc = [[main_bytes[j * n_main + k] for j in range(VERIFY_VOTERS)
             for k in range(c * quarter, (c + 1) * quarter)] for c in range(4)]
    signer_cls = counting_device_signer()
    if torch.device(dev).type != "cuda":
        signer_cls = type("CpuCounting", (signer_cls,), {"device": "cpu"})
    servers = {"gpu": bridge_server(dev, signer_cls), "cpu": bridge_server("cpu", Ed25519ConsensusSigner)}
    out = {}
    try:
        for side, server in servers.items():
            with BridgeClient(*server.address, timeout=300) as cl, \
                    PipelinedBridgeClient(*server.address, timeout=300, max_inflight=BRIDGE_INFLIGHT) as pc:
                peers = [cl.add_peer(bytes([0x21 + i]) * 32)[0] for i in range(3)]
                for peer in peers:
                    for blob in blobs:
                        cl.process_proposal(peer, scope, blob, NOW)
                res = {}
                batches0 = len(signer_cls.batches)
                _build.launches.clear()
                res["process_votes"] = cl.process_votes(peers[0], scope, main_bytes, NOW + 2)
                res["process_votes_launches"] = dict(_build.launches)
                _build.launches.clear()
                res["vote_batch"] = parse_status_list(pc.submit(
                    P.OP_VOTE_BATCH, P.encode_vote_batch(NOW + 2, [(peers[1], scope, main_bytes)]),
                ).result(300))
                res["vote_batch_launches"] = dict(_build.launches)
                _build.launches.clear()
                res["damaged"] = parse_status_list(pc.submit(
                    P.OP_VOTE_BATCH, P.encode_vote_batch(NOW + 3, [(peers[1], scope, blame_bytes)]),
                ).result(300))
                res["damaged_launches"] = dict(_build.launches)
                res["batches"] = list(signer_cls.batches[batches0:]) if side == "gpu" else []
                frames = [[P.encode_vote_batch(NOW + 2, [(peers[2], scope, rows)])]
                          for rows in conc]
            if side == "gpu":
                _build.launches.clear()
                res["concurrent"] = send_vote_frames(server, frames, dev)
                res["concurrent_launches"] = dict(_build.launches)
                res["concurrent_batches"] = list(signer_cls.batches[batches0 + len(res["batches"]):])
            else:
                with PipelinedBridgeClient(*server.address, timeout=300, max_inflight=BRIDGE_INFLIGHT) as pc:
                    res["concurrent"] = [[s for f in fr for s in parse_status_list(
                        pc.submit(P.OP_VOTE_BATCH, f).result(300))] for fr in frames]
            out[side] = res
    finally:
        for server in servers.values():
            server.stop()
    gpu, cpu = out["gpu"], out["cpu"]
    for key in ("process_votes", "vote_batch", "damaged", "concurrent"):
        compare(f"(d) {key} statuses", gpu[key], cpu[key])
    batches = gpu["batches"]
    if [b["items"] for b in batches[:2]] != [len(main_bytes)] * 2 or any(
            b["fallback"] for b in batches[:2]) or len(batches) != 3 or not batches[2]["fallback"]:
        raise AssertionError(f"(d) device batches {batches}")
    conc_batches = gpu["concurrent_batches"]
    if len(conc_batches) != 4 or any(b["fallback"] for b in conc_batches):
        raise AssertionError(f"(d) concurrent frames' batches {conc_batches}")
    codes = {StatusCode(c).name: gpu["vote_batch"].count(c) for c in sorted(set(gpu["vote_batch"]))}
    damaged = {StatusCode(c).name: gpu["damaged"].count(c) for c in sorted(set(gpu["damaged"]))}
    if set(codes) - {"OK", "ALREADY_REACHED"} or damaged.get("INVALID_VOTE_SIGNATURE") != 4:
        raise AssertionError(f"(d) statuses {codes}, damaged frame {damaged}")
    if torch.device(dev).type == "cuda":
        for key in ("process_votes_launches", "vote_batch_launches"):
            require_launches(f"(d) {key}", gpu[key], VERIFY_KERNELS, {"msm_windows": 1})
        require_launches("(d) the concurrent frames", gpu["concurrent_launches"],
                         VERIFY_KERNELS, {"msm_windows": 4})
    gpu.update(codes=codes, damaged_codes=damaged, n=len(main_bytes))
    return gpu


def phase_bridge_durable(dev, traffic_cut):
    """(e): a server with a WAL takes the cut's proposals and waves 1-2 on
    a key-carrying peer and stops; a new server on the same directory
    recovers the peer when the key is re-added; its snapshot travels over
    OP_SYNC_MANIFEST and OP_SYNC_CHUNK into a fresh GPU engine; its log's
    tail after a mid-log LSN over OP_WAL_TAIL."""
    import hashlib
    import tempfile

    from hashgraph_tpu_torch import InMemoryConsensusStorage, StubConsensusSigner
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.bridge import BridgeClient
    from hashgraph_tpu_torch.sync import decode_snapshot, state_fingerprint
    from hashgraph_tpu_torch.wal.segment import list_segments, scan_segment

    items, frames = traffic_cut
    key = b"\x17" * 32
    with tempfile.TemporaryDirectory(prefix="chip-smoke-bridge-") as root:
        server = bridge_server(dev, wal_dir=root)
        try:
            with BridgeClient(*server.address, timeout=300) as cl:
                peer, identity = cl.add_peer(key)
            send_proposals(server, items)
            send_vote_frames(server, frames, dev)
            with BridgeClient(*server.address, timeout=300) as cl:
                before = cl.state_fingerprint(peer)
            wal = server.durable_engine(identity).wal
            last_lsn, directory = wal.last_lsn, wal.directory
        finally:
            server.stop()
        del server
        server = bridge_server(dev, wal_dir=root)
        try:
            _build.launches.clear()
            with BridgeClient(*server.address, timeout=600) as cl:
                peer2, identity2 = cl.add_peer(key)
                recovery_launches = dict(_build.launches)
                stats = server.recovery_stats(identity2)
                if identity2 != identity or stats is None or stats.segments_dropped or stats.errors:
                    raise AssertionError(f"(e) recovery: {stats}")
                after = cl.state_fingerprint(peer2)
                compare("(e) fingerprint after recovery", after, before)
                manifest = cl.sync_manifest(peer2, 1 << 20)
                chunks = [cl.sync_chunk(peer2, manifest["snapshot_id"], i)
                          for i in range(manifest["chunk_count"])]
                if [hashlib.sha256(c).digest() for c in chunks] != manifest["digests"] or sum(
                        map(len, chunks)) != manifest["total_bytes"]:
                    raise AssertionError("(e) a snapshot chunk does not match its digest")
                watermark, sessions, configs = decode_snapshot(chunks)
                if watermark != manifest["watermark"] or len(sessions) != manifest["session_count"]:
                    raise AssertionError(f"(e) snapshot watermark {watermark} / {manifest}")
                fresh = bridge_factory(dev)(StubConsensusSigner(key))
                storage = InMemoryConsensusStorage()
                for scope, config in configs:
                    storage.set_scope_config(scope, config)
                    fresh.set_scope_config(scope, config)
                for scope, session in sessions:
                    storage.save_session(scope, session)
                fresh.load_from_storage(storage)
                compare("(e) fingerprint of the restored snapshot", state_fingerprint(fresh), before)
                del fresh
                mid = last_lsn // 2
                served, after_lsn, more = [], mid, True
                while more:
                    records, more = cl.wal_tail(peer2, after_lsn)
                    served += records
                    after_lsn = records[-1][0] if records else after_lsn
                on_disk = [r for _, path in list_segments(directory)
                           for r in scan_segment(path)[0] if r[0] > mid]
                if served != on_disk or not served or served[0][0] != mid + 1:
                    raise AssertionError(f"(e) the tail after LSN {mid}: {len(served)} records "
                                         f"served, {len(on_disk)} in the log")
        finally:
            server.stop()
    return dict(recovery_launches=recovery_launches,
                sync_bytes=manifest["total_bytes"], chunks=manifest["chunk_count"],
                sessions=len(sessions), records=stats.records_applied, tail=len(served),
                last_lsn=last_lsn, mid=mid)


def bridge_launches(bridge, kernel):
    """One kernel's launches in each step of phase 13, for the kernel line."""
    b, d = bridge["b"], bridge["d"]
    steps = {
        "quickstart": bridge["quick"]["launches"],
        "config3_reactor_off": b["arms"]["off"]["launches"],
        "config3_reactor_on": b["arms"]["on"]["launches"],
        "small_calls_reactor_off": b["small"]["off"]["launches"],
        "small_calls_reactor_on": b["small"]["on"]["launches"],
        "signed_process_votes": d["process_votes_launches"],
        "signed_vote_batch": d["vote_batch_launches"],
        "signed_damaged_frame": d["damaged_launches"],
        "signed_concurrent_frames": d["concurrent_launches"],
        "durable_recovery": bridge["e"]["recovery_launches"],
    }
    return {step: counts.get(kernel, 0) for step, counts in steps.items()}


def phase_bridge(dev):
    """Phase 13: the bridge on the card ((a)-(e), see the module doc)."""
    errors_before = bridge_counters()["BRIDGE_ERRORS_TOTAL"]
    quick = phase_bridge_quickstart(dev)
    log(f"[bridge] (a) the C embedder (native/bridge_client.c, built with cc) ran the "
        f"quick-start against a port server on the card: QUICKSTART PASS, alice/bob/carol "
        f"consensus YES; the port's BridgeClient: EVENT_REACHED on all three; OP_EXPLAIN, "
        f"OP_HEALTH, GET_METRICS, OP_STATE_FINGERPRINT (equal to sync.state_fingerprint of "
        f"the peer's engine) and OP_FLEET_TALLY answered; launches "
        f"{json.dumps(quick['launches'])}")
    b = phase_bridge_config3(dev)
    for name in ("off", "on"):
        arm = b["arms"][name]
        rpd = (f"; reactor windows' rows per dispatch {arm['reactor_rows_per_dispatch']:.1f}"
               if arm["reactor_rows_per_dispatch"] is not None else "")
        log(f"[bridge] (b) reactor {name}: {arm['n_rows']} votes in {b['n_frames']} OP_VOTE_BATCH "
            f"frames of up to {BRIDGE_FRAME_ROWS} rows from {BRIDGE_CONNECTIONS} pipelined "
            f"connections after {BRIDGE_PROPOSALS} proposals as OP_PROCESS_PROPOSAL frames; "
            f"ingest_wire_columnar dispatches {arm['dispatches']} "
            f"({arm['rows_per_dispatch']:.1f} rows a dispatch){rpd}; ingest_scan launches "
            f"{arm['scan']}")
    cpu = b["cpu"]
    log(f"[bridge] (b) CPU engine (device='cpu'), cut to {BRIDGE_CUT} proposals: {cpu['n_rows']} "
        f"votes, dispatches {cpu['dispatches']} ({cpu['rows_per_dispatch']:.1f} rows a "
        f"dispatch); per-row statuses equal across the three arms (the CPU arm on its rows), "
        f"state fingerprints equal (the CPU arm's to the card's over the same {BRIDGE_CUT} "
        f"sessions), scope stats {b['arms']['off']['stats']} equal on and off; statuses "
        f"{b['codes']}; wire fallback frames and bridge errors unmoved")
    for name, calls in b["small"].items():
        log(f"[bridge] (c) reactor {name}: {len(calls['codes'])} OP_PROCESS_VOTE frames one at a "
            f"time, each a first vote on a fresh proposal of 64 voters, all OK; launches "
            f"{json.dumps(calls['launches'])}")
    d = phase_bridge_verify(dev)
    log(f"[bridge] (d) {d['n']} Ed25519-signed votes on a server whose peers verify on the card: "
        f"one OP_PROCESS_VOTES frame (launches {json.dumps(d['process_votes_launches'])}) and "
        f"one OP_VOTE_BATCH frame on a fresh peer (launches "
        f"{json.dumps(d['vote_batch_launches'])}), each one device batch of {d['n']} with no "
        f"fallback; the damaged frame's batch fell back to the host blame, "
        f"{d['damaged_codes']}; four pipelined connections at once, one frame of 1,024 each: "
        f"4 device batches, none fell back; every status equal to a CPU-engine server with "
        f"the host signer")
    e = phase_bridge_durable(dev, b["cut_traffic"])
    log(f"[bridge] (e) a durable peer ({BRIDGE_CUT} proposals, waves 1-2) recovered by a new "
        f"server on its WAL ({e['records']} records, launches "
        f"{json.dumps(e['recovery_launches'])}) to the fingerprint before the stop; "
        f"OP_SYNC_MANIFEST and {e['chunks']} OP_SYNC_CHUNKs ({e['sessions']} sessions, "
        f"{e['sync_bytes']} B), every chunk's digest checked, restored into a fresh GPU engine "
        f"to the same fingerprint; OP_WAL_TAIL after LSN {e['mid']} of {e['last_lsn']} served "
        f"exactly the {e['tail']} later records")
    errors = bridge_counters()["BRIDGE_ERRORS_TOTAL"] - errors_before
    if errors:
        raise AssertionError(f"phase 13 answered {errors} frames with a bridge-level error")
    return dict(quick=quick, b=b, d=d, e=e)


# ── Phase 14: gossip, catch-up and the chaos simulator ─────────────────

# Config 3 cut in depth: to 2,000 as in phases 10, 11 and 13 until phase 16
# came, then to 500 to keep the whole run under 1,000 s.
GOSSIP_PROPOSALS = 500
GOSSIP_PEERS = 4  # servers of the fabric, as bench.py::run_gossip's 4 peers
GOSSIP_CHUNK = WAL_PER_WAVE  # votes a submit (run_gossip's chunks of 16)
GOSSIP_CAPACITY = 4_096  # the phase's engines: every session of the cut fits
GOSSIP_VOTER_CAPACITY = WAL_VOTERS
GOSSIP_CPU_FRAME_SESSIONS = 64  # chunks in one OP_VOTE_BATCH frame of the CPU arm
GOSSIP_FLUSH_VOTES = 512  # the driver's coalescer window, as run_gossip's
# The driver's send queue a peer: room for the whole traffic (about 26 MB
# of stub-signed votes), so arm 1, which has no repair, sheds nothing.
GOSSIP_QUEUE_BYTES = 64 << 20
GOSSIP_KEY = b"\x14" * 32
CATCHUP_KEYS = 64  # Ed25519 keys voting on the source, as phase 7's
CATCHUP_TAIL_WAVE = WAL_WAVES - 1  # the wave that arrives after the snapshot
SIM_SEED = 424242  # the seed of the reference's tests/test_sim.py
SIM_DEVICE_SIGNER = ("expired-spam-burst", "columnar-wire-storm")


def gossip_factory(dev):
    """The engines of phase 14's servers and joiners: every session of the
    cut fits."""
    return bridge_factory(dev, GOSSIP_CAPACITY, GOSSIP_VOTER_CAPACITY)


def gossip_server(dev, signer_cls=None, **kwargs):
    """A started port server on ``dev`` over :func:`gossip_factory`'s
    engines with one key-carrying peer (``BRIDGE_PEER``)."""
    from hashgraph_tpu_torch.bridge import BridgeClient

    server = bridge_server(dev, signer_cls, gossip_factory(dev), **kwargs)
    with BridgeClient(*server.address, timeout=300) as client:
        peer, identity = client.add_peer(GOSSIP_KEY)
    if peer != BRIDGE_PEER:
        raise AssertionError(f"phase 14: the first peer is {peer}")
    return server, identity


def fingerprint_of(server):
    from hashgraph_tpu_torch.bridge import BridgeClient

    with BridgeClient(*server.address, timeout=300) as client:
        return client.state_fingerprint(BRIDGE_PEER)


def gossip_traffic(seed=140):
    """The cut's proposals (seeded ids; the first half in the gossipsub
    scope, the second in the P2P one) and their stub-signed chains of 64
    votes (:func:`wire_waves`), as the chunks a gossip driver submits:
    ``chunks[w][k]`` is wave ``w``'s 16 votes of proposal ``k``."""
    from hashgraph_tpu_torch.wire import Proposal

    rng = random.Random(seed)
    n = GOSSIP_PROPOSALS
    pids = rng.sample(range(1, 2**32), n)
    scopes = [BRIDGE_SCOPES[k * 2 // n] for k in range(n)]
    items = [(scopes[k], Proposal(
        name=f"g{k}", payload=k.to_bytes(4, "little"), proposal_id=pid,
        proposal_owner=b"smoke", expected_voters_count=WAL_VOTERS, timestamp=NOW,
        expiration_timestamp=NOW + 3600, liveness_criteria_yes=k % 4 < 2,
    ).encode()) for k, pid in enumerate(pids)]
    waves = wire_waves(pids, seed + 1)[:WAL_WAVES]
    chunks = [[[rows[j * n + k] for j in range(WAL_PER_WAVE)] for k in range(n)]
              for rows, *_ in waves]
    return dict(pids=pids, scopes=scopes, items=items, chunks=chunks)


def session_states(engine):
    """Every session of ``engine``: (state kind, SHA-256 of its proposal
    bytes with the retained chain), from one ``save_to_storage``."""
    import hashlib

    from hashgraph_tpu_torch import InMemoryConsensusStorage

    storage = InMemoryConsensusStorage()
    engine.save_to_storage(storage)
    return {(scope, s.proposal.proposal_id): (s.state.kind, hashlib.sha256(
        s.proposal.encode()).digest()) for scope in storage.list_scopes() or ()
        for s in storage.list_scope_sessions(scope) or ()}


def round_cap_misses(label, states, want):
    """Sessions where ``states`` differs from ``want``: it must be only
    sessions that ``want`` holds failed and ``states`` holds active on the
    same chain. A session failed at the P2P round cap keeps only its
    accepted votes, so a peer that learns it from its chain (anti-entropy)
    or from the WAL (replay) holds it active: the JAX package's faults,
    ROADMAP queue 3. Returns their count."""
    from hashgraph_tpu_torch.session import ConsensusStateKind

    diff = {key for key in set(states) | set(want) if states.get(key) != want.get(key)}
    allowed = {key for key in diff if key in states and key in want
               and want[key][0] == ConsensusStateKind.FAILED
               and states[key] == (ConsensusStateKind.ACTIVE, want[key][1])}
    if diff != allowed:
        raise AssertionError(f"{label}: {len(diff - allowed)} sessions differ other than by "
                             f"a round-cap failure")
    return len(diff)


def gossip_counters():
    import hashgraph_tpu_torch.obs as obs

    names = ("GOSSIP_FRAMES_SENT_TOTAL", "GOSSIP_FRAMES_SHED_TOTAL",
             "GOSSIP_FRAMES_DEFERRED_TOTAL", "GOSSIP_VOTES_COALESCED_TOTAL",
             "GOSSIP_ANTI_ENTROPY_SESSIONS_TOTAL")
    return {name: obs.registry.counter(getattr(obs, name)).value for name in names}


def gossip_arm(dev, traffic, fanout, repair):
    """One arm of (a) on fresh servers: the proposals to every server, then
    every chunk through a ``GossipNode`` to the end of its drain. Arm 1 (``repair`` False): a driver with no engine fans
    out to all the servers. Arm 2: the node owns the first server's engine
    (applying on this thread), samples ``fanout`` of the others, and runs
    anti-entropy rounds until the fingerprints agree."""
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.gossip import GossipNode, GossipTransport

    servers = [gossip_server(dev)[0] for _ in range(GOSSIP_PEERS)]
    node = transport = None
    try:
        for server in servers:
            send_proposals(server, traffic["items"])
        engine = servers[0].peer_engine(BRIDGE_PEER) if repair else None
        targets = servers[1:] if repair else servers
        transport = GossipTransport(max_queue_bytes=GOSSIP_QUEUE_BYTES)
        node = GossipNode("phase14", engine=engine, transport=transport, fanout=fanout,
                          seed=14, flush_votes=GOSSIP_FLUSH_VOTES)
        for i, server in enumerate(targets):
            node.add_peer(f"peer{i}", *server.address, BRIDGE_PEER)
        before = gossip_counters()
        _build.launches.clear()
        for wave in traffic["chunks"]:
            for k, chunk in enumerate(wave):
                node.submit_votes(traffic["scopes"][k], traffic["pids"][k], chunk, NOW + 1,
                                  local=repair)
        report = node.drain(timeout=600)
        rounds = 0
        prints = [fingerprint_of(s) for s in servers]
        while repair and len(set(prints)) > 1 and rounds < 8:
            done = node.anti_entropy(NOW + 1, max_sessions=GOSSIP_PROPOSALS, window=64,
                                     timeout=600)
            rounds += 1
            prints = [fingerprint_of(s) for s in servers]
            if not done["created_or_extended"]:
                break  # nothing left that a chain can repair
        launches = dict(_build.launches)
        after = gossip_counters()
        states = [session_states(s.peer_engine(BRIDGE_PEER)) for s in servers]
    finally:
        if node is not None:
            node.close()
        if transport is not None:
            transport.close()
        for server in servers:
            server.stop()
    if report["failed_frames"] or (not repair and report["shed_total"]):
        raise AssertionError(f"(a) gossip frames failed or shed: {report}")
    return dict(report=report, rounds=rounds, fingerprints=prints, launches=launches, states=states,
                moved={k: after[k] - before[k] for k in after})


def gossip_cpu_arm(traffic):
    """(a)'s reference: a ``device="cpu"`` server fed the same chunks
    directly, wave by wave, as OP_VOTE_BATCH frames of 64 chunks."""
    from hashgraph_tpu_torch.bridge import protocol as P

    server, _ = gossip_server("cpu")
    try:
        send_proposals(server, traffic["items"])
        frames = []
        n = GOSSIP_PROPOSALS
        for wave in traffic["chunks"]:
            for lo in range(0, n, GOSSIP_CPU_FRAME_SESSIONS):
                groups = [(BRIDGE_PEER, traffic["scopes"][k], wave[k])
                          for k in range(lo, min(lo + GOSSIP_CPU_FRAME_SESSIONS, n))]
                frames.append(P.encode_vote_batch(NOW + 1, groups))
        send_vote_frames(server, [frames], "cpu")
        return fingerprint_of(server), session_states(server.peer_engine(BRIDGE_PEER))
    finally:
        server.stop()


def phase_gossip(dev):
    """(a): the gossip fabric over 4 port servers on the card."""
    traffic = gossip_traffic()
    want, want_states = gossip_cpu_arm(traffic)
    arms = {"fanout_all": gossip_arm(dev, traffic, GOSSIP_PEERS, False),
            "fanout_2_anti_entropy": gossip_arm(dev, traffic, 2, True)}
    full = arms["fanout_all"]
    if set(full["fingerprints"]) != {want}:
        raise AssertionError(f"(a) fanout_all: fingerprints {full['fingerprints']}, the CPU "
                             f"server's {want}")
    # Sampled fan-out and anti-entropy: every server equals the CPU server
    # but for sessions failed at the P2P round cap on it, which a server
    # that learnt them by repair holds active on the same chain.
    repaired = arms["fanout_2_anti_entropy"]
    repaired["misses"] = [round_cap_misses("(a) fanout_2_anti_entropy", states, want_states)
                          for states in repaired.pop("states")]
    full.pop("states")
    for name, arm in arms.items():
        require_launches(f"(a) {name}", arm["launches"], ("ingest_scan",))
    failed = sum(1 for kind, _ in want_states.values() if kind.name == "FAILED")
    return dict(arms=arms, fingerprint=want, failed=failed)


def catchup_traffic(seed=141):
    """(b)'s traffic: the cut's proposals (as :func:`gossip_traffic`'s) and
    a chain of 64 votes each from 64 Ed25519 keys, every signature made by
    the native runtime on 8 threads, as OP_VOTE_BATCH frames a wave at a
    time (vote j of every proposal of a scope, then vote j + 1; 1,024 rows
    a frame)."""
    from concurrent.futures import ThreadPoolExecutor

    from hashgraph_tpu_torch import Ed25519ConsensusSigner, build_vote, native, protocol
    from hashgraph_tpu_torch.bridge import protocol as P
    from hashgraph_tpu_torch.wire import Proposal

    traffic = gossip_traffic(seed)
    rng = random.Random(seed)
    keys = [Ed25519ConsensusSigner(rng.randbytes(32)) for _ in range(CATCHUP_KEYS)]
    unsigned = [_Unsigned(k) for k in keys]
    seed_of = {k.identity(): k.private_key_bytes() for k in keys}
    n = GOSSIP_PROPOSALS
    shadows = [Proposal.decode(blob) for _, blob in traffic["items"]]
    protocol.set_id_entropy(lambda: rng.getrandbits(128))
    try:
        for j in range(WAL_VOTERS):
            for k, shadow in enumerate(shadows):
                shadow.votes.append(build_vote(shadow, rng.random() < 0.6,
                                               unsigned[(k + j) % CATCHUP_KEYS], NOW + 1))
    finally:
        protocol.set_id_entropy(None)
    votes = [v for shadow in shadows for v in shadow.votes]
    with ThreadPoolExecutor(8) as pool:
        sigs = list(pool.map(lambda v: native.ed25519_sign(seed_of[v.vote_owner],
                                                           v.signing_payload()),
                             votes, chunksize=512))
    if any(s is None for s in sigs):
        raise AssertionError("the native runtime did not sign")
    for vote, sig in zip(votes, sigs):
        vote.signature = sig
    waves = []
    for w in range(WAL_WAVES):
        frames = []
        for scope in BRIDGE_SCOPES:
            ks = [k for k in range(n) if traffic["scopes"][k] == scope]
            rows = [shadows[k].votes[WAL_PER_WAVE * w + j].encode()
                    for j in range(WAL_PER_WAVE) for k in ks]
            frames += [P.encode_vote_batch(NOW + 1, [(BRIDGE_PEER, scope, rows[i:i + 1024])])
                       for i in range(0, len(rows), 1024)]
        waves.append(frames)
    return dict(items=traffic["items"], waves=waves, signed=len(votes))


class SourceBridge:
    """The catch-up client's transport to the source: a ``BridgeClient``
    whose ``after_chunks`` runs once, when the last chunk of the snapshot
    has arrived (more votes reach the source there, after the snapshot's
    watermark, so that the tail is not empty)."""

    def __init__(self, address, after_chunks=None):
        from hashgraph_tpu_torch.bridge import BridgeClient

        self.client = BridgeClient(*address, timeout=600)
        self.after_chunks = after_chunks
        self.manifest = None

    def sync_manifest(self, peer, max_chunk_bytes=0):
        self.manifest = self.client.sync_manifest(peer, max_chunk_bytes)
        return self.manifest

    def sync_chunk(self, peer, snapshot_id, index):
        data = self.client.sync_chunk(peer, snapshot_id, index)
        if index == self.manifest["chunk_count"] - 1 and self.after_chunks is not None:
            hook, self.after_chunks = self.after_chunks, None
            hook()
        return data

    def wal_tail(self, peer, after_lsn, max_bytes=0):
        return self.client.wal_tail(peer, after_lsn, max_bytes)

    def close(self):
        self.client.close()


class ServedSnapshot:
    """A source that serves a given snapshot stream and an empty tail (the
    transport a ``CatchUpClient`` takes as ``bridge``)."""

    def __init__(self, data, watermark, sessions, configs, chunk_bytes=1 << 20):
        import hashlib

        self.chunks = [data[i:i + chunk_bytes] for i in range(0, len(data), chunk_bytes)]
        self.manifest = dict(
            snapshot_id=1, watermark=watermark, total_bytes=len(data), chunk_bytes=chunk_bytes,
            session_count=sessions, config_count=configs, chunk_count=len(self.chunks),
            digests=[hashlib.sha256(c).digest() for c in self.chunks])

    def sync_manifest(self, peer, max_chunk_bytes=0):
        return dict(self.manifest)

    def sync_chunk(self, peer, snapshot_id, index):
        return self.chunks[index]

    def wal_tail(self, peer, after_lsn, max_bytes=0):
        return [], False

    def close(self):
        pass


def tampered_stream(chunks):
    """The snapshot stream with one byte of one signature's scalar flipped
    (byte 40, the middle vote of the middle session; the scalar stays below
    L, so the batch's combination fails and the host blame names the vote),
    every frame re-encoded with its CRC: the stream decodes and every
    digest checks, only the signature is wrong."""
    from hashgraph_tpu_torch.sync import snapshot as S

    frames = list(S.iter_snapshot_frames(chunks))
    sessions = [i for i, (kind, _) in enumerate(frames) if kind == S.ITEM_SESSION]
    at = sessions[len(sessions) // 2]
    scope, session = S.decode_session_item(frames[at][1])
    vote = session.proposal.votes[len(session.proposal.votes) // 2]
    vote.signature = vote.signature[:40] + bytes([vote.signature[40] ^ 0x01]) + vote.signature[41:]
    frames[at] = (S.ITEM_SESSION, S.encode_session_item(scope, session))
    watermark = S.decode_snapshot(chunks)[0]
    return b"".join(S.encode_frame(kind, payload) for kind, payload in frames), watermark, len(
        sessions), sum(1 for kind, _ in frames if kind == S.ITEM_SCOPE_CONFIG)


def run_catchup(dev, signer, source, how, after_chunks=None):
    """A fresh joiner on ``dev`` signed by ``signer`` catches up from the
    source's peer through ``how`` (``catch_up`` or ``full_replay``).
    Returns its engine, the report and the launches."""
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.sync import CatchUpClient

    engine = gossip_factory(dev)(signer)
    client = CatchUpClient("", 0, BRIDGE_PEER, timeout=600,
                           bridge=SourceBridge(source.address, after_chunks))
    _build.launches.clear()
    report = getattr(client, how)(engine)
    launches = dict(_build.launches)
    client.close()
    return engine, report, launches


def retained_votes(engine):
    return sum(len(engine.get_proposal(scope, pid).votes) for scope, pid in engine.session_keys())


def require_one_batch(batches, replay_batches, items):
    """Fail unless the catch-up verified its snapshot in exactly one device
    batch of ``items`` signatures, with no fallback to the host, one launch
    of ``msm_windows`` and ``fe_pow22523``, the tree's passes of
    ``msm_reduce`` at the batch's MSM lanes, and ``fe_mul``; and the full
    replay verified nothing. Returns the MSM lanes."""
    from hashgraph_tpu_torch.crypto_device import cuda_msm

    lanes = 8
    while lanes < 2 * items + 1:
        lanes *= 2
    want = {"msm_windows": 1, "fe_pow22523": 1,
            "msm_reduce": len(cuda_msm.tree_passes(lanes, cuda_msm._lib().hg_msm_tree_span()))}
    batch = batches[0] if batches else None
    if (len(batches) != 1 or replay_batches or batch["items"] != items
            or batch["fallback"] != 0
            or {k: batch["launches"].get(k, 0) for k in want} != want
            or not batch["launches"].get("fe_mul")):
        raise AssertionError(f"(b) the snapshot was not one device batch of {items} with "
                             f"{want}: {batches}; the full replay verified {replay_batches} "
                             "batches")
    return lanes


def catchup_kernel_times(captured, msm_lanes):
    """Each verification kernel's device time on the snapshot batch's
    inputs (its largest shape), with its bound at that shape."""
    from hashgraph_tpu_torch.crypto_device import cuda_field, cuda_msm, msm

    largest = {}
    for (name, shape), args in captured.seen.items():
        if name not in largest or shape[0] > largest[name][0][0]:
            largest[name] = (shape, args)
    out = {}
    for name, (shape, args) in sorted(largest.items()):
        lanes = shape[0]
        if name == "fe_mul":
            ms = device_ms(lambda: cuda_field.fe_mul(*args), 20)
            n_bytes, n_ops = lanes * FE_MUL_BYTES_PER_LANE, lanes * msm_windows_counts.FE_MUL
        elif name == "fe_pow22523":
            ms = device_ms(lambda: cuda_field.fe_pow22523(*args), 5)
            n_bytes, n_ops = lanes * 2 * 16 * 8, lanes * POW22523_OPS_PER_LANE
        elif name == "msm_windows":
            ms = device_ms(lambda: cuda_msm.msm_windows(*args), 3)
            n_bytes = lanes * (2 * POINT_BYTES + 4 * msm.WINDOWS)
            n_ops = lanes * msm_windows_counts.PER_POINT
        else:
            ms = device_ms(lambda: cuda_msm.msm_reduce(*args), 10)
            n_bytes, n_ops = tree_bound_counts(lanes)
        bound, bound_by = bound_of(n_bytes, n_ops)
        out[name] = dict(shape=list(shape), ms=ms, bound_ms=bound, bound_by=bound_by)
    if out["msm_windows"]["shape"][0] != msm_lanes:
        raise AssertionError(f"(b) the MSM ran at {out['msm_windows']['shape']}, not "
                             f"{msm_lanes} lanes")
    return out


def phase_catchup(dev):
    """(b): a durable port server on the card takes the cut's Ed25519-signed
    chains; GPU joiners catch up (snapshot and tail; full replay) and a CPU
    joiner with the host signer catches up; a tampered snapshot installs
    nothing."""
    import tempfile

    from hashgraph_tpu_torch import Ed25519ConsensusSigner, StubConsensusSigner, _build
    from hashgraph_tpu_torch.bridge import BridgeClient
    from hashgraph_tpu_torch.errors import StatusCode
    from hashgraph_tpu_torch.obs import DEVICE_VERIFY_FALLBACKS_TOTAL, registry
    from hashgraph_tpu_torch.sync import CatchUpClient, SyncVerificationError, state_fingerprint

    traffic = catchup_traffic()
    bad = {int(StatusCode.INVALID_VOTE_SIGNATURE), int(StatusCode.INVALID_VOTE_HASH)}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-catchup-") as root:
        source, identity = gossip_server(dev, signer_cls=Ed25519ConsensusSigner,
                                         wal_dir=root, wal_fsync="batch")
        try:
            send_proposals(source, traffic["items"])
            for w in range(CATCHUP_TAIL_WAVE):
                statuses = send_vote_frames(source, [traffic["waves"][w]], dev)
                if bad & set(statuses[0]):
                    raise AssertionError("(b) the source refused a signature")
            source_engine = source.peer_engine(BRIDGE_PEER)
            retained_at_snapshot = retained_votes(source_engine)

            hook_launches = {}

            def tail_votes():
                from hashgraph_tpu_torch import _build

                before = dict(_build.launches)
                statuses = send_vote_frames(source, [traffic["waves"][CATCHUP_TAIL_WAVE]], dev)
                hook_launches.update({k: v - before.get(k, 0) for k, v in _build.launches.items()})
                if bad & set(statuses[0]):
                    raise AssertionError("(b) the source refused a signature")

            signer_cls = counting_device_signer()
            signer_cls.batches.clear()
            captured = KernelInputs()
            fallbacks = registry.counter(DEVICE_VERIFY_FALLBACKS_TOTAL).value
            with captured.active():
                gpu, gpu_report, gpu_launches = run_catchup(
                    dev, signer_cls(b"\x21" * 32), source, "catch_up", tail_votes)
            if registry.counter(DEVICE_VERIFY_FALLBACKS_TOTAL).value != fallbacks:
                raise AssertionError("(b) the snapshot's device batch fell back to the host")
            # The source's launches while it took the late votes are not the joiner's.
            gpu_launches = {k: v - hook_launches.get(k, 0) for k, v in gpu_launches.items()}
            batches = list(signer_cls.batches)
            signer_cls.batches.clear()
            want = fingerprint_of(source)
            retained = retained_votes(source_engine)
            replay, replay_report, replay_launches = run_catchup(
                dev, signer_cls(b"\x22" * 32), source, "full_replay")
            replay_batches = len(signer_cls.batches)
            cpu, cpu_report, _ = run_catchup(
                "cpu", Ed25519ConsensusSigner(b"\x23" * 32), source, "catch_up")
            prints = {"source": want, "gpu_catch_up": state_fingerprint(gpu),
                      "cpu_catch_up": state_fingerprint(cpu)}
            if len(set(prints.values())) != 1:
                raise AssertionError(f"(b) fingerprints differ: {prints}")
            # The log keeps accepted rows only: a replay holds the sessions
            # failed at the round cap active (ROADMAP queue 3).
            source_states = session_states(source_engine)
            replay_misses = round_cap_misses("(b) full_replay", session_states(replay),
                                             source_states)
            source_failed = sum(1 for kind, _ in source_states.values() if kind.name == "FAILED")
            with BridgeClient(*source.address, timeout=600) as cl:
                manifest = cl.sync_manifest(BRIDGE_PEER)
                chunks = [cl.sync_chunk(BRIDGE_PEER, manifest["snapshot_id"], i)
                          for i in range(manifest["chunk_count"])]
        finally:
            source.stop()
    if gpu_report.votes_verified != retained_at_snapshot or cpu_report.votes_verified != retained:
        raise AssertionError(f"(b) verified {gpu_report.votes_verified} (GPU) and "
                             f"{cpu_report.votes_verified} (CPU) signatures, the source retained "
                             f"{retained_at_snapshot} at the snapshot and {retained} at the end")
    if not gpu_report.tail_records or replay_report.sessions_installed:
        raise AssertionError(f"(b) tail records {gpu_report.tail_records}, full replay "
                             f"installed {replay_report.sessions_installed} sessions")
    snapshot_batch = batches[0] if batches else None
    lanes = require_one_batch(batches, replay_batches, retained_at_snapshot)
    require_launches("(b) catch_up", gpu_launches, VERIFY_KERNELS + ("ingest_scan",))
    require_launches("(b) full_replay", replay_launches, ("ingest_scan",))
    held = hold_captured(captured)
    times = catchup_kernel_times(captured, lanes)

    # A snapshot with one signature byte flipped: nothing installed.
    data, watermark, n_sessions, n_configs = tampered_stream(chunks)
    joiner = gossip_factory(dev)(signer_cls(b"\x24" * 32))
    empty = state_fingerprint(gossip_factory(dev)(StubConsensusSigner(b"empty")))
    client = CatchUpClient("", 0, BRIDGE_PEER, bridge=ServedSnapshot(
        data, watermark, n_sessions, n_configs))
    signer_cls.batches.clear()
    _build.launches.clear()
    try:
        client.catch_up(joiner)
    except SyncVerificationError as exc:
        tamper_error = str(exc)
    else:
        raise AssertionError("(b) the tampered snapshot was installed")
    tamper_launches = dict(_build.launches)
    if state_fingerprint(joiner) != empty or joiner.occupancy().get("live_sessions", 0):
        raise AssertionError("(b) the tampered snapshot left state behind")
    if len(signer_cls.batches) != 1 or not signer_cls.batches[0]["fallback"]:
        raise AssertionError(f"(b) the tampered snapshot's batch did not fail on the card and "
                             f"fall back to the host blame: {signer_cls.batches}")
    return dict(
        signed=traffic["signed"], retained_at_snapshot=retained_at_snapshot,
        retained=retained, lanes=lanes,
        gpu=dict(report=gpu_report, launches=gpu_launches),
        replay=dict(report=replay_report, launches=replay_launches),
        cpu=dict(report=cpu_report),
        batch=snapshot_batch, held=held, times=times, fingerprint=want,
        replay_misses=replay_misses, source_failed=source_failed,
        tamper_error=tamper_error, tamper_launches=tamper_launches)


def phase_sim(dev):
    """(c): every scenario of ``SCENARIOS`` at ``SIM_SEED`` on the card and on
    the CPU, then the device-signer scenarios on the card against the host
    signer on the CPU."""
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.signing import Ed25519ConsensusSigner
    from hashgraph_tpu_torch.sim import SCENARIOS, run_scenario

    def verdict_json(name, device, **kwargs):
        result = run_scenario(name, SIM_SEED, device=device, **kwargs)
        if not result["passed"] or not all(v["ok"] for v in result["verdicts"].values()):
            raise AssertionError(f"(c) {name} on {device}: {result['verdicts']} "
                                 f"{result['checks']}")
        return json.dumps(result, sort_keys=True)

    _build.launches.clear()
    on_card = {name: verdict_json(name, dev) for name in SCENARIOS}
    corpus_launches = dict(_build.launches)
    for name in SCENARIOS:
        compare(f"(c) {name}'s verdict JSON", on_card[name], verdict_json(name, "cpu"))
    signer_cls = counting_device_signer()
    signer_cls.batches.clear()
    _build.launches.clear()
    device_signed = {name: verdict_json(name, dev, signer_factory=signer_cls)
                     for name in SIM_DEVICE_SIGNER}
    signer_launches = dict(_build.launches)
    for name in SIM_DEVICE_SIGNER:
        compare(f"(c) {name}'s verdict JSON, device signer against host", device_signed[name],
                verdict_json(name, "cpu", signer_factory=Ed25519ConsensusSigner))
    require_launches("(c) the corpus", corpus_launches, ("ingest_scan",))
    require_launches("(c) the device signer", signer_launches, VERIFY_KERNELS + ("ingest_scan",))
    return dict(corpus_launches=corpus_launches, signer_launches=signer_launches,
                batches=len(signer_cls.batches),
                fallbacks=sum(1 for b in signer_cls.batches if b["fallback"]),
                n=len(SCENARIOS))


def phase_gossip_sync(dev):
    """Phase 14: gossip, catch-up and the chaos simulator on the card
    ((a)-(c), see the module doc)."""
    a = phase_gossip(dev)
    n_votes = GOSSIP_PROPOSALS * WAL_VOTERS
    for name, arm in a["arms"].items():
        rep, moved = arm["report"], arm["moved"]
        log(f"[gossip] (a) {name}: {n_votes} votes in chunks of {GOSSIP_CHUNK} through a "
            f"GossipNode; acked {rep['acked']}, rejected {rep['rejected']}, frames sent "
            f"{moved['GOSSIP_FRAMES_SENT_TOTAL']}, shed {moved['GOSSIP_FRAMES_SHED_TOTAL']}, "
            f"deferred {moved['GOSSIP_FRAMES_DEFERRED_TOTAL']}; anti-entropy rounds "
            f"{arm['rounds']} ({moved['GOSSIP_ANTI_ENTROPY_SESSIONS_TOTAL']} sessions pushed); "
            f"ingest_scan launches {arm['launches'].get('ingest_scan', 0)}; "
            + (f"{GOSSIP_PEERS} fingerprints equal to the CPU server's" if "misses" not in arm
               else f"sessions differing from the CPU server by a round-cap failure that "
                    f"repair cannot carry, per server: {arm['misses']} (of its {a['failed']} "
                    f"failed sessions); every other session equal"))
    b = phase_catchup(dev)
    batch = b["batch"]
    log(f"[catchup] (b) the source took {b['signed']} Ed25519 votes (signed by the native "
        f"runtime on 8 threads) and retains {b['retained_at_snapshot']} at the snapshot, "
        f"{b['retained']} at the end")
    for name in ("gpu", "replay", "cpu"):
        rep = b[name]["report"]
        log(f"[catchup] (b) {name} joiner ({'full_replay' if name == 'replay' else 'catch_up'})"
            f": {rep.sessions_installed} sessions, {rep.votes_verified} signatures verified, "
            f"{rep.tail_records} tail records ({rep.tail_votes} votes), {rep.snapshot_bytes} "
            f"snapshot bytes in {rep.chunks_fetched} chunks")
    log(f"[catchup] (b) the snapshot's {batch['items']} signatures in one device batch at "
        f"{b['lanes']} MSM lanes, launches {json.dumps(batch['launches'])}; the source's and "
        f"both catch_up joiners' fingerprints equal; the full replay's sessions equal the "
        f"source's but for {b['replay_misses']} of its {b['source_failed']} sessions failed "
        f"at the P2P round cap, active on the same chain after replay")
    for name, t in b["times"].items():
        log(f"[catchup] (b) {name} at {t['shape']}: {t['ms']:.6f} ms, bound {t['bound_ms']:.6f} "
            f"ms by {t['bound_by']}; held against its plain version at {b['held'].get(name)}")
    log(f"[catchup] (b) a snapshot with one signature byte flipped: SyncVerificationError "
        f"({b['tamper_error'][:120]}...), nothing installed; its batch fell back to the host "
        f"blame; launches {json.dumps(b['tamper_launches'])}")
    c = phase_sim(dev)
    log(f"[sim] (c) {c['n']} scenarios at seed {SIM_SEED}, every verdict ok and the verdict "
        f"JSON equal on the card and the CPU; launches {json.dumps(c['corpus_launches'])}")
    log(f"[sim] (c) with the device signer on the card, equal to the host signer on the CPU: "
        f"{', '.join(SIM_DEVICE_SIGNER)}; {c['batches']} device batches, {c['fallbacks']} fell "
        f"back to the host blame; launches {json.dumps(c['signer_launches'])}")
    return dict(a=a, b=b, c=c)


def gossip_sync_launches(out, kernel):
    """One kernel's launches in each step of phase 14, for the kernel line."""
    a, b, c = out["a"], out["b"], out["c"]
    return (
        {arm: a["arms"][arm]["launches"].get(kernel, 0) for arm in a["arms"]},
        {"catch_up": b["gpu"]["launches"].get(kernel, 0),
         "snapshot_batch": b["batch"]["launches"].get(kernel, 0),
         "full_replay": b["replay"]["launches"].get(kernel, 0),
         "tampered_snapshot": b["tamper_launches"].get(kernel, 0)},
        {"corpus": c["corpus_launches"].get(kernel, 0),
         "device_signer": c["signer_launches"].get(kernel, 0)},
    )


# ── Phase 15: placement (slice 13) ─────────────────────────────────────

SHARDS = 4  # blocks of phase 15 (a)'s sharded pool, all on cuda:0
# Phase 15 (b): two processes of one gloo group, one block each on cuda:0,
# config 3's width cut to 2,000 proposals decided by 64 votes each.
MULTIHOST_SCALE = dict(proposals=2_000, voters=64, per_device=1_100,
                       voter_capacity=128, local_devices=1)
MULTIHOST_TIMEOUT = 300  # seconds a worker may take before it is killed


def sharded_engine(mesh):
    from hashgraph_tpu_torch import StubConsensusSigner, TorchConsensusEngine
    from hashgraph_tpu_torch.events import BroadcastEventBus
    from hashgraph_tpu_torch.parallel import ShardedPool

    return TorchConsensusEngine(
        StubConsensusSigner(b"chip-smoke"),
        event_bus=BroadcastEventBus(max_queued_events=10_000_000),
        max_sessions_per_scope=CAPACITY, verify_cache=None,
        pool=ShardedPool(CAPACITY // SHARDS, VOTER_CAPACITY, mesh=mesh),
    )


def all_state_counts(pool):
    """Every slot state's count (zeros included) from the host mirror."""
    from hashgraph_tpu_torch.ops.decide import (
        STATE_ACTIVE, STATE_FAILED, STATE_FREE, STATE_REACHED_NO, STATE_REACHED_YES,
    )

    counts = pool.state_counts()
    return {code: counts.get(code, 0) for code in (
        STATE_FREE, STATE_ACTIVE, STATE_FAILED, STATE_REACHED_NO, STATE_REACHED_YES)}


def phase_sharded(dev):
    """(a) Config 3 on a ShardedPool of four blocks on cuda:0, against phase
    3's single-pool engine on the card and the same ShardedPool on four CPU
    entries."""
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.convert import DEVICE_ARRAYS, pool_to_numpy
    from hashgraph_tpu_torch.ops import cuda_ingest

    single = Run(make_engine(dev))
    single_st = config3_traffic(single, 3)
    gpu = Run(sharded_engine([torch.device("cuda", 0)] * SHARDS))
    # The main path of the phase: counts are zeroed just before it.
    _build.launches.clear()
    gpu_st = config3_traffic(gpu, 3)
    launches = _build.launches[cuda_ingest.KERNEL]
    per_shard = list(gpu.engine.pool().scan_dispatches)
    cpu = Run(sharded_engine([torch.device("cpu")] * SHARDS))
    cpu_st = config3_traffic(cpu, 3)
    runs = {"single GPU pool": single, "sharded CPU pool": cpu}
    seen = {label: (r.outcome("config3"), r.events_by_session()) for label, r in runs.items()}
    mine = (gpu.outcome("config3"), gpu.events_by_session())
    for label, st in (("single GPU pool", single_st), ("sharded CPU pool", cpu_st)):
        compare(f"sharded config 3 statuses against the {label}", gpu_st, st)
        compare(f"sharded config 3 results and stats against the {label}", mine[0], seen[label][0])
        compare(f"sharded config 3 events against the {label}", mine[1], seen[label][1])
    gpu_pool, cpu_pool = gpu.engine.pool(), cpu.engine.pool()
    counts = gpu_pool.global_state_counts()
    compare("sharded global_state_counts against the CPU pool", counts,
            cpu_pool.global_state_counts())
    compare("sharded global_state_counts against the single pool", counts,
            all_state_counts(single.engine.pool()))
    compare("sharded global_state_counts against the host mirror", counts,
            all_state_counts(gpu_pool))
    occupancy = gpu_pool.per_device_occupancy()
    compare("sharded per_device_occupancy", occupancy, cpu_pool.per_device_occupancy())
    if sum(occupancy) != 10_000:
        raise AssertionError(f"sharded occupancy {occupancy} does not hold 10,000 sessions")
    gpu_arrays, cpu_arrays = pool_to_numpy(gpu_pool)[0], pool_to_numpy(cpu_pool)[0]
    for name in DEVICE_ARRAYS:
        if not np.array_equal(gpu_arrays[name], cpu_arrays[name]):
            raise AssertionError(f"sharded pool array {name}: the card's blocks differ "
                                 "from the CPU's")
    if launches == 0 or launches != sum(per_shard) or 0 in per_shard:
        raise AssertionError(f"sharded config 3: {launches} ingest_scan launches, per shard "
                             f"{per_shard} (every shard must launch, once a dispatch)")
    log(f"[placement] (a) config 3 on ShardedPool({CAPACITY // SHARDS}, {VOTER_CAPACITY}, "
        f"mesh=[cuda:0] * {SHARDS}): ingest_scan launches {launches}, per shard "
        f"{per_shard}; statuses, results, stats, events, global counts {counts}, "
        f"occupancy {occupancy} equal to the single pool's and the CPU blocks', every "
        f"pool array equal to the CPU blocks'")
    return dict(launches=launches, per_shard=per_shard)


def phase_multihost():
    """(b) The engine worker of tests/test_torch_multihost.py, two processes
    of one gloo group each holding one block on cuda:0, against the same
    worker on the CPU; both pairs run at once."""
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_multihost as mh

    sides = {"cuda": [], "cpu": []}
    with ThreadPoolExecutor(2) as pool:
        futures = {device: pool.submit(mh.run_engine_workers, "port", device, MULTIHOST_SCALE,
                                       MULTIHOST_TIMEOUT, sides[device])
                   for device in ("cuda", "cpu")}
        observed = {device: f.result() for device, f in futures.items()}
    for rank, (on_card, on_cpu) in enumerate(zip(observed["cuda"], observed["cpu"])):
        compare(f"multi-host rank {rank}'s observations", on_card, on_cpu)
    owned = [set(obs["owned"]) for obs in observed["cuda"]]
    if owned[0] & owned[1] or not owned[0] or not owned[1]:
        raise AssertionError(f"multi-host owned sets overlap or are empty: {owned}")
    launches = [side["launches"].get("ingest_scan", 0) for side in sides["cuda"]]
    dispatches = [side["scan_dispatches"] for side in sides["cuda"]]
    if 0 in launches or launches != [sum(d) for d in dispatches]:
        raise AssertionError(f"multi-host ingest_scan launches {launches}, scan dispatches "
                             f"{dispatches}")
    if any(side["launches"] for side in sides["cpu"]):
        raise AssertionError(f"the CPU workers launched kernels: {sides['cpu']}")
    log(f"[placement] (b) two gloo processes, one MultiHostPool block each on cuda:0, "
        f"{MULTIHOST_SCALE['proposals']} proposals x {MULTIHOST_SCALE['voters']} voters: "
        f"observations equal to the CPU pair's, rank by rank (created pid "
        f"{observed['cuda'][0]['created_pid']}, checkpoint digest "
        f"{observed['cuda'][0]['digest'][:16]}); owned {len(owned[0])} and {len(owned[1])} "
        f"sessions, disjoint; ingest_scan launches per process {launches} (fresh "
        f"processes: their counts start at 0)")
    return dict(launches=launches, owned=[len(o) for o in owned])


def phase_placement(dev):
    a = phase_sharded(dev)
    torch.cuda.empty_cache()
    b = phase_multihost()
    log("[placement] one card checks routing, per-block kernels, summed stats and the gloo "
        "control plane, not placement across GPUs or NCCL")
    return dict(a=a, b=b)


# ── Phase 16: the fleet and the federation (slice 14) ──────────────────

FLEET_SHARDS = 4  # shards of (a) and (b1), all on cuda:0
FLEET_SCOPES = 64  # (a): config 3's proposals spread over these scopes
FED_PROPOSALS = 2_000  # (b): config 3 cut in depth, as in phases 10, 11, 13 and 14
FED_SCOPES = 16
FED_CAPACITY = 2_048  # slots of each shard of (b): every session of the cut fits
FED_WAVES = 3  # (b2): waves of WAL_PER_WAVE votes a proposal through the federation
FED_WORKER_SCALE = dict(proposals=200, voters=64)  # (c): each gloo process's host
FED_TIMEOUT = 300  # seconds a (c) worker may take before it is killed


def fleet_of(dev, capacity, voter_capacity, signer_factory=None, **kw):
    """A ConsensusFleet of FLEET_SHARDS shards, every one on ``dev``."""
    from hashgraph_tpu_torch import StubConsensusSigner
    from hashgraph_tpu_torch.parallel import ConsensusFleet

    factory = signer_factory or (lambda k: StubConsensusSigner(b"fleet-%d" % k))
    return ConsensusFleet(factory, n_shards=FLEET_SHARDS, devices=[dev],
                          capacity_per_shard=capacity, voter_capacity=voter_capacity, **kw)


class FleetRun(Run):
    """:class:`Run` over a fleet: the router takes the engine's calls, and
    every shard's events come merged through the fleet's single-engine
    facade (``FleetEngineAdapter.event_bus``), each shard's bus as wide as
    the single engine's (a shard's default bus keeps 1,000 events a
    subscriber, and a wave decides more sessions than that on one shard)."""

    def __init__(self, fleet):
        from hashgraph_tpu_torch.events import BroadcastEventBus
        from hashgraph_tpu_torch.parallel import FleetEngineAdapter

        for sid in fleet.shard_ids:
            shard_engine = fleet.shard(sid).engine
            shard_engine = getattr(shard_engine, "engine", shard_engine)
            shard_engine._event_bus = BroadcastEventBus(max_queued_events=10_000_000)
        self.engine = fleet
        self.rx = FleetEngineAdapter(fleet).event_bus().subscribe()
        self.pids = {}


def spread_calls(run, seed, gid_of, scopes=FLEET_SCOPES, n=10_000):
    """Config 3 (``n`` proposals × 64 voters, the first half gossipsub, the
    second P2P) with proposal i in scope ``i % scopes``, and the arguments
    of its five ``ingest_columnar_multi`` calls: four waves of 16 votes a
    proposal, then wave 2 again. ``gid_of(scope, owner)`` interns a voter
    (per shard on a fleet, once on an engine)."""
    from hashgraph_tpu_torch import ConsensusConfig

    names = [f"fleet-{k}" for k in range(scopes)]
    half = n // 2
    reqs = requests(n, 64, 3600, lambda i: i % 4 < 2)
    pid_of = np.zeros(n, np.int64)
    sidx_of = np.arange(n) % scopes
    for k, scope in enumerate(names):
        for lo, hi, config in ((0, half, ConsensusConfig.gossipsub()),
                               (half, n, ConsensusConfig.p2p())):
            idx = [i for i in range(lo, hi) if i % scopes == k]
            before = len(run.pids.get(scope, []))
            run.create(scope, [reqs[i] for i in idx], NOW, config)
            pid_of[idx] = run.pids[scope][before:]
    gids = np.array([[gid_of(scope, b"voter-%d" % v) for v in range(64)] for scope in names])
    rng = np.random.default_rng(seed)
    waves = []
    for w in range(4):
        rows_p = np.repeat(np.arange(n), 16)
        rows_v = 16 * w + np.tile(np.arange(16), n)
        order = rng.permutation(len(rows_p))
        waves.append((rows_p[order], rows_v[order], rng.random(len(rows_p)) < 0.6))
    waves.append(waves[1])
    return names, [
        (sidx_of[rp], pid_of[rp], gids[sidx_of[rp], rv], vals, NOW + 1 + w)
        for w, (rp, rv, vals) in enumerate(waves)
    ]


def spread_traffic(run, seed, gid_of):
    """:func:`spread_calls` through ``run``'s engine or fleet: the scope
    names and each call's statuses."""
    names, calls = spread_calls(run, seed, gid_of)
    return names, [run.engine.ingest_columnar_multi(names, sidx, pids, gids, vals, now,
                                                    max_depth=8).tolist()
                   for sidx, pids, gids, vals, now in calls]


def fleet_outcomes(run, names):
    return {scope: run.outcome(scope) for scope in names}


def phase_fleet_config3(dev):
    """(a), first half: config 3 over 64 scopes through a fleet of four
    shards on the card, against one engine on the card and the same fleet
    on the CPU; the fleet tally from the device reduction."""
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.ops import cuda_ingest
    from hashgraph_tpu_torch.parallel import ShardedPool

    single = Run(make_engine(dev))
    names, single_st = spread_traffic(
        single, 16, lambda scope, owner: single.engine.voter_gid(owner))
    fleet = fleet_of(dev, CAPACITY // FLEET_SHARDS, VOTER_CAPACITY)
    gpu = FleetRun(fleet)
    owners = {fleet.owner_of(scope) for scope in names}
    if owners != set(fleet.shard_ids):
        raise AssertionError(f"the 64 scopes land on shards {owners} only")
    # The main path of the phase: counts are zeroed just before it.
    _build.launches.clear()
    _, gpu_st = spread_traffic(gpu, 16, fleet.voter_gid)
    launches = _build.launches[cuda_ingest.KERNEL]
    per_shard = [fleet.shard(sid).pool().scan_dispatches[0] for sid in fleet.shard_ids]
    cpu_fleet = fleet_of(torch.device("cpu"), CAPACITY // FLEET_SHARDS, VOTER_CAPACITY)
    cpu = FleetRun(cpu_fleet)
    _, cpu_st = spread_traffic(cpu, 16, cpu_fleet.voter_gid)
    mine = (fleet_outcomes(gpu, names), gpu.events_by_session())
    for label, other, st in (("single GPU engine", single, single_st),
                             ("CPU fleet", cpu, cpu_st)):
        compare(f"fleet config 3 statuses against the {label}", gpu_st, st)
        compare(f"fleet config 3 results and stats against the {label}", mine[0],
                fleet_outcomes(other, names))
        compare(f"fleet config 3 events against the {label}", mine[1],
                other.events_by_session())
    if launches == 0 or launches != sum(per_shard) or 0 in per_shard:
        raise AssertionError(f"fleet config 3: {launches} ingest_scan launches, per shard "
                             f"{per_shard} (every shard must launch, once a dispatch)")
    # The fleet tally: each shard's device count vector, reduced on the card.
    reduced = []
    counts_fn = ShardedPool.device_state_counts

    def counting(pool):
        out = counts_fn(pool)
        reduced.append(out.device)
        return out

    ShardedPool.device_state_counts = counting
    try:
        tally = fleet.fleet_state_counts()
    finally:
        ShardedPool.device_state_counts = counts_fn
    if fleet._tally() != dev or reduced != [dev] * FLEET_SHARDS:
        raise AssertionError(f"the fleet tally did not reduce on the card: target "
                             f"{fleet._tally()}, shard vectors on {reduced}")
    mirrors = {}
    for sid in fleet.shard_ids:
        for code, c in fleet.shard(sid).pool().state_counts().items():
            mirrors[code] = mirrors.get(code, 0) + c
    compare("fleet tally against the host mirrors", tally,
            {code: mirrors.get(code, 0) for code in tally})
    compare("fleet tally against the CPU fleet's", tally, cpu_fleet.fleet_state_counts())
    compare("fleet tally against the single engine's pool", tally,
            all_state_counts(single.engine.pool()))
    occupancy = [fleet.occupancy()[sid]["live_sessions"] for sid in fleet.shard_ids]
    fleet.close()
    cpu_fleet.close()
    log(f"[fleet] (a) config 3 over {FLEET_SCOPES} scopes on ConsensusFleet("
        f"n_shards={FLEET_SHARDS}, devices=[{dev}], capacity_per_shard="
        f"{CAPACITY // FLEET_SHARDS}, voter_capacity={VOTER_CAPACITY}), five "
        f"ingest_columnar_multi calls: ingest_scan launches {launches}, per shard "
        f"{per_shard}; sessions per shard {occupancy}; statuses, results, stats and events "
        f"equal to the single engine's and the CPU fleet's; fleet tally {tally} reduced on "
        f"the card from {len(reduced)} shard vectors, equal to the host mirrors, the CPU "
        f"fleet's and the single pool's")
    return dict(launches=launches, per_shard=per_shard)


def fleet_deliveries(fleet, data):
    """Phase 8's four delivery stages through ``fleet.deliver_proposals``
    (stage (a)'s proposals arrive through it too): statuses, events and
    the sessions' final state, read through the fleet's single-engine
    facade."""
    from hashgraph_tpu_torch.parallel import FleetEngineAdapter
    from hashgraph_tpu_torch.wire import Proposal

    run = ProposalRun(FleetEngineAdapter(fleet))
    log_ = []
    for payload, now in ((data["a"], NOW + 100), (data["b"][0], NOW + 101),
                         (data["b"][1], NOW + 102), (data["c"], NOW + 103)):
        items = [(scope, Proposal.decode(b)) for scope, b in payload]
        log_.append(fleet.deliver_proposals(items, now))
        log_.append(sorted(run.events(), key=repr))
    return log_, run.state(data["chain_pids"])


def phase_fleet_signed(dev):
    """(a), second half: phase 8's Ed25519 chains through
    ``deliver_proposals`` on a fleet whose shards verify on the card,
    against a fleet of host signers on the CPU."""
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.signing import Ed25519ConsensusSigner

    data = proposal_traffic_data()
    rng = random.Random(161)
    seeds = [rng.randbytes(32) for _ in range(FLEET_SHARDS)]
    device_signer = counting_device_signer()
    # Shard ids under which the two scopes land on two shards, whose
    # batches then run side by side on the card.
    ids = [f"signed-{k}" for k in range(FLEET_SHARDS)]
    fleets = {
        "gpu": fleet_of(dev, FED_CAPACITY, VOTER_CAPACITY, shard_ids=ids,
                        signer_factory=lambda k: device_signer(seeds[k])),
        "cpu": fleet_of(torch.device("cpu"), FED_CAPACITY, VOTER_CAPACITY, shard_ids=ids,
                        signer_factory=lambda k: Ed25519ConsensusSigner(seeds[k])),
    }
    for fleet in fleets.values():
        fleet.scope("p2p").p2p_preset().initialize()
    shards = sorted({fleets["gpu"].owner_of(scope) for scope in PROP_SCOPES})
    if len(shards) != len(PROP_SCOPES):
        raise AssertionError(f"the signed scopes share a shard: {shards}")
    captured = KernelInputs()
    _build.launches.clear()
    with captured.active():
        gpu_log, gpu_state = fleet_deliveries(fleets["gpu"], data)
    launches = dict(_build.launches)
    cpu_log, cpu_state = fleet_deliveries(fleets["cpu"], data)
    compare("signed fleet statuses and events", gpu_log, cpu_log)
    compare("signed fleet sessions, votes and stats", gpu_state, cpu_state)
    never = [k for k in VERIFY_KERNELS if not launches.get(k)]
    batches = device_signer.batches
    if never or not batches:
        raise AssertionError(f"signed fleet: launches {launches}, kernels never launched "
                             f"{never}, {len(batches)} device batches")
    for batch in batches:
        if batch["fallback"] != 0.0 or not batch["msm"] > 0.0:
            raise AssertionError(f"signed fleet: batch {batch} fell back to the host blame "
                                 "or ran no MSM")
    held = hold_captured(captured)
    if set(held) != set(VERIFY_KERNELS):
        raise AssertionError(f"signed fleet: kernel inputs captured on the path: {held}")
    for fleet in fleets.values():
        fleet.close()
    codes = sorted(set(gpu_log[0]))
    log(f"[fleet] (a) phase 8's {PROP_MAIN} x {PROP_VOTERS} Ed25519 chains (and its extra "
        f"items) through fleet.deliver_proposals on {FLEET_SHARDS} shards of {dev} with "
        f"device signers (scopes on shards {shards}): {len(batches)} device batches, none "
        f"fell back to the host blame; launches {json.dumps(launches)}; statuses {codes} of "
        f"stage (a), events, results, votes and stats equal to the CPU fleet's (host batch "
        f"verification); each kernel held against its plain version on the path's inputs at "
        f"{json.dumps(held)}")
    return dict(launches=launches, batches=len(batches))


def fed_plan(create, seed=162):
    """(b)'s proposals, created through ``create(scope, requests, config)``
    under seeded ids (so the card's run and the CPU's get the same ids):
    FED_PROPOSALS × 64 voters, proposal i in scope ``i % FED_SCOPES``, the
    first half gossipsub, the second P2P. Returns the scope names, the pid
    and scope index of each proposal, and :func:`wire_waves` over them."""
    from hashgraph_tpu_torch import ConsensusConfig

    names = [f"fed-{k}" for k in range(FED_SCOPES)]
    half = FED_PROPOSALS // 2
    reqs = requests(FED_PROPOSALS, WAL_VOTERS, 3600, lambda i: i % 4 < 2)
    pids = np.zeros(FED_PROPOSALS, np.int64)
    sidx = np.arange(FED_PROPOSALS) % FED_SCOPES
    with seeded_ids(seed):
        for k, scope in enumerate(names):
            for lo, hi, config in ((0, half, ConsensusConfig.gossipsub()),
                                   (half, FED_PROPOSALS, ConsensusConfig.p2p())):
                idx = [i for i in range(lo, hi) if i % FED_SCOPES == k]
                made = create(scope, [reqs[i] for i in idx], config)
                pids[idx] = [p.proposal_id for p in made]
    return names, pids, sidx


def fed_results(read, names, pids, sidx):
    """Each proposal's result (or what raised) and each scope's stats."""
    results = []
    for i, pid in enumerate(pids.tolist()):
        try:
            results.append(read(names[sidx[i]]).get_consensus_result(names[sidx[i]], pid))
        except Exception as exc:  # the exception type is the result compared
            results.append(type(exc).__name__)
    stats = []
    for scope in names:
        st = read(scope).get_scope_stats(scope)
        stats.append((st.total_sessions, st.active_sessions, st.failed_sessions,
                      st.consensus_reached))
    return results, stats


def fleet_recovery_run(dev, root):
    """(b1) on ``dev``: a durable fleet takes (b)'s waves as wire rows; one
    shard crashes and replays its log in the background while wave 1 goes
    to the other three, then another is rebuilt from a peer (a bridge
    server holding a replica recovered from a copy of its log) while wave 2
    goes to the other three. Both crash before any session can fail at the
    P2P round cap, a failure the log does not carry (ROADMAP queue 3)."""
    import shutil

    from hashgraph_tpu_torch import StubConsensusSigner, TorchConsensusEngine, _build
    from hashgraph_tpu_torch.bridge import protocol as P
    from hashgraph_tpu_torch.bridge.server import BridgeServer
    from hashgraph_tpu_torch.sync import state_fingerprint
    from hashgraph_tpu_torch.wal import DurableEngine

    fleet = fleet_of(dev, FED_CAPACITY, WAL_VOTERS, wal_root=str(root / "fleet"))
    names, pids, sidx = fed_plan(
        lambda scope, reqs, config: fleet.create_proposals(scope, reqs, NOW, config))
    waves = wire_waves(pids, 163, scope_of=sidx)
    owners = [StubConsensusSigner(b"voter-%d" % i).identity() for i in range(WAL_VOTERS)]
    gids = np.array([[fleet.voter_gid(scope, o) for o in owners] for scope in names])
    shard_of = np.array([fleet.owner_of(scope) for scope in names])
    log_ = {}

    def send(w, keep=lambda sid: True):
        """Wave ``w``'s rows of the scopes on shards that ``keep``; the call
        names only those scopes (a route to a scope of an unavailable
        shard raises)."""
        rows, row_sidx, row_pid, row_owner, values = waves[w]
        kept = [k for k in range(len(names)) if keep(shard_of[k])]
        local = np.full(len(names), -1)
        local[kept] = np.arange(len(kept))
        sel = np.nonzero(local[row_sidx] >= 0)[0]
        st = fleet.ingest_columnar_multi(
            [names[k] for k in kept], local[row_sidx[sel]], row_pid[sel],
            gids[row_sidx[sel], row_owner[sel]], values[sel], NOW + 1 + w,
            wire_votes=[rows[k] for k in sel])
        log_.setdefault(f"wave{w}", []).append(st.tolist())

    _build.launches.clear()
    send(0)
    victim = fleet.owner_of(names[0])
    before = state_fingerprint(fleet.shard(victim).engine)
    fleet.crash_shard(victim)
    thread = fleet.recover_shard(victim, background=True)
    send(1, lambda sid: sid != victim)
    thread.join(timeout=300)
    shard = fleet.shard(victim)
    if thread.is_alive() or not shard.available or shard.recovery_error is not None:
        raise AssertionError(f"(b1) shard {victim} did not recover: {shard.recovery_error!r}")
    if state_fingerprint(shard.engine) != before:
        raise AssertionError("(b1) the replayed shard's fingerprint differs from before the crash")
    send(1, lambda sid: sid == victim)
    recovered = occupancy_overlay(fleet, victim, "wal_recover")
    # Another shard, rebuilt from a peer.
    victim2 = next(sid for sid in fleet.shard_ids if sid != victim and (shard_of == sid).any())
    before2 = state_fingerprint(fleet.shard(victim2).engine)
    wal_dir = fleet.shard(victim2).wal_dir
    fleet.crash_shard(victim2)
    shutil.copytree(wal_dir, root / "peer")
    replica = DurableEngine(TorchConsensusEngine(
        StubConsensusSigner(b"replica"), FED_CAPACITY, WAL_VOTERS, device=dev,
        max_sessions_per_scope=FED_CAPACITY), str(root / "peer"))
    replica.recover()
    server = BridgeServer(engine_factory=lambda signer: replica,
                          signer_factory=StubConsensusSigner)
    server.start()
    try:
        status, out = server.dispatch_frame(P.OP_ADD_PEER, P.u8(32) + b"\x16" * 32)
        if status != P.STATUS_OK:
            raise AssertionError(f"(b1) the replica's registration failed: {status}")
        peer = P.Cursor(out).u32()
        thread = fleet.catch_up_shard(victim2, *server.address, peer, background=True)
        send(2, lambda sid: sid != victim2)
        thread.join(timeout=300)
        shard2 = fleet.shard(victim2)
        if thread.is_alive() or not shard2.available or shard2.recovery_error is not None:
            raise AssertionError(f"(b1) shard {victim2} did not catch up: "
                                 f"{shard2.recovery_error!r}")
        fingerprints = {state_fingerprint(shard2.engine), state_fingerprint(replica), before2}
        if len(fingerprints) != 1:
            raise AssertionError("(b1) the caught-up shard, its peer and the shard before the "
                                 "crash differ")
    finally:
        server.stop()
        replica.close()
    send(2, lambda sid: sid == victim2)
    send(3)
    send(4)
    launches = dict(_build.launches)
    log_["caught_up"] = occupancy_overlay(fleet, victim2, "catch_up")
    log_["recovered"] = recovered
    log_["outcome"] = fed_results(lambda scope: fleet, names, pids, sidx)
    log_["fingerprints"] = {sid: state_fingerprint(fleet.shard(sid).engine)
                            for sid in fleet.shard_ids}
    log_["counts"] = fleet.fleet_state_counts()
    log_["victims"] = [victim, victim2]
    fleet.close()
    return log_, launches


def occupancy_overlay(fleet, sid, key):
    """A shard's recovery provenance from ``occupancy()``, without its
    wall-clock field."""
    entry = dict(fleet.occupancy()[sid][key])
    entry.pop("seconds", None)
    return entry


def federation_run(dev, root):
    """(b2) on ``dev``: two FleetGroups of two shards over loopback TCP;
    every proposal's votes go in at one host by its parity, so half ride
    the fabric; the fabric tally; one migrate_shard from h0 to h1 while a
    traffic thread votes on the other shards' scopes."""
    from hashgraph_tpu_torch import StubConsensusSigner, _build
    from hashgraph_tpu_torch.parallel import (
        FederationPlacement,
        FleetGroup,
        ShardMigratingError,
        migrate_shard,
        tally_path,
    )
    from hashgraph_tpu_torch.wire import Vote

    placement = FederationPlacement.uniform(["h0", "h1"], 2)
    groups = {}
    try:
        for host in ("h0", "h1"):
            groups[host] = FleetGroup(
                host, lambda k: StubConsensusSigner(b"fed-%d" % k), placement=placement,
                wal_root=str(root), capacity_per_shard=FED_CAPACITY,
                voter_capacity=WAL_VOTERS, devices=[dev])
            groups[host].start()
        for a in groups:
            for b in groups:
                if a != b:
                    groups[a].connect(b, *groups[b].address, groups[b].peer_id)

        def create(scope, reqs, config):
            host, shard = placement.owner(scope)
            made = groups[host].adapter.create_proposals(scope, reqs, NOW, config)
            placement.pin(scope, shard)
            return made

        names, pids, sidx = fed_plan(create)
        waves = wire_waves(pids, 164, scope_of=sidx)[:FED_WAVES]
        n = FED_PROPOSALS
        votes = [[Vote.decode(row) for row in w[0]] for w in waves]  # row j*n + k: vote j of k
        shard_of = [placement.owner(names[s])[1] for s in sidx]
        log_ = {"statuses": []}

        def send(w, keep=lambda k: True, retry=False):
            for j in range(WAL_PER_WAVE):
                for parity, host in enumerate(("h0", "h1")):
                    ks = [k for k in range(parity, n, 2) if keep(k)]
                    if not ks:
                        continue
                    items = [(names[sidx[k]], votes[w][j * n + k]) for k in ks]
                    while True:
                        try:
                            st = groups[host].ingest_votes(items, NOW + 1 + w)
                            break
                        except ShardMigratingError as exc:
                            if not retry:
                                raise
                            time.sleep(min(exc.retry_after, 0.05))
                    log_["statuses"].append((w, j, host, st.tolist()))

        _build.launches.clear()
        for w in range(FED_WAVES - 1):
            send(w)
        log_["tally_path"] = tally_path()
        counts = [groups[h].federated_state_counts() for h in ("h0", "h1")]
        local = [groups[h].fleet.fleet_state_counts() for h in ("h0", "h1")]
        summed = {c: local[0].get(c, 0) + local[1].get(c, 0) for c in counts[0]}
        if counts[0] != counts[1] or counts[0] != summed:
            raise AssertionError(f"(b2) fabric tallies {counts} differ or are not the sum of "
                                 f"the hosts' fleets {local}")
        log_["counts"] = counts[0]
        log_["fingerprints"] = [groups[h].state_fingerprint() for h in ("h0", "h1")]
        shard = max(placement.shards_of("h0"),
                    key=lambda sid: (len(placement.pins_of_shard(sid)), sid))
        moving = lambda k: shard_of[k] == shard  # noqa: E731
        errors = []

        def traffic():
            try:
                send(FED_WAVES - 1, keep=lambda k: not moving(k), retry=True)
            except BaseException as exc:  # surfaced after the join
                errors.append(exc)

        thread = threading.Thread(target=traffic)
        thread.start()
        report = migrate_shard(placement, groups, shard, "h1", retry_after=0.05)
        thread.join(timeout=300)
        if thread.is_alive() or errors:
            raise AssertionError(f"(b2) the traffic thread failed: {errors}")
        report.pop("seconds")  # wall clock: not compared
        send(FED_WAVES - 1, keep=moving)
        launches = dict(_build.launches)
        log_["statuses"].sort(key=lambda x: (x[0], x[1], x[2], len(x[3])))
        log_["migration"] = report
        log_["owners"] = [placement.owner(scope) for scope in names]
        log_["outcome"] = fed_results(lambda scope: groups[placement.owner(scope)[0]].adapter,
                                      names, pids, sidx)
        log_["counts_after"] = groups["h0"].federated_state_counts()
        log_["fingerprints_after"] = [groups[h].state_fingerprint() for h in ("h0", "h1")]
        return log_, launches
    finally:
        for group in groups.values():
            group.close()


FLEET_RUNS = (("b1", fleet_recovery_run), ("b2", federation_run))


def fleet_twin(root):
    """(b1) and (b2) on the CPU, the twins of the card's runs, with their
    logs as one JSON line. Run in a child process (``python3 chip_smoke.py
    --fleet-twin ROOT``) beside the card's work: the runs are host-bound
    and deterministic (seeded ids), so a process of their own gives the
    same logs in less of the phase's wall."""
    out = {label: dict(log=fn(torch.device("cpu"), Path(root) / label)[0])
           for label, fn in FLEET_RUNS}
    print(json.dumps(out))


def start_fleet_twin(root):
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--fleet-twin", str(root)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_fleet_twin(proc):
    """The twin's logs; a twin that fails or outlives FED_TIMEOUT (then
    killed) fails the phase."""
    try:
        out, err = proc.communicate(timeout=FED_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"the CPU twin of (b) failed:\n{out[-2000:]}\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase_fleet_recovery(dev, root, twin_proc):
    """(b): (b1) and (b2) on the card, each against the same run on the CPU
    (the twin process)."""
    from hashgraph_tpu_torch.errors import StatusCode

    out = {}
    for label, fn in FLEET_RUNS:
        gpu = fn(dev, root / label)
        out[label] = dict(log=json.loads(json.dumps(gpu[0])), launches=gpu[1])
        if not gpu[1].get("ingest_scan"):
            raise AssertionError(f"({label}) launched no ingest_scan: {gpu[1]}")
    twin = finish_fleet_twin(twin_proc)
    for label, _ in FLEET_RUNS:
        compare(f"({label}) statuses, results, fingerprints and reports against the CPU run",
                out[label]["log"], twin[label]["log"])
    b1, b2 = out["b1"]["log"], out["b2"]["log"]
    flat = [c for st in b1["wave0"] + b1["wave4"] for c in st]
    if int(StatusCode.OK) not in flat or b1["recovered"]["records_applied"] == 0 \
            or b1["caught_up"]["sessions_installed"] == 0:
        raise AssertionError(f"(b1) no OK rows, or nothing replayed or installed: "
                             f"{b1['recovered']} {b1['caught_up']}")
    if b2["tally_path"] != "fabric" or b2["migration"]["sessions"] == 0:
        raise AssertionError(f"(b2) tally path {b2['tally_path']}, migration {b2['migration']}")
    codes = [c for _, _, _, st in b2["statuses"] for c in st]
    by_code = {StatusCode(c).name: codes.count(c) for c in sorted(set(codes))}
    if "OK" not in by_code or "SESSION_NOT_FOUND" in by_code:
        raise AssertionError(f"(b2) statuses {by_code}: votes did not reach their sessions")
    decided = sum(r is True or r is False for r in b2["outcome"][0])
    log(f"[fleet] (b1) a durable fleet of {FLEET_SHARDS} shards on cuda:0, {FED_PROPOSALS} "
        f"proposals x {WAL_VOTERS} voters in {FED_SCOPES} scopes as wire rows: shard "
        f"{b1['victims'][0]} crashed and replayed ({b1['recovered']}) in the background "
        f"while wave 1 went to the other three, shard {b1['victims'][1]} rebuilt from a peer "
        f"({b1['caught_up']}) while wave 2 did; fingerprints equal to before each crash and "
        f"to the peer; statuses, results, stats, every shard's fingerprint and the tally "
        f"{b1['counts']} equal to the CPU run's (the twin process); launches "
        f"{json.dumps(out['b1']['launches'])}")
    log(f"[fleet] (b2) two FleetGroups of 2 shards on cuda:0 over loopback TCP, "
        f"{FED_PROPOSALS} proposals x {WAL_VOTERS} voters in {FED_SCOPES} scopes, "
        f"{FED_WAVES} waves of {WAL_PER_WAVE} votes a proposal, every proposal's votes in at "
        f"one host by parity (half ride the fabric): statuses {by_code}, {decided} "
        f"sessions decided; fabric tally {b2['counts']} equal on both hosts; "
        f"migrate_shard {b2['migration']['shard']} h0 -> h1 ({b2['migration']['sessions']} "
        f"sessions, {b2['migration']['scopes']} scopes) under a traffic thread; statuses, "
        f"results, host fingerprints and the report equal to the CPU run's (the twin "
        f"process); launches {json.dumps(out['b2']['launches'])}")
    return out


def phase_fleet_collective():
    """(c) The federation worker of tests/test_torch_multihost.py: two gloo
    processes, each a FleetGroup of one shard on cuda:0, and the same pair
    on the CPU, both pairs at once."""
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_multihost as mh

    sides = {"cuda": [], "cpu": []}
    with ThreadPoolExecutor(2) as pool:
        futures = {device: pool.submit(mh.run_federation_workers, device, FED_WORKER_SCALE,
                                       FED_TIMEOUT, sides[device])
                   for device in ("cuda", "cpu")}
        observed = {device: f.result() for device, f in futures.items()}
    for rank, (on_card, on_cpu) in enumerate(zip(observed["cuda"], observed["cpu"])):
        compare(f"(c) rank {rank}'s observations", on_card, on_cpu)
        if on_card["tally_path"] != "psum" or on_card["psum"] != on_card["fabric"]:
            raise AssertionError(f"(c) rank {rank}: tally path {on_card['tally_path']}, "
                                 f"psum {on_card['psum']} against fabric {on_card['fabric']}")
    launches = [side["launches"].get("ingest_scan", 0) for side in sides["cuda"]]
    if 0 in launches or any(side["launches"] for side in sides["cpu"]):
        raise AssertionError(f"(c) ingest_scan launches {launches} on the card, "
                             f"{[s['launches'] for s in sides['cpu']]} on the CPU")
    log(f"[fleet] (c) two gloo processes, a FleetGroup of one shard each on cuda:0, "
        f"{FED_WORKER_SCALE['proposals']} proposals x {FED_WORKER_SCALE['voters']} voters "
        f"each: tally_path() 'psum' on both, the all-gather's counts "
        f"{observed['cuda'][0]['psum']} equal to the fabric's OP_FLEET_TALLY sum and to the "
        f"CPU pair's; ingest_scan launches per process {launches}")
    return dict(launches=launches)


def phase_fleet(dev):
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    dev = torch.device(dev.type, torch.cuda.current_device())  # the tally's device is cuda:0
    a = phase_fleet_config3(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fleet-") as root:
        # From here the CPU twin of (b) and (c)'s two pairs of processes run
        # beside the card's work.
        twin = start_fleet_twin(Path(root) / "twin")
        background = ThreadPoolExecutor(1)
        collective = background.submit(phase_fleet_collective)
        try:
            signed = phase_fleet_signed(dev)
            torch.cuda.empty_cache()
            b = phase_fleet_recovery(dev, Path(root) / "card", twin)
            c = collective.result()
        finally:
            if twin.poll() is None:
                twin.kill()
                twin.communicate()
            background.shutdown(wait=False)
    log("[fleet] one card checks the router, the per-shard kernels, the device tally, the "
        "fabric and live migration, not shards on separate GPUs, NCCL or hosts on separate "
        "machines")
    return dict(a=a, signed=signed, b=b, c=c)


# ── Phase 17: the example programs ─────────────────────────────────────

EXAMPLES_DIR = Path(__file__).resolve().parent / "examples_torch"
EXAMPLE_TIMEOUT = 300  # seconds a twin's process may run before it is killed
EXAMPLE_WORKERS = 6  # runs of (a) at once; the card's host has 8 cores
EXAMPLE_REPORT = "[example-launches] "  # the runner's line on stderr
HOST_ONLY_EXAMPLES = ("quickstart", "gossip_simulation")  # scalar services, no --device
SCRIPT_EXAMPLES = ("batch_engine", "bridge_embedder", "catchup_smoke", "trace_smoke",
                   "metrics_smoke", "federation_scrape_smoke")  # run to their end
BRIDGE_EXAMPLES = ("bridge_embedder", "catchup_smoke", "trace_smoke", "metrics_smoke")
# name -> regexes whose groups are masked when two runs' stdout are
# compared: only fields that wall time, os.urandom or the kernel fill
# (proposal ids, peer identity hex, trace-id hex, batch_engine's seconds
# and votes/s, bridge_embedder's listening port).
EXAMPLE_MASKS = {
    "quickstart": [r"^proposal (\d+):"],
    "batch_engine": [r"^\d+ votes in ([\d.]+)s \(([\d,]+) votes/sec"],
    "gossip_simulation": [r"^proposal (\d+) delivered", r"^one trace \(([0-9a-f]+)…\)"],
    "bridge_embedder": [r"^bridge listening on [\d.]+:(\d+)$", r"address 0x([0-9a-f]+)$",
                        r"^proposal (\d+) created$"],
}
FED_HOSTS = ("h0", "h1")
FED_VOTERS = 4  # votes of each decision driven onto a federation host


def masked_transcript(name: str, text: str) -> "list[str]":
    """The lines of ``text`` with the groups of ``EXAMPLE_MASKS[name]``
    replaced."""
    out = []
    for line in text.splitlines():
        for pattern in EXAMPLE_MASKS.get(name, ()):
            m = re.search(pattern, line)
            if m:
                for g in range(len(m.groups()), 0, -1):
                    a, b = m.span(g)
                    line = line[:a] + "<masked>" + line[b:]
        out.append(line)
    return out


def run_example(name: str, args: "list[str]") -> int:
    """The runner, ``python3 chip_smoke.py --run-example NAME ARGS...``:
    runs ``examples_torch/NAME.py`` with ARGS in this process as its own
    process would, then prints on stderr ``EXAMPLE_REPORT`` and a JSON
    object: the twin, its arguments, this process's kernel launches,
    whether it initialised CUDA, and the device-verification batches and
    host-blame fallbacks it counted. A twin it spawns (the hosts of
    ``federation_scrape_smoke``) runs through the runner too."""
    import runpy

    path = EXAMPLES_DIR / f"{name}.py"
    popen_init = subprocess.Popen.__init__

    def through_runner(self, argv, *a, **kw):
        if (isinstance(argv, list) and len(argv) > 1
                and Path(str(argv[1])).resolve().parent == EXAMPLES_DIR):
            argv = [argv[0], str(Path(__file__).resolve()), "--run-example",
                    Path(str(argv[1])).stem, *map(str, argv[2:])]
        popen_init(self, argv, *a, **kw)

    subprocess.Popen.__init__ = through_runner
    sys.argv = [str(path), *args]
    code = 0
    try:
        runpy.run_path(str(path), run_name="__main__")
    except SystemExit as exc:
        code = exc.code if isinstance(exc.code, int) else (0 if exc.code is None else 1)
    finally:
        from hashgraph_tpu_torch import _build
        from hashgraph_tpu_torch.obs import (DEVICE_VERIFY_BATCHES_TOTAL,
                                             DEVICE_VERIFY_FALLBACKS_TOTAL, registry)

        print(EXAMPLE_REPORT + json.dumps({
            "example": name, "args": args, "launches": dict(_build.launches),
            "cuda": torch.cuda.is_initialized(),
            "verify_batches": registry.counter(DEVICE_VERIFY_BATCHES_TOTAL).value,
            "verify_fallbacks": registry.counter(DEVICE_VERIFY_FALLBACKS_TOTAL).value,
        }), file=sys.stderr, flush=True)
    return code


def example_argv(name: str, *args: str) -> "list[str]":
    return [sys.executable, str(Path(__file__).resolve()), "--run-example", name, *args]


def example_env(**changes) -> dict:
    """The twins' environment: two intra-op threads a process, so the runs
    of (a) side by side do not oversubscribe the cores; ``None`` removes a
    variable."""
    import os

    env = dict(os.environ, OMP_NUM_THREADS="2")
    for key, value in changes.items():
        if value is None:
            env.pop(key, None)
        else:
            env[key] = value
    return env


def example_reports(stderr: str) -> "list[dict]":
    return [json.loads(line[len(EXAMPLE_REPORT):]) for line in stderr.splitlines()
            if line.startswith(EXAMPLE_REPORT)]


def run_script_example(name: str, dev: "str | None", tmp: Path) -> dict:
    """One run of a twin that runs to its end, through the runner, with
    ``tmp`` as its TMPDIR (the scrape smoke's hosts leave their WAL
    directories there, as the reference's do): exit code, stdout, the
    tail of stderr, and every process's report."""
    args = [] if dev is None else ["--device", dev]
    proc = subprocess.run(example_argv(name, *args), cwd=str(EXAMPLES_DIR.parent),
                          capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT,
                          env=example_env(TMPDIR=str(tmp)))
    return dict(rc=proc.returncode, out=proc.stdout, err=proc.stderr[-4000:],
                reports=example_reports(proc.stderr))


class LineProcess:
    """A program answering line commands on stdin, one line each (its
    first line is its ``ready`` answer); stdout is read on a thread and
    stderr kept, each line awaited at most ``timeout`` s; closing stdin is
    its shutdown signal."""

    def __init__(self, argv, env=None, cwd=None, timeout=EXAMPLE_TIMEOUT):
        import queue

        self.timeout = timeout
        self.proc = subprocess.Popen(argv, cwd=cwd or str(EXAMPLES_DIR.parent), env=env,
                                     text=True, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        self.lines = queue.Queue()
        self.err: "list[str]" = []
        threading.Thread(target=self._read, daemon=True).start()
        self._err_reader = threading.Thread(target=lambda: self.err.extend(self.proc.stderr),
                                            daemon=True)
        self._err_reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line.strip())
        self.lines.put("")

    def readline(self) -> str:
        import queue

        try:
            return self.lines.get(timeout=self.timeout)
        except queue.Empty:
            self.proc.kill()
            raise AssertionError(f"{self.proc.args} said nothing in {self.timeout} s") from None

    def ready(self) -> "list[str]":
        return self.readline().split()

    def command(self, line: str) -> str:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()
        resp = self.readline()
        if not resp or resp.startswith("ERROR"):
            raise AssertionError(f"{line!r} -> {resp!r}: {''.join(self.err[-20:])}")
        return resp

    def close(self) -> int:
        """Close stdin and return the exit code; a process that outlives
        it by ``timeout`` is killed and fails."""
        if not self.proc.stdin.closed:
            self.proc.stdin.close()
        try:
            rc = self.proc.wait(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise AssertionError(f"{self.proc.args} outlived its stdin by "
                                 f"{self.timeout} s") from None
        self._err_reader.join(self.timeout)
        return rc

    def reports(self) -> "list[dict]":
        return example_reports("".join(self.err))


def bridge_quickstart_answers(client_cls, port: int) -> dict:
    """The bridge quick-start through ``client_cls`` on three keyed peers
    (any scheme: the keys are 32-byte seeds); every answer but the
    proposal id, which the server mints from the wall clock and random
    bytes."""
    from hashgraph_tpu_torch.wire import Vote

    with client_cls("127.0.0.1", port, timeout=120.0) as c:
        out = {"ping": c.ping()}
        peers = [c.add_peer(bytes([0x31 + i]) * 32) for i in range(3)]
        out["peers"] = [(p, identity.hex()) for p, identity in peers]
        ids = [p for p, _ in peers]
        pid, _ = c.create_proposal(ids[0], "demo", NOW, "genesis-upgrade", b"ship it", 3, 600)
        # The vote's bytes carry the random ids, so only these fields.
        vote = Vote.decode(c.cast_vote(ids[0], "demo", pid, True, NOW + 1))
        out["vote"] = [vote.vote_owner.hex(), vote.proposal_id == pid, vote.timestamp, vote.vote]
        proposal = c.get_proposal(ids[0], "demo", pid)
        for peer in ids[1:]:
            c.process_proposal(peer, "demo", proposal, NOW + 2)
        statuses = []
        for i, voter in enumerate(ids[1:]):
            vote = c.cast_vote(voter, "demo", pid, True, NOW + 3 + i)
            for other in ids:
                if other != voter:
                    try:
                        c.process_vote(other, "demo", vote, NOW + 4 + i)
                        statuses.append(0)
                    except Exception as exc:  # a vote after the decision
                        statuses.append(getattr(exc, "status", repr(exc)))
        out["statuses"] = statuses
        out["results"] = [c.get_result(p, "demo", pid) for p in ids]
        out["events"] = [[(e.scope, e.kind, e.proposal_id == pid, e.result, e.timestamp)
                          for e in c.poll_events(p)] for p in ids]
        out["stats"] = [list(c.get_stats(p, "demo")) for p in ids]
        verdict = c.explain(ids[0], "demo", pid)
        out["explain"] = [verdict["status"], verdict["result"], verdict["quorum"],
                          len(verdict["vote_chain"])]
    return out


def federation_answers(hosts: "dict[str, LineProcess]") -> dict:
    """Drive a federation of host processes (``federation_host``'s line
    protocol, ``FED_HOSTS``, two shards each) with the port's
    ``FederationDriver``: one decision on a scope each host owns (its
    chain in two halves, drained in turn); one of
    h0's shards moved to h1 with ``EXPORT``, ``ADOPT``, ``FLIP`` on every
    host and ``RETIRE``; one more decision a host; then ``TALLY`` on each.
    Returns whether the exported and adopted fingerprints were equal, the
    sessions moved and the tallies."""
    from hashgraph_tpu_torch import build_vote
    from hashgraph_tpu_torch.bridge import BridgeClient
    from hashgraph_tpu_torch.parallel.federation import FederationDriver, FederationPlacement
    from hashgraph_tpu_torch.signing.stub import StubConsensusSigner
    from hashgraph_tpu_torch.wire import Proposal

    placement = FederationPlacement.uniform(list(FED_HOSTS), 2)
    driver = FederationDriver(placement)
    clients, ports, peers = {}, {}, {}
    try:
        for host_id, host in hosts.items():
            word, port_s, peer_s = host.ready()
            if word != "READY":
                raise AssertionError(f"{host_id} said {word!r}")
            ports[host_id], peers[host_id] = int(port_s), int(peer_s)
            clients[host_id] = BridgeClient("127.0.0.1", ports[host_id], timeout=120.0)
            driver.connect(host_id, "127.0.0.1", ports[host_id], peers[host_id])
        signers = [StubConsensusSigner(bytes([0x41 + i]) * 20) for i in range(FED_VOTERS)]

        def decide(tag):
            scopes, chains, i = {}, {}, 0
            while len(scopes) < len(FED_HOSTS):
                owner, _ = placement.owner(f"{tag}-{i}")
                scopes.setdefault(owner, f"{tag}-{i}")
                i += 1
            for owner, scope in scopes.items():
                _, shard = placement.owner(scope)
                _, blob = clients[owner].create_proposal(
                    peers[owner], scope, NOW, "p", b"payload", FED_VOTERS, 3_600)
                placement.pin(scope, shard)
                proposal, chains[scope] = Proposal.decode(blob), []
                for signer in signers:
                    vote = build_vote(proposal, True, signer, NOW + 1)
                    proposal.votes.append(vote)
                    chains[scope].append(vote.encode())
            # Each chain in two halves, drained in turn: the second half
            # lands on sessions that already hold votes (the scan's path,
            # not the fresh one).
            half = FED_VOTERS // 2
            for part in (slice(0, half), slice(half, None)):
                for scope, votes in chains.items():
                    driver.submit(scope, votes[part], NOW + 1)
                    driver.pump()
                report = driver.drain()
                if report["acked"] != len(FED_HOSTS) * len(signers[part]) or report["rejected"]:
                    raise AssertionError(f"the federation's drain: {report}")
            return scopes

        shard = placement.pinned(decide("before")["h0"])
        driver.begin_shard_migration(shard, retry_after=0.25)
        _, export_peer, src_fp = hosts["h0"].command(f"EXPORT {shard} 0.25").split()
        _, sessions, dst_fp = hosts["h1"].command(
            f"ADOPT {shard} 127.0.0.1 {ports['h0']} {export_peer}").split()
        for host in hosts.values():
            host.command(f"FLIP {shard} h1")
        driver.complete_shard_migration(shard, "h1")
        hosts["h0"].command(f"RETIRE {shard} {export_peer}")
        decide("after")
        tallies = {h: json.loads(host.command("TALLY").split(" ", 1)[1])
                   for h, host in hosts.items()}
    finally:
        driver.close()
        for client in clients.values():
            client.close()
    return dict(fingerprints_equal=src_fp == dst_fp, sessions=int(sessions), tallies=tallies)


def example_federation(dev: str, root: Path) -> dict:
    """Two ``federation_host`` twins on ``dev`` through ``federation_answers``;
    both must exit 0 on EOF."""
    common = ["--hosts", ",".join(FED_HOSTS), "--shards-per-host", "2", "--capacity", "32",
              "--voter-capacity", str(FED_VOTERS + 2), "--device", dev]
    hosts = {h: LineProcess(example_argv("federation_host", "--host-id", h, "--wal-root",
                                         str(root / dev / h), *common), env=example_env())
             for h in FED_HOSTS}
    try:
        out = federation_answers(hosts)
    finally:
        codes = [host.close() for host in hosts.values()]
    if codes != [0, 0]:
        raise AssertionError(f"(a) federation hosts on {dev} exited {codes}: "
                             f"{''.join(hosts['h0'].err[-10:] + hosts['h1'].err[-10:])}")
    out.update(reports=[r for host in hosts.values() for r in host.reports()])
    return out


def stub_peer_answers(port: int) -> dict:
    from hashgraph_tpu_torch.bridge import BridgeClient

    return bridge_quickstart_answers(BridgeClient, port)


def signed_peer_answers(port: int) -> "tuple[dict, dict]":
    """(c)'s traffic on a ``gossip_peer --scheme ed25519``: the bridge
    quick-start on three keyed peers, then three Ed25519 votes of outside
    keys chained on a second proposal, the last with its scalar damaged
    (a well-formed signature that does not verify, so the batch fails and
    the host blame runs), in one ``OP_PROCESS_VOTES`` frame; the statuses,
    results and the server's device-verification counters."""
    from hashgraph_tpu_torch import build_vote
    from hashgraph_tpu_torch.bridge import BridgeClient
    from hashgraph_tpu_torch.obs import DEVICE_VERIFY_BATCHES_TOTAL, DEVICE_VERIFY_FALLBACKS_TOTAL
    from hashgraph_tpu_torch.signing import Ed25519ConsensusSigner
    from hashgraph_tpu_torch.signing._ed25519 import L
    from hashgraph_tpu_torch.wire import Proposal

    out = bridge_quickstart_answers(BridgeClient, port)
    with BridgeClient("127.0.0.1", port, timeout=120.0) as c:
        pid, blob = c.create_proposal(1, "blame", NOW, "blame", b"", 6, 600)
        c.process_proposal(2, "blame", blob, NOW + 1)
        proposal, votes = Proposal.decode(blob), []
        for k in range(3):
            signer = Ed25519ConsensusSigner(bytes([0x51 + k]) * 32, device_verify=False)
            vote = build_vote(proposal, True, signer, NOW + 2)
            proposal.votes.append(vote)
            votes.append(vote)
        s = int.from_bytes(votes[-1].signature[32:], "little")
        votes[-1].signature = votes[-1].signature[:32] + ((s + 7) % L).to_bytes(32, "little")
        out["blame_statuses"] = c.process_votes(2, "blame", [v.encode() for v in votes], NOW + 3)
        out["blame_result"] = c.get_result(2, "blame", pid)
        out["blame_stats"] = list(c.get_stats(2, "blame"))
        metrics = c.get_metrics()
    counters = {}
    for name in (DEVICE_VERIFY_BATCHES_TOTAL, DEVICE_VERIFY_FALLBACKS_TOTAL):
        line = next(line for line in metrics.splitlines() if line.startswith(name + " "))
        counters[name] = float(line.split()[-1])
    return out, counters


def example_peers(scheme: str, traffic) -> dict:
    """A ``gossip_peer`` twin on the card and one on the CPU, both at once,
    each taking ``traffic(port)``; with ``ed25519`` the card peer runs
    under ``HASHGRAPH_TPU_DEVICE_VERIFY=1`` and the CPU peer under the host
    signer. Both must exit 0 on EOF."""
    verify = {"cuda": "1" if scheme == "ed25519" else None, "cpu": None}
    peers = {dev: LineProcess(example_argv("gossip_peer", "--scheme", scheme, "--device", dev),
                              env=example_env(HASHGRAPH_TPU_DEVICE_VERIFY=verify[dev]))
             for dev in ("cuda", "cpu")}
    try:
        answers = {}
        for dev, peer in peers.items():
            word, port = peer.ready()
            if word != "PORT":
                raise AssertionError(f"gossip_peer on {dev} said {word!r}")
            answers[dev] = traffic(int(port))
    finally:
        codes = {dev: peer.close() for dev, peer in peers.items()}
    if set(codes.values()) != {0}:
        raise AssertionError(f"gossip_peer --scheme {scheme} exit codes {codes}: "
                             f"{''.join(peers['cuda'].err[-10:] + peers['cpu'].err[-10:])}")
    reports = {dev: peer.reports() for dev, peer in peers.items()}
    return dict(answers=answers, reports=reports)


def report_of(reports, name) -> dict:
    found = [r for r in reports if r["example"] == name]
    if len(found) != 1:
        raise AssertionError(f"expected one report of {name}, got {reports}")
    return found[0]


def merge_launches(reports) -> "dict[str, int]":
    out: "dict[str, int]" = {}
    for r in reports:
        for k, n in r["launches"].items():
            out[k] = out.get(k, 0) + n
    return out


def phase_examples() -> dict:
    """Phase 17: every twin under ``examples_torch/`` as its own process
    through the runner, on the card and on the CPU, side by side."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from hashgraph_tpu_torch.errors import StatusCode

    with tempfile.TemporaryDirectory(prefix="chip-smoke-examples-") as root, \
            ThreadPoolExecutor(EXAMPLE_WORKERS) as pool:
        # The long multi-process arms first, then the scripts behind them.
        fed = {dev: pool.submit(example_federation, dev, Path(root)) for dev in ("cuda", "cpu")}
        stub_peers = pool.submit(example_peers, "stub", stub_peer_answers)
        signed = pool.submit(example_peers, "ed25519", signed_peer_answers)
        runs = {(name, dev): pool.submit(run_script_example, name, dev, Path(root))
                for name in SCRIPT_EXAMPLES for dev in ("cuda", "cpu")}
        runs.update({(name, None): pool.submit(run_script_example, name, None, Path(root))
                     for name in HOST_ONLY_EXAMPLES})
        runs = {key: f.result() for key, f in runs.items()}
        fed = {dev: f.result() for dev, f in fed.items()}
        stub_peers, signed = stub_peers.result(), signed.result()

    failed = {f"{name} {dev}": run for (name, dev), run in runs.items() if run["rc"] != 0}
    if failed:
        raise AssertionError("(a) twins failed: " + "; ".join(
            f"{k}: rc {r['rc']} {r['out'][-1000:]} {r['err'][-2000:]}" for k, r in failed.items()))
    launches = {}
    for name in HOST_ONLY_EXAMPLES:
        run = runs[(name, None)]
        if report_of(run["reports"], name)["cuda"]:
            raise AssertionError(f"(a) {name} initialised CUDA: it drives host-only services")
        log(f"[examples] {name}: exit 0, no device work; {len(run['out'].splitlines())} lines")
    for name in SCRIPT_EXAMPLES:
        card, cpu = runs[(name, "cuda")], runs[(name, "cpu")]
        compare(f"(a) {name}'s masked transcript", masked_transcript(name, card["out"]),
                masked_transcript(name, cpu["out"]))
        ok = f"{name.replace('_', '-')} OK"
        if name.endswith("_smoke") and card["out"].splitlines()[-1:] != [ok]:
            raise AssertionError(f"(a) {name} did not end on {ok!r}")
        # The twin's own process holds the device state, but for the
        # scrape smoke, whose two spawned hosts do.
        workers = "federation_host" if name == "federation_scrape_smoke" else name
        card_reports = [r for r in card["reports"] if r["example"] == workers]
        if len(card_reports) != (2 if workers == "federation_host" else 1) or not all(
                r["cuda"] for r in card_reports):
            raise AssertionError(f"(a) {name} on the card: a process with device state "
                                 f"did not initialise CUDA: {card['reports']}")
        if any(r["launches"] for r in cpu["reports"]):
            raise AssertionError(f"(a) {name} on the CPU launched kernels: {cpu['reports']}")
        launches[name] = merge_launches(card_reports)
        log(f"[examples] {name}: card and CPU runs exit 0 with equal masked transcripts "
            f"({len(card['out'].splitlines())} lines); launches on the card "
            f"{launches[name]}" + (" (its two host processes)" if workers != name else ""))
    if launches["batch_engine"].get("ingest_scan", 0) < 4:
        raise AssertionError(f"(b) batch_engine launched the scan "
                             f"{launches['batch_engine'].get('ingest_scan', 0)} times, not 4 or more")
    if not any(launches[name].get("ingest_scan") for name in BRIDGE_EXAMPLES):
        raise AssertionError("(b) no twin that runs a bridge server launched the scan")

    for dev, out in fed.items():
        if not out["fingerprints_equal"] or out["sessions"] < 1:
            raise AssertionError(f"(a) federation_host on {dev}: migration {out}")
    compare("(a) federation_host tallies", fed["cuda"]["tallies"], fed["cpu"]["tallies"])
    compare("(a) federation_host sessions moved", fed["cuda"]["sessions"], fed["cpu"]["sessions"])
    if len(fed["cuda"]["reports"]) != 2 or not all(
            r["cuda"] and r["launches"].get("ingest_scan") for r in fed["cuda"]["reports"]):
        raise AssertionError(f"(a) federation_host on the card: a host did not launch the "
                             f"scan: {fed['cuda']['reports']}")
    launches["federation_host"] = merge_launches(fed["cuda"]["reports"])
    log(f"[examples] federation_host: two hosts on the card and two on the CPU, one decision "
        f"a host, shard migrated with {fed['cuda']['sessions']} sessions and equal "
        f"fingerprints, tallies {fed['cuda']['tallies']} equal; launches on the card "
        f"{launches['federation_host']}")

    compare("(a) gossip_peer answers", stub_peers["answers"]["cuda"], stub_peers["answers"]["cpu"])
    card = report_of(stub_peers["reports"]["cuda"], "gossip_peer")
    if not card["cuda"] or stub_peers["answers"]["cuda"]["results"] != [True] * 3:
        raise AssertionError(f"(a) gossip_peer on the card: {card} {stub_peers['answers']}")
    launches["gossip_peer"] = card["launches"]
    log(f"[examples] gossip_peer --scheme stub: the quick-start's answers equal on the card "
        f"and the CPU, both exit 0 on EOF; launches on the card {card['launches']}")

    (card_answers, card_counters), (cpu_answers, cpu_counters) = (
        signed["answers"]["cuda"], signed["answers"]["cpu"])
    compare("(c) statuses and results", card_answers, cpu_answers)
    want = [int(StatusCode.OK)] * 2 + [int(StatusCode.INVALID_VOTE_SIGNATURE)]
    if card_answers["blame_statuses"] != want or card_answers["results"] != [True] * 3:
        raise AssertionError(f"(c) the signed traffic answered {card_answers}")
    card = report_of(signed["reports"]["cuda"], "gossip_peer")
    cpu = report_of(signed["reports"]["cpu"], "gossip_peer")
    require_launches("(c) the device-signer peer", card["launches"], VERIFY_KERNELS)
    # Every device batch ran its MSM on the card; the one batch carrying
    # the damaged signature, and only it, fails and runs the host blame.
    if (card["verify_fallbacks"] != 1 or card["verify_batches"] < 2
            or card_counters["hashgraph_device_verify_fallbacks_total"] != 1
            or cpu["verify_batches"] or cpu["launches"]):
        raise AssertionError(f"(c) device batches: card {card}, {card_counters}; CPU {cpu}")
    launches["gossip_peer_ed25519"] = card["launches"]
    log(f"[examples] gossip_peer --scheme ed25519 under HASHGRAPH_TPU_DEVICE_VERIFY=1: "
        f"statuses and results equal to the host-signer peer on the CPU; "
        f"{card['verify_batches']:g} device batches, {card['verify_fallbacks']:g} host blame "
        f"(the damaged signature's); launches {card['launches']}")
    return dict(launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # ``--only 1,2,6b`` runs the named phases and prints no result lines.
    only = set(sys.argv[sys.argv.index("--only") + 1].split(",")) if "--only" in sys.argv else None
    # The package sits beside this script; without it this import fails.
    from hashgraph_tpu_torch import _build, native
    from hashgraph_tpu_torch.errors import StatusCode
    from hashgraph_tpu_torch.ops import cuda_ingest

    def run(phase):
        return only is None or phase in only

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(0)
    smi = nvidia_smi()
    log(f"[build] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"[build] device {props.name}: {props.multi_processor_count} SMs, "
        f"{props.total_memory / 2**30:.1f} GiB; nvidia-smi: {smi}")
    # The native host runtime builds with g++ beside the nvcc builds.
    native_ok = []
    native_build = threading.Thread(target=lambda: native_ok.append(native.available()))
    native_build.start()
    try:
        _build.build()
    finally:
        native_build.join()
    if native_ok != [True]:
        raise AssertionError("the native host runtime did not build: the CPU engines and "
                             "the services would measure the pure-Python path")
    log(f"[build] kernels {_build.sources()} and the native host runtime "
        f"({native._load()._name}) built")
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                log(f"[build] {name}: {line.strip()}")

    timing = phase_kernel(dev) if run("2") else None

    gpu, cpu = Run(make_engine(dev)), Run(make_engine("cpu"))
    if run("3"):
        # Phase 3, the main path: counts are zeroed just before it.
        _build.launches.clear()
        grid_before = cuda_ingest.grid_launches
        gpu_st = config3_traffic(gpu, 3)
        main_launches = _build.launches[cuda_ingest.KERNEL]
        per_call = (cuda_ingest.grid_launches - grid_before) / max(main_launches, 1)
        if main_launches == 0:
            raise AssertionError("config 3 never launched the CUDA scan")
        cpu_st = config3_traffic(cpu, 3)
        compare("config 3 statuses", gpu_st, cpu_st)
        compare("config 3 results", gpu.outcome("config3"), cpu.outcome("config3"))
        compare("config 3 events", gpu.events_by_session(), cpu.events_by_session())
        flat = np.concatenate([np.asarray(s) for s in gpu_st])
        codes = {StatusCode(c).name: int((flat == c).sum()) for c in np.unique(flat)}
        if not {"OK", "DUPLICATE_VOTE", "ALREADY_REACHED"} <= set(codes):
            raise AssertionError(f"config 3 did not reach the expected statuses: {codes}")
        _, stats = gpu.outcome("config3")
        log(f"[config3] scan launches {main_launches} ({per_call:g} device launches a call); "
            f"statuses {codes}; stats (total, active, failed, reached) {stats}; identical to "
            "the CPU engine")

    if run("4"):
        _build.launches.clear()
        gpu_st2 = config2_traffic(gpu, 4)
        launches2 = _build.launches[cuda_ingest.KERNEL]
        cpu_st2 = config2_traffic(cpu, 4)
        compare("config 2 statuses", gpu_st2, cpu_st2)
        compare("config 2 results", gpu.outcome("config2"), cpu.outcome("config2"))
        compare("config 2 events", gpu.events_by_session(), cpu.events_by_session())
        ok_votes = sum(1 for c in gpu_st2 if c == int(StatusCode.OK))
        if ok_votes != 683 or gpu.outcome("config2")[0] != [True] or not 0 < launches2 <= 7:
            raise AssertionError(f"config 2: {ok_votes} votes accepted, result "
                                 f"{gpu.outcome('config2')[0]}, {launches2} scan wrapper "
                                 "calls (at most 7)")
        log(f"[config2] decided YES at vote {ok_votes} of 1024; scan wrapper calls {launches2}; "
            f"identical to the CPU engine")

    if run("5"):
        _build.launches.clear()
        gpu_t = timeout_traffic(gpu, 5)
        launches5 = _build.launches[cuda_ingest.KERNEL]
        compare("timeouts", gpu_t, timeout_traffic(cpu, 5))
        compare("timeout results", gpu.outcome("timeouts"), cpu.outcome("timeouts"))
        compare("timeout events", gpu.events_by_session(), cpu.events_by_session())
        if gpu_t[1] != [int(StatusCode.PROPOSAL_EXPIRED)]:
            raise AssertionError(f"late vote got {gpu_t[1]}")
        swept = gpu_t[2]
        log(f"[timeouts] swept {len(swept)} sessions: "
            f"{sum(1 for _, r in swept if r is True)} YES, "
            f"{sum(1 for _, r in swept if r is False)} NO, "
            f"{sum(1 for _, r in swept if r is None)} failed; late vote PROPOSAL_EXPIRED; "
            f"scan launches {launches5}; identical to the CPU engine")
    del gpu, cpu

    if run("5b"):
        _build.launches.clear()
        phase_spill(dev)
        spill_launches = _build.launches[cuda_ingest.KERNEL]

    fe_mul_timing, pow_timing = phase_field(dev) if run("6") else (None, None)
    msm_timings = phase_msm(dev) if run("6b") else None
    sha512_timing = phase_sha512(dev) if run("6c") else None
    verify = phase_verify(dev) if run("7") else None
    proposals = phase_proposals(dev) if run("8") else None
    if run("9"):
        phase_service(dev)
    if run("10"):
        # Phase 10's counts are zeroed just before each of its steps.
        wal = phase_wal(dev)
    if run("11"):
        # Phase 11's counts are zeroed just before each of its steps.
        tier = phase_tier(dev)
    if run("12"):
        # Phase 12's counts are zeroed just before each of its steps.
        obs_out = phase_obs(dev)
    if run("13"):
        # Phase 13's counts are zeroed just before each of its steps.
        bridge = phase_bridge(dev)
    if run("14"):
        # Phase 14's counts are zeroed just before each of its steps.
        gossip_sync = phase_gossip_sync(dev)
    if run("15"):
        # Phase 15's counts are zeroed just before (a)'s sharded run; (b)'s
        # workers are fresh processes.
        placement = phase_placement(dev)
    if run("16"):
        # Phase 16's counts are zeroed just before (a)'s fleet run, its signed
        # deliveries and each of (b)'s card runs; (c)'s workers are fresh
        # processes.
        fleet = phase_fleet(dev)
    if run("17"):
        # Phase 17's counts are each twin process's own, read at its end.
        examples = phase_examples()
    stop_children()

    log(f"[done] phases {'all' if only is None else sorted(only)} passed in "
        f"{time.perf_counter() - t_start:.3f} s")
    if only is not None:
        return 0
    main_timing = timing["main path (uint16)"]
    kernels = [{
        "name": "ingest_scan",
        "route": "cuda",
        "source": "hashgraph_tpu_torch/csrc/ingest_scan.cu",
        "replaces": "hashgraph_tpu/ops/pallas_ingest.py:83",
        "implementation": "hand-written CUDA C++ for sm_90a, one thread per touched row; "
                          "a row's cells read as vectors and the mask bytes of up to 32 "
                          "votes gathered before the walk; one launch a call (a second "
                          "only for pad rows)",
        "launches": main_launches,
        "launches_per_call": per_call,
        "launches_config2": launches2,
        "launches_timeouts": launches5,
        "launches_spill": spill_launches,
        "launches_proposals": proposals["launches"].get("ingest_scan", 0),
        "launches_wal": {
            "config3_wire_crashed_node": wal["a"]["launches"].get("ingest_scan", 0),
            "config3_wire_replay": wal["a"]["replay_launches"].get("ingest_scan", 0),
            "multi_scope": wal["b"]["launches"].get("ingest_scan", 0),
            "wire_verify": wal["c"]["launches"].get("ingest_scan", 0)},
        "launches_tier": {
            "late_votes": tier["a"]["launches"].get("ingest_scan", 0),
            "durable_replay": tier["b"]["launches"].get("ingest_scan", 0)},
        "parity": "bit-exact against the plain PyTorch scan (uint8, uint16, int32 grids; "
                  "pad rows; depths 8, 70 and 128)",
        "max_abs_err": 0,
        "ms": main_timing["ms"],
        "plain_ms": main_timing["plain_ms"],
        "bound_ms": main_timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "call_ms": main_timing["call_ms"],
        "config2_call_ms": timing["config 2's call (uint16)"]["ms"],
        "launches_obs": obs_out["launches"].get("ingest_scan", 0),
        "launches_bridge": bridge_launches(bridge, "ingest_scan"),
        "profiled_ms": obs_out["profile"]["ingest_scan"]["ms"],
    }]
    scan_14 = gossip_sync_launches(gossip_sync, "ingest_scan")
    kernels[0].update(launches_gossip=scan_14[0], launches_catchup=scan_14[1],
                      launches_sim=scan_14[2])
    kernels[0].update(
        launches_sharded={"total": placement["a"]["launches"],
                          "per_shard": placement["a"]["per_shard"]},
        launches_multihost=placement["b"]["launches"])
    kernels[0].update(
        launches_fleet={"total": fleet["a"]["launches"], "per_shard": fleet["a"]["per_shard"],
                        "signed": fleet["signed"]["launches"].get("ingest_scan", 0),
                        "recovery": fleet["b"]["b1"]["launches"].get("ingest_scan", 0)},
        launches_federation={"fabric": fleet["b"]["b2"]["launches"].get("ingest_scan", 0),
                             "collective": fleet["c"]["launches"]})
    kernels[0].update(launches_examples={
        name: counts.get("ingest_scan", 0) for name, counts in examples["launches"].items()})
    crypto = [
        ("fe_mul", "fe_mul.cu", fe_mul_timing,
         "one thread per lane, uint32 columns in registers; decompression's products "
         "outside the chain",
         "bit-exact against field._mul_plain at [16384, 16] (boundary and ripple rows)"),
        ("fe_pow22523", "fe_pow22523.cu", pow_timing,
         "a group of kPowGroup threads per lane running the 262-product chain in "
         "registers, each holding its limbs of every element",
         "bit-exact against field._pow22523_plain at [8192, 16] (boundary and ripple rows)"),
        ("msm_windows", "ed_msm.cu", msm_timings[0],
         "a group of kGroup threads per lane, each holding its limbs of the accumulator "
         "and exchanging operand limbs by shuffles; the 16-entry table (uint16, "
         "lane-major, in L2) and 64 windows",
         "bit-exact against msm._windows_plain at [16384, 4, 16], accepting and rejecting"),
        ("msm_reduce", "ed_msm.cu", msm_timings[1],
         f"the tree and the cofactored identity test: blocks of "
         f"{msm_timings[1]['points_per_block']} points run their levels in shared memory, "
         "a group of kTreeGroup threads a point, and one single-block launch runs the "
         "rest, 8 * root and the test; ms is the whole call",
         "root limbs and verdict equal to msm._reduce_plain and msm._final_plain at 16384 "
         "lanes (accepting and rejecting) and at odd and block-crossing counts"),
    ]
    for name, source, t, design, parity in crypto:
        gossip_14, catchup_14, sim_14 = gossip_sync_launches(gossip_sync, name)
        at_catchup = gossip_sync["b"]["times"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"hashgraph_tpu_torch/csrc/{source}",
            "replaces": "hashgraph_tpu/crypto_device/pallas_msm.py:65",
            "implementation": f"hand-written CUDA C++ for sm_90a, {design}",
            "launches": verify["launches"].get(name, 0),
            "launches_blame_call": verify["launches_blame"].get(name, 0),
            "launches_proposals": proposals["launches"].get(name, 0),
            "launches_wal": wal["c"]["launches"].get(name, 0),
            "launches_wal_damaged_frame": wal["c"]["launches_blame"].get(name, 0),
            "launches_obs": obs_out["verify_launches"].get(name, 0),
            "launches_bridge": bridge_launches(bridge, name),
            "launches_gossip": gossip_14,
            "launches_catchup": catchup_14,
            "launches_sim": sim_14,
            "launches_fleet": fleet["signed"]["launches"].get(name, 0),
            "launches_federation": fleet["b"]["b2"]["launches"].get(name, 0),
            "launches_examples": examples["launches"]["gossip_peer_ed25519"].get(name, 0),
            "catchup_shape": at_catchup["shape"],
            "catchup_ms": at_catchup["ms"],
            "catchup_bound_ms": at_catchup["bound_ms"],
            "catchup_bound_by": at_catchup["bound_by"],
            "parity": parity,
            "library_ms": None,
            **t,
            "profiled_ms": obs_out["profile"][name]["ms"],
        })
    log("[obs] profiled device time a launch (phase 12 (d), torch.profiler) beside the "
        "CUDA-event time of the same kernel in this run: " + "; ".join(
            f"{k['name']} {k['profiled_ms']:.6f} ms against {k['ms']:.6f} ms"
            for k in kernels))
    kernels.append({
        "name": "sha512",
        "route": "cuda",
        "source": "hashgraph_tpu_torch/csrc/sha512.cu",
        "replaces": None,
        "implementation": "hand-written CUDA C++ for sm_90a, one thread per lane padding its "
                          "own ragged message in registers, state and schedule window as "
                          "64-bit words in registers, K in constant memory; the JAX package "
                          "leaves SHA-512 to XLA, the port's plain version is "
                          "crypto_device/sha512.py::_sha512_blocks",
        "launches": verify["launches"].get("sha512", 0),
        "launches_blame_call": verify["launches_blame"].get("sha512", 0),
        "parity": "bit-exact against _sha512_blocks on the card and hashlib at 8 and 16384 "
                  "lanes, 1-4 blocks, ragged lengths",
        "library_ms": None,
        **sha512_timing,
    })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def stop_children() -> None:
    """Stop every process this one started that still runs (a compiler left
    by a failed build): each is killed and named on stderr."""
    import os
    import signal

    me = os.getpid()
    left = [int(pid) for task in os.listdir(f"/proc/{me}/task")
            for pid in Path(f"/proc/{me}/task/{task}/children").read_text().split()]
    for pid in left:
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)
    if left:
        print(f"chip_smoke: killed child processes still running: {left}", file=sys.stderr)


if __name__ == "__main__" and sys.argv[1:2] == ["--run-example"]:
    sys.exit(run_example(sys.argv[2], sys.argv[3:]))
elif __name__ == "__main__" and sys.argv[1:2] == ["--fleet-twin"]:
    torch.set_num_threads(2)
    fleet_twin(sys.argv[2])
elif __name__ == "__main__":
    try:
        code = main()
    except BaseException:
        import traceback

        traceback.print_exc()
        code = 1
    stop_children()
    sys.exit(code)
