"""The chaos scenario corpus: composed, reproducible adversity.

Every scenario drives a :class:`~hashgraph_tpu_torch.sim.cluster.SimCluster`
through real traffic while injecting one family of faults, then hands
the cluster to the four machine-checked verdicts
(:mod:`hashgraph_tpu_torch.sim.verdicts`): convergence, exact-culprit
accountability, honest-decision safety, and bounded-decide /
zero-stale-conviction liveness. ``run_scenario(name, seed)`` is
a pure function of its arguments — same seed, byte-identical verdict
JSON, on the card or the CPU alike — which is what makes the corpus a
regression harness rather than a demo: run at pinned seeds, any change
that breaks a failure path breaks a deterministic assert, not a flake.

The corpus (sixteen scenarios):

- ``partition-heal``        — symmetric split, per-side progress, heal
- ``asymmetric-partition``  — requests deliver, responses die (one-way)
- ``storm``                 — drop + duplicate + reorder on every link
- ``crash-restart-wal``     — kill -9 mid-append (torn tail), WAL recovery
- ``crash-restart-catchup`` — disk loss, snapshot+tail catch-up escalation
- ``equivocator``           — signed double-voting, faulty + verified evidence
- ``forker``                — divergent chain delivery, fork evidence
- ``expired-spam-burst``    — expired gossip + in-flight signature corruption
- ``columnar-wire-storm``   — mutated OP_VOTE_BATCH frames convicted by the
  COLUMNAR wire validator (zero-copy server path, wire_columnar pinned on)
- ``timeout-liveness``      — embedder timeouts decide identically everywhere
- ``tiered-crash-recovery`` — kill-9 with demoted sessions (WAL recovery) +
  lost-disk catch-up from tiered sources, fingerprint equality throughout
- ``slo-burn``              — hot-shard overload against a declared decide
  objective: burn-rate alert fires, clears on heal, ONE incident dump
- ``flapping-links``        — a peer's links flap far outside its heartbeat
  cadence but far under the binary stale floor: only φ-accrual can see it,
  and the suspicion must clear itself on heal
- ``slow-never-dead``       — a slow-but-alive peer whose adapted φ history
  tolerates a silence that convicts its metronome-cadence neighbours
- ``stale-partial-synchrony`` — a stall past BOTH detectors (φ and the
  binary floor); after GST the convictions must clear with zero operator
  action — the liveness verdict at full strength

A corpus run can also prove the harness is not blind to itself:
``blind=True`` disables the health/evidence layer (the deliberately
broken injector run) and the accountability
verdict MUST fail.
"""

from __future__ import annotations

import shutil
import tempfile

from ..obs.health import GRADE_FAULTY, GRADE_SUSPECT
from ..wal import scan
from .byzantine import ByzantineActor
from .cluster import SimCluster
from .verdicts import (
    accountability_verdict,
    convergence_verdict,
    liveness_verdict,
    safety_verdict,
)


def _blind(cluster: SimCluster) -> None:
    """The deliberately-broken run: replay mode pauses every engine's
    health accounting, so injected misbehavior leaves no scorecard or
    evidence trail — the accountability verdict must catch the silence."""
    for peer in cluster.peers:
        peer.engine.set_replay_mode(True)


def _finish(
    cluster: SimCluster,
    culprits: "dict[str, str]",
    checks: "dict[str, bool] | None" = None,
    detail: "dict | None" = None,
) -> dict:
    traffic = cluster.drain_all()
    convergence = convergence_verdict(cluster)
    accountability = accountability_verdict(cluster, culprits)
    safety = safety_verdict(cluster)
    # Liveness runs LAST: "the network has stabilized" means after
    # convergence's repair rounds have run.
    liveness = liveness_verdict(cluster)
    checks = dict(checks or {})
    passed = (
        convergence["ok"]
        and accountability["ok"]
        and safety["ok"]
        and liveness["ok"]
        and all(checks.values())
    )
    return {
        "passed": passed,
        "verdicts": {
            "convergence": convergence,
            "accountability": accountability,
            "safety": safety,
            "liveness": liveness,
        },
        "checks": checks,
        "network": cluster.network.stats.as_dict(),
        "traffic": traffic,
        "detail": dict(detail or {}),
    }


# ── scenario bodies: (cluster) -> (culprits, checks, detail) ───────────


def _partition_heal(c: SimCluster):
    pre = c.create_session(c.peer(0), "pre")
    c.vote_all(pre)
    c.network.partition(["p0", "p1"], ["p2", "p3"])
    left = c.create_session(c.peer(0), "left")
    for i in (0, 1):
        c.cast_vote(left, c.peer(i), True)
    right = c.create_session(c.peer(2), "right")
    for i in (2, 3):
        c.cast_vote(right, c.peer(i), True)
    blocked_mid = c.network.stats.blocked
    c.network.heal_partition()
    c.anti_entropy_round()
    for i in (2, 3):
        c.cast_vote(left, c.peer(i), True)
    for i in (0, 1):
        c.cast_vote(right, c.peer(i), True)
    return {}, {"partition_dropped_frames": blocked_mid > 0}, {
        "blocked_during_partition": blocked_mid
    }


def _asymmetric_partition(c: SimCluster):
    pre = c.create_session(c.peer(0), "pre")
    c.vote_all(pre)
    # One-way: frames FROM p1/p2/p3 TO p0 die. p0's own requests still
    # EXECUTE on the others — only the answers are lost, so p0 mutates
    # the world while believing every call failed.
    c.network.partition(["p1", "p2", "p3"], ["p0"], bidirectional=False)
    outbound = c.create_session(c.peer(0), "outbound")
    c.vote_all(outbound)
    hidden = c.create_session(c.peer(1), "hidden")
    for i in (1, 2, 3):
        c.cast_vote(hidden, c.peer(i), True)
    lost_mid = c.network.stats.response_lost + c.network.stats.blocked
    c.network.heal_partition()
    c.anti_entropy_round()
    for session in (outbound, hidden):
        c.vote_all(session)
    return {}, {"asymmetric_loss_observed": lost_mid > 0}, {
        "lost_during_partition": lost_mid
    }


def _storm(c: SimCluster):
    names = [p.name for p in c.peers]
    pre = c.create_session(c.peer(0), "pre")
    c.vote_all(pre)
    c.network.set_all_links(names, drop_p=0.2, dup_p=0.25, jitter=3)
    for k in range(3):
        session = c.create_session(c.peer(k % len(c.peers)), f"storm-{k}")
        c.vote_all(session, values=[True, True, True, False])
    stats = c.network.stats
    dropped, duplicated = stats.dropped, stats.duplicated
    c.network.clear_faults()
    for session in c.sessions:
        c.vote_all(session)  # finish the turns the storm ate
    return {}, {
        "storm_dropped_frames": dropped > 0,
        "storm_duplicated_frames": duplicated > 0,
    }, {"dropped": dropped, "duplicated": duplicated}


def _crash_restart_wal(c: SimCluster):
    pre = c.create_session(c.peer(0), "pre")
    c.vote_all(pre)
    victim = c.peer(1)
    target = c.create_session(c.peer(0), "crashy")
    for i in (0, 2):
        c.cast_vote(target, c.peer(i), True)
    # kill -9 mid-append: the victim's own vote tears on disk.
    wal_directory = victim.durable.wal.directory
    victim.crash_mid_append(target, torn_bytes=9)
    torn = scan(wal_directory).torn_bytes
    while_down = c.create_session(c.peer(2), "while-down")
    c.vote_all(while_down)
    victim.restart()
    recovery = victim.last_recovery
    c.cast_vote(target, victim, True)
    c.cast_vote(while_down, victim, True)
    return {}, {
        "torn_write_on_disk": torn > 0,
        "recovery_replayed_records": recovery.records_applied > 0,
        "recovery_clean": not recovery.errors
        and recovery.segments_dropped == 0,
    }, {
        "torn_bytes": torn,
        "records_replayed": recovery.records_applied,
        "votes_replayed": recovery.votes_replayed,
    }


def _crash_restart_catchup(c: SimCluster):
    for k in range(5):
        session = c.create_session(c.peer(k % 3), f"hist-{k}")
        c.vote_all(session)
    victim = c.peer(3)
    victim.crash()
    while_down = c.create_session(c.peer(0), "while-down")
    c.vote_all(while_down)
    victim.restart(wipe=True)  # the disk is gone: rejoin as a fresh peer
    # The fresh node's first repair round must escalate to a full
    # snapshot+tail catch-up (CatchUpClient over the sim fabric) instead
    # of absorbing the history as thousands of deliver frames.
    victim.node.anti_entropy(c.now)
    c.run_network()
    occupancy = victim.engine.occupancy()
    return {}, {
        "catchup_escalated": c.catchups >= 1,
        "sessions_installed": occupancy.get("live_sessions", 0) >= 5,
    }, {
        "catchups": c.catchups,
        "sessions_after_catchup": occupancy.get("live_sessions", 0),
    }


def _equivocator(c: SimCluster):
    byz = ByzantineActor(c)
    pre = c.create_session(c.peer(0), "pre")
    c.vote_all(pre)
    target = c.create_session(c.peer(0), "target")
    c.cast_vote(target, c.peer(0), True)
    byz.equivocate(target)
    for i in (1, 2):
        c.cast_vote(target, c.peer(i), True)
    culprit = byz.identity.hex()
    alert_everywhere = all(
        any(
            alert["rule"] == "peer-faulty"
            for alert in peer.monitor.evaluate_alerts(now=c.now)
        )
        for peer in c.live_peers()
    )
    evidence_everywhere = all(
        peer.monitor.evidence_count() >= 1 for peer in c.live_peers()
    )
    return {culprit: GRADE_FAULTY}, {
        "peer_faulty_alert_everywhere": alert_everywhere,
        "evidence_everywhere": evidence_everywhere,
    }, {"culprit": culprit}


def _forker(c: SimCluster):
    byz = ByzantineActor(c)
    target = c.create_session(c.peer(0), "forked")
    for i in (0, 1):
        c.cast_vote(target, c.peer(i), True)
    byz.join(target)  # the forker's legitimate vote — its fork replaces it
    c.cast_vote(target, c.peer(2), True)
    byz.fork_deliver(target)
    culprit = byz.identity.hex()
    evidence_everywhere = all(
        peer.monitor.evidence_count() >= 1 for peer in c.live_peers()
    )
    return {culprit: GRADE_SUSPECT}, {
        "fork_evidence_everywhere": evidence_everywhere,
    }, {"culprit": culprit}


def _expired_spam_burst(c: SimCluster):
    byz = ByzantineActor(c)
    live = c.create_session(c.peer(0), "live")
    for i in (0, 1):
        c.cast_vote(live, c.peer(i), True)
    byz.arm_frame_mutation()
    byz.signature_burst(live, count=5)
    byz.expired_spam("junk", count=4)
    culprit = byz.identity.hex()
    cards = [
        peer.monitor.scorecard(byz.identity) or {}
        for peer in c.live_peers()
    ]
    burst_alert = all(
        any(
            alert["rule"] == "invalid-signature-burst"
            for alert in peer.monitor.evaluate_alerts(now=c.now)
        )
        for peer in c.live_peers()
    )
    for i in (2, 3):
        c.cast_vote(live, c.peer(i), True)
    return {culprit: GRADE_SUSPECT}, {
        "invalid_signatures_scored": all(
            card.get("invalid_signatures", 0) >= 4 for card in cards
        ),
        "expired_gossip_scored": all(
            card.get("expired_gossip", 0) >= 1 for card in cards
        ),
        "signature_burst_alert": burst_alert,
        "frames_mutated": c.network.stats.mutated > 0,
    }, {"culprit": culprit, "mutated_frames": c.network.stats.mutated}


def _columnar_wire_storm(c: SimCluster):
    """OP_VOTE_BATCH frames through the COLUMNAR server path with link
    mutation armed: the byte-mutation injector's corrupted signatures
    must be convicted by the columnar validator (native parser or its
    Python twin — the cluster pins wire_columnar=True), not the object
    path, and all three verdicts must still hold."""
    from ..obs import WIRE_COLUMNAR_FRAMES_TOTAL, WIRE_FALLBACK_FRAMES_TOTAL
    from ..obs import registry as _registry

    frames0 = _registry.counter(WIRE_COLUMNAR_FRAMES_TOTAL).value
    fallback0 = _registry.counter(WIRE_FALLBACK_FRAMES_TOTAL).value
    byz = ByzantineActor(c)
    pre = c.create_session(c.peer(0), "pre")
    c.vote_all(pre)
    live = c.create_session(c.peer(0), "live")
    for i in (0, 1):
        c.cast_vote(live, c.peer(i), True)
    byz.arm_frame_mutation()
    byz.signature_burst(live, count=5)
    culprit = byz.identity.hex()
    cards = [
        peer.monitor.scorecard(byz.identity) or {} for peer in c.live_peers()
    ]
    burst_alert = all(
        any(
            alert["rule"] == "invalid-signature-burst"
            for alert in peer.monitor.evaluate_alerts(now=c.now)
        )
        for peer in c.live_peers()
    )
    for i in (2, 3):
        c.cast_vote(live, c.peer(i), True)
    columnar = (
        _registry.counter(WIRE_COLUMNAR_FRAMES_TOTAL).value - frames0
    )
    fallback = (
        _registry.counter(WIRE_FALLBACK_FRAMES_TOTAL).value - fallback0
    )
    return {culprit: GRADE_SUSPECT}, {
        # The point of the scenario: the mutated frames went through the
        # columnar decode+validate path (mutated signatures stay
        # canonical bytes, so nothing should have fallen back), and the
        # rejects were scored against the claimed signer.
        "columnar_path_decoded_frames": columnar > 0,
        "no_object_path_fallbacks": fallback == 0,
        "frames_mutated": c.network.stats.mutated > 0,
        "invalid_signatures_scored": all(
            card.get("invalid_signatures", 0) >= 4 for card in cards
        ),
        "signature_burst_alert": burst_alert,
    }, {
        "culprit": culprit,
        "columnar_frames": columnar,
        "mutated_frames": c.network.stats.mutated,
    }


def _roll_deploy(c: SimCluster):
    """Rolling deploy: restart every host ONE AT A TIME under sustained
    traffic — each peer in turn is kill-9'd (WAL handles abandoned, no
    final fsync) and brought back through real WAL recovery while the
    survivors keep creating and deciding sessions. The federation
    acceptance shape: zero lost decisions (every session decides, and
    identically, on every peer) and cross-host fingerprint equality
    after the LAST heal."""
    pre = c.create_session(c.peer(0), "pre")
    c.vote_all(pre)
    n = len(c.peers)
    recoveries = []
    for k in range(n):
        victim = c.peer(k)
        # Traffic DURING the roll: a session created before the restart
        # reaches quorum among the other peers (ceil(2n/3) of n needs no
        # single fixed voter), one created while the victim is down is
        # ferried around it, and both must repair onto the restarted
        # peer afterwards.
        rolling = c.create_session(c.peer((k + 1) % n), f"roll-{k}")
        for i, peer in enumerate(c.peers):
            if peer is victim or peer.crashed:
                continue
            c.cast_vote(rolling, peer, True)
        victim.crash()
        while_down = c.create_session(c.peer((k + 1) % n), f"down-{k}")
        c.vote_all(while_down)
        victim.restart()  # the real ADD_PEER -> recover() replay path
        recoveries.append(victim.last_recovery)
        c.anti_entropy_round()
    heal = c.converge()
    # Zero lost decisions: every session created during the roll is
    # DECIDED, identically, on every (now live) peer.
    lost = []
    for session in c.sessions:
        results = c.results(session)
        values = set(results.values())
        if len(values) != 1 or not isinstance(next(iter(values)), bool):
            lost.append({session.scope: results})
    return {}, {
        "every_host_restarted": all(p.restarts >= 1 for p in c.peers),
        "recoveries_clean": all(
            r is not None and not r.errors and r.segments_dropped == 0
            for r in recoveries
        ),
        "zero_lost_decisions": not lost,
        "healed_after_last_restart": heal["ok"],
    }, {
        "restarts": [p.restarts for p in c.peers],
        "sessions": len(c.sessions),
        "heal_rounds": heal["rounds"],
        "lost": lost[:4],
    }


def _tiered_crash_recovery(c: SimCluster):
    """Storage tiering under crashes: a peer DEMOTES decided history to
    its serialized tier, demand-pages one session back under live
    traffic, is kill-9'd with the rest still demoted, and WAL-recovers
    to fingerprint equality (the tier is a rebuildable cache — recovery
    legitimately rebuilds demoted sessions as live, and the
    order-insensitive fingerprint cannot tell). A second victim then
    loses its DISK and rejoins through snapshot+tail catch-up served
    from tiered sources — the snapshot build must read straight through
    the tier."""
    history = [c.create_session(c.peer(k % 3), f"hist-{k}") for k in range(5)]
    for session in history:
        c.vote_all(session)
    victim = c.peer(1)
    demoted = sum(
        bool(victim.engine.demote_session(s.scope, s.pid)) for s in history
    )
    # Demand-page under traffic: a live session is demoted mid-vote and
    # the next votes (incl. the victim's own cast) must promote + apply
    # exactly as if it had never left.
    live = c.create_session(c.peer(0), "live")
    for i in (0, 2):
        c.cast_vote(live, c.peer(i), True)
    victim.engine.demote_session(live.scope, live.pid)
    promotions0 = victim.engine.occupancy()["tier_promotions_total"]
    for i in (1, 3):
        c.cast_vote(live, c.peer(i), True)
    promotions = victim.engine.occupancy()["tier_promotions_total"] - promotions0
    tier_at_crash = victim.engine.occupancy()["tier_sessions"]
    victim.crash()
    while_down = c.create_session(c.peer(2), "while-down")
    c.vote_all(while_down)
    victim.restart()  # WAL recovery with demoted history in the log
    recovery = victim.last_recovery
    c.cast_vote(while_down, victim, True)
    # Lost-disk joiner: every surviving source demotes the history, so
    # the catch-up snapshot is built from tiered engines.
    joiner = c.peer(3)
    for peer in c.live_peers():
        if peer is joiner:
            continue
        for session in history:
            try:
                peer.engine.demote_session(session.scope, session.pid)
            except Exception:
                pass  # already demoted / evicted — the tier is policy
    joiner.crash()
    joiner.restart(wipe=True)
    joiner.node.anti_entropy(c.now)
    c.run_network()
    occupancy = joiner.engine.occupancy()
    return {}, {
        "history_demoted": demoted >= 4,
        "demand_page_promoted": promotions >= 1,
        "demoted_at_crash": tier_at_crash >= 1,
        "recovery_clean": not recovery.errors and recovery.segments_dropped == 0,
        "recovery_replayed_records": recovery.records_applied > 0,
        "catchup_escalated": c.catchups >= 1,
        "joiner_reinstalled_history": occupancy.get("live_sessions", 0)
        + occupancy.get("tier_sessions", 0) >= 5,
    }, {
        "demoted": demoted,
        "tier_at_crash": tier_at_crash,
        "promotions": promotions,
        "records_replayed": recovery.records_applied,
        "catchups": c.catchups,
    }


def _timeout_liveness(c: SimCluster):
    # expected_voters past the live peer count: the session can only
    # decide through the embedder's timeout duty.
    target = c.create_session(c.peer(0), "needs-timeout", voters=8)
    c.vote_all(target)
    c.converge()  # every peer must time out on the same view
    fired = c.fire_timeout(target)
    results = c.results(target)
    decided = {
        name: value for name, value in results.items()
        if isinstance(value, bool)
    }
    return {}, {
        "every_peer_decided_at_timeout": len(decided) == len(c.live_peers()),
        "timeout_decisions_agree": len(set(decided.values())) <= 1,
    }, {"fired": fired, "results_after_timeout": {
        k: results[k] for k in sorted(results)
    }}


def _slo_burn(c: SimCluster):
    """Deterministic hot-shard overload against a declared decide-latency
    objective: a private :class:`~hashgraph_tpu_torch.obs.slo.SloEngine` rides
    the cluster's VIRTUAL clock (ticks as seconds — no wall time, so the
    alert trajectory is a pure function of the seed) while real consensus
    traffic supplies the trace ids. Healthy baseline -> injected slowdown
    (every decision breaches) -> the multi-window burn-rate alert MUST
    fire; heal -> the fast window recovers and the alert MUST clear; and
    the breach storm collapses into exactly ONE incident dump whose
    ``incident.json`` links the breaching decision's trace id."""
    import json as _json
    import os

    from ..obs.slo import IncidentCapture, SloEngine

    clock = lambda: float(c.now)  # noqa: E731 — the cluster's virtual clock
    incident_root = os.path.join(c.root, "incidents")
    slo = SloEngine(
        clock=clock,
        capture=IncidentCapture(
            incident_root, cooldown_s=10**9, clock=clock
        ),
    )
    hot_scope = "chaos/hot"
    objective_s = 0.05  # a 50ms decide p99 objective on the hot scope

    def decide(tag: str) -> "str | None":
        session = c.create_session(c.peer(0), tag)
        c.vote_all(session)
        ctx = session.origin.engine.trace_context_of(
            session.scope, session.pid
        )
        return ctx.trace_id.hex() if ctx is not None else None

    # Phase 1 — healthy baseline: 30 decisions at 5ms over 900 virtual
    # seconds fill the slow window with in-objective traffic.
    for k in range(30):
        trace = decide(f"warm-{k}")
        slo.observe(
            hot_scope, 0.005, shard="hot", objective_s=objective_s,
            trace_hex=trace, now=clock(),
        )
        c.advance_clock(30)

    # Phase 2 — overload: every decision takes 500ms (10x the
    # objective). Both burn windows must cross the threshold.
    breach_trace = None
    for k in range(10):
        trace = decide(f"slow-{k}")
        if breach_trace is None:
            breach_trace = trace
        slo.observe(
            hot_scope, 0.5, shard="hot", objective_s=objective_s,
            trace_hex=trace, now=clock(),
        )
        c.advance_clock(10)
    overload_state = slo.state(now=clock())
    fired_during_overload = hot_scope in overload_state["alerts_firing"]

    # Phase 3 — heal: jump past the fast window, resume healthy traffic;
    # the fast-window burn collapses and the alert clears.
    c.advance_clock(400)
    for k in range(10):
        trace = decide(f"heal-{k}")
        slo.observe(
            hot_scope, 0.005, shard="hot", objective_s=objective_s,
            trace_hex=trace, now=clock(),
        )
        c.advance_clock(10)
    healed_state = slo.state(now=clock())
    hot = healed_state["scopes"][hot_scope]

    incidents = slo.capture.incidents()
    incident_meta = {}
    trace_doc = {}
    if len(incidents) == 1:
        inc_dir = os.path.join(incident_root, incidents[0])
        with open(os.path.join(inc_dir, "incident.json")) as fh:
            incident_meta = _json.load(fh)
        with open(os.path.join(inc_dir, "trace.json")) as fh:
            trace_doc = _json.load(fh)
    return {}, {
        "alert_fired_during_overload": fired_during_overload,
        "alert_cleared_after_heal": hot["alert_firing"] is False,
        "exactly_one_alert_episode": hot["alerts_total"] == 1,
        "exactly_one_incident_dump": len(incidents) == 1,
        "incident_links_breaching_trace": (
            breach_trace is not None
            and incident_meta.get("trace_id") == breach_trace
        ),
        "incident_trace_perfetto_loadable": "traceEvents" in trace_doc,
        "incident_flight_ring_dumped": bool(incidents)
        and os.path.exists(
            os.path.join(incident_root, incidents[0], "flight.jsonl")
        ),
    }, {
        "burn_fast_overload": round(
            overload_state["scopes"][hot_scope]["burn_fast"], 3
        ),
        "burn_fast_healed": round(hot["burn_fast"], 3),
        "breaches_total": hot["breaches_total"],
        "incidents": incidents,
    }


def _flapping_links(c: SimCluster):
    """Link flapping: a healthy peer's links die for a stretch that is
    ~12x its observed heartbeat cadence but four orders of magnitude
    UNDER the binary stale floor (the sessions' 500_000-tick timeout
    hint) — only the φ-accrual detector can see the silence. The
    suspicion must cross the threshold while the links flap (the
    ``peer-suspect-phi`` alert fires on every survivor), the binary
    floor must stay untouched, and the conviction must clear ITSELF the
    moment the links heal and heartbeats resume — zero stale
    convictions survive into the liveness verdict."""
    flappy = c.peer(3)
    others = [c.peer(i) for i in (0, 1, 2)]
    order = [c.peer(0), c.peer(1), c.peer(2), flappy]
    # Warm cadence: rotation-cast 3 of 4 voters per round (a session
    # decides at the 3rd vote — quorum — so a 4th cast would be
    # absorbed unadmitted and earn NO heartbeat) at 10-tick steps;
    # every peer accrues >= min_samples inter-arrival history.
    for k in range(12):
        session = c.create_session(others[k % 3], f"warm-{k}")
        rot = order[k % 4:] + order[: k % 4]
        for voter in rot[:3]:
            c.cast_vote(session, voter, True)
        c.advance_clock(10)
    # Carrier sessions, created FULL-MESH before the flap with
    # expected_voters past the peer count (undecidable by votes):
    # partition-era traffic must be vote-EXTENDS, whose canonical
    # tick-stamped bytes repair byte-identically at any later tick —
    # creating sessions behind a partition and advancing the clock
    # would stamp the repaired copies at repair time and break
    # fingerprint equality (the sim's no-wall-clock contract).
    carriers = [
        c.create_session(c.peer(0), f"carrier-{k}", voters=8)
        for k in range(3)
    ]
    # Flap: flappy's links die both ways. The survivors keep
    # heartbeating (one vote each per carrier round) while flappy's
    # silence grows to ~10x its observed mean inter-arrival.
    c.network.partition(["p0", "p1", "p2"], [flappy.name])
    for carrier in carriers:
        for peer in others:
            c.cast_vote(carrier, peer, True)
        c.advance_clock(40)
    flap_now = c.now
    cards = [
        peer.monitor.snapshot(now=flap_now)["peers"].get(
            flappy.identity.hex(), {}
        )
        for peer in others
    ]
    phi_alert = all(
        any(
            alert["rule"] == "peer-suspect-phi"
            for alert in peer.monitor.evaluate_alerts(now=flap_now)
        )
        for peer in others
    )
    suspected = all(
        card.get("phi", 0.0) >= (card.get("phi_threshold") or float("inf"))
        for card in cards
    )
    # The scenario's point: the silence is invisible to the binary
    # detector (silence << the per-peer floor), yet phi convicted.
    floor_quiet = all(
        (flap_now - card.get("last_seen", 0)) <= card.get("stale_after", 0)
        for card in cards
    )
    # Heal: links return, anti-entropy extends the carrier chains onto
    # flappy, and fresh traffic — flappy casting FIRST, before quorum —
    # resumes its heartbeats; read-time grading clears the suspicion
    # with zero operator action.
    c.network.heal_partition()
    c.anti_entropy_round()
    for k in range(3):
        session = c.create_session(flappy, f"heal-{k}")
        for voter in (flappy, others[k % 3], others[(k + 1) % 3]):
            c.cast_vote(session, voter, True)
        c.advance_clock(10)
    # Settle the carriers: timeout them on a converged view so every
    # peer decides them identically at one tick (the timeout-liveness
    # precedent) — the liveness verdict then sees them decided, not
    # dangling.
    c.converge()
    for carrier in carriers:
        c.fire_timeout(carrier)
    healed = [
        peer.monitor.snapshot(now=c.now)["peers"].get(
            flappy.identity.hex(), {}
        )
        for peer in others
    ]
    cleared = all(
        card.get("phi", 0.0) < (card.get("phi_threshold") or float("inf"))
        and card.get("grade") == "healthy"
        for card in healed
    )
    return {}, {
        "phi_suspected_during_flap": suspected,
        "phi_alert_during_flap": phi_alert,
        "binary_floor_untouched": floor_quiet,
        "suspicion_cleared_after_heal": cleared,
    }, {
        "phi_during_flap": [card.get("phi") for card in cards],
        "phi_after_heal": [card.get("phi") for card in healed],
        "silence_during_flap": [
            flap_now - card.get("last_seen", 0) for card in cards
        ],
    }


def _slow_never_dead(c: SimCluster):
    """A slow-but-alive peer: its heartbeat cadence is ~4-5x the dense
    peers', with genuine jitter, so its φ-accrual history ADAPTS — a
    60-tick probe silence that maxes phi for a 10-tick-metronome peer
    stays unremarkable for it. The slow peer must never be suspected
    (by phi or the floor) while the same probe silence flags its dense
    neighbours — per-peer learned tolerance is the whole point of
    accrual over a global timeout."""
    from ..obs.accrual import phi_from_deviation

    slow = c.peer(3)
    dense = [c.peer(0), c.peer(1)]
    threshold = c.peer(0).monitor.phi_threshold
    # 37 rounds at 10 ticks: p0/p1 vote every round (metronome); the
    # third voting slot alternates p2 / the slow peer, the slow peer on
    # a jittered 40/50-tick schedule (8 intervals, mean 45, std 5 —
    # past min_samples, with real variance). The slow peer votes FIRST
    # in its rounds so its cast is admitted before the session decides.
    slow_rounds = {0, 4, 9, 13, 18, 22, 27, 31, 36}
    for k in range(37):
        session = c.create_session(dense[k % 2], f"cadence-{k}")
        third = slow if k in slow_rounds else c.peer(2)
        for voter in (third, dense[0], dense[1]):
            c.cast_vote(session, voter, True)
        c.advance_clock(10)
    # Probe: a global 60-tick silence. For the slow peer that is
    # (60-45)/5 = 3 standard deviations (phi ~2.9 < threshold); for a
    # metronome peer it is 50 deviations (phi clamps at max).
    c.advance_clock(60)
    probe_now = c.now
    slow_flagged = any(
        slow.identity.hex() in peer.monitor.watchdog(now=probe_now)
        for peer in dense + [c.peer(2)]
    )
    dense_flagged = all(
        dense[1 - i].identity.hex()
        in dense[i].monitor.watchdog(now=probe_now)
        for i in (0, 1)
    )
    slow_phi = max(
        peer.monitor.snapshot(now=probe_now)["peers"]
        .get(slow.identity.hex(), {})
        .get("phi", 0.0)
        for peer in dense
    )
    # The counterfactual, computed not simulated: the slow peer's exact
    # silence at a metronome cadence (mean 10, floor std 1.0) would
    # convict outright.
    counterfactual = phi_from_deviation((60 - 10) / 1.0)
    # Resume: rotation-cast so EVERY peer (the slow one included) gets
    # an admitted vote — vote_all would absorb the 4th cast on an
    # already-decided session and leave one peer heartbeat-less — and
    # the probe-induced suspicion clears before the verdicts read the
    # cluster.
    order = [c.peer(0), c.peer(1), c.peer(2), slow]
    for k in range(4):
        session = c.create_session(dense[k % 2], f"resume-{k}")
        rot = order[k:] + order[:k]
        for voter in rot[:3]:
            c.cast_vote(session, voter, True)
        c.advance_clock(10)
    return {}, {
        "slow_peer_never_suspected": not slow_flagged,
        "dense_cadence_flagged_at_probe": dense_flagged,
        "slow_phi_below_threshold": threshold is not None
        and slow_phi < threshold,
        "metronome_counterfactual_convicts": threshold is not None
        and counterfactual >= threshold,
    }, {
        "slow_phi_at_probe": round(slow_phi, 3),
        "metronome_phi_counterfactual": round(counterfactual, 3),
        "phi_threshold": threshold,
    }


def _stale_partial_synchrony(c: SimCluster):
    """Partial synchrony's pathological stretch: the WHOLE fabric
    stalls past both detectors at once — the logical clock jumps beyond
    the binary floor (the sessions' 500_000-tick timeout hint; the
    cluster pins ``stale_after`` under it so the hint genuinely IS the
    floor) while φ maxes everywhere — so every monitor convicts every
    other peer as stale while the stall lasts. Then GST passes: traffic
    resumes, and BOTH convictions must clear on every monitor with zero
    operator action. A silence-driven conviction that survives GST is
    exactly what the liveness verdict's ``stale_convictions`` list
    exists to catch. (No partition is needed: a global stall is just
    the clock — which also keeps every session's repair tick equal to
    its creation tick, the fingerprint-equality contract.)"""
    order = [c.peer(i) for i in range(4)]
    hexes = [p.identity.hex() for p in order]
    # Warm cadence: rotation-cast (see _flapping_links) — every peer
    # accrues phi history and a fresh last_seen before the stall.
    for k in range(12):
        session = c.create_session(order[k % 4], f"warm-{k}")
        rot = order[k % 4:] + order[: k % 4]
        for voter in rot[:3]:
            c.cast_vote(session, voter, True)
        c.advance_clock(10)
    # The stall: no frames, no votes, and the logical clock jumps past
    # the 500_000-tick floor. Every warm session is already decided, so
    # nothing expires under the jump.
    c.advance_clock(600_001)
    stall_now = c.now
    views = {
        peer.name: peer.monitor.snapshot(now=stall_now)["peers"]
        for peer in order
    }
    cross_cards = [
        views[peer.name].get(hexid, {})
        for peer in order
        for hexid in hexes
        if hexid != peer.identity.hex()
    ]
    floor_tripped = all(
        card.get("stale") is True
        and card.get("stale_after", 0) >= 500_000
        and (stall_now - card.get("last_seen", 0)) > card.get("stale_after", 0)
        for card in cross_cards
    )
    phi_maxed = all(
        card.get("phi", 0.0) >= (card.get("phi_threshold") or float("inf"))
        for card in cross_cards
    )
    convicted_everywhere = all(
        set(hexes) - {peer.identity.hex()}
        <= set(peer.monitor.watchdog(now=stall_now))
        for peer in order
    )
    # GST: traffic resumes (rotation so every peer's cast is admitted
    # somewhere before quorum) — heartbeats land everywhere and
    # read-time grading clears both detectors at once.
    for k in range(4):
        session = c.create_session(order[k % 4], f"gst-{k}")
        rot = order[k:] + order[:k]
        for voter in rot[:3]:
            c.cast_vote(session, voter, True)
        c.advance_clock(10)
    honest = set(hexes)
    lingering = sorted(
        set().union(
            *(
                set(peer.monitor.watchdog(now=c.now)) & honest
                for peer in c.live_peers()
            )
        )
    )
    return {}, {
        "floor_tripped_during_stall": floor_tripped,
        "phi_maxed_during_stall": phi_maxed,
        "stale_convicted_during_stall": convicted_everywhere,
        "convictions_cleared_after_gst": not lingering,
    }, {
        "silence_at_stall": sorted(
            {stall_now - card.get("last_seen", 0) for card in cross_cards}
        ),
        "floor_at_stall": sorted(
            {card.get("stale_after", 0) for card in cross_cards}
        ),
        "lingering_convictions": lingering,
    }


class _Spec:
    __slots__ = ("body", "cluster_kwargs")

    def __init__(self, body, **cluster_kwargs):
        self.body = body
        self.cluster_kwargs = cluster_kwargs


SCENARIOS: "dict[str, _Spec]" = {
    # fanout=2: the sticky per-session sampled fan-out path — peers
    # outside a session's sample miss it wholly and anti-entropy must
    # create it wholesale (the repairable-by-design divergence).
    "partition-heal": _Spec(_partition_heal, fanout=2),
    "asymmetric-partition": _Spec(_asymmetric_partition),
    "storm": _Spec(_storm),
    "crash-restart-wal": _Spec(_crash_restart_wal),
    "crash-restart-catchup": _Spec(_crash_restart_catchup, escalate_sessions=4),
    "equivocator": _Spec(_equivocator),
    "forker": _Spec(_forker),
    "expired-spam-burst": _Spec(_expired_spam_burst),
    # wire_columnar pinned True: the scenario asserts the columnar wire
    # path itself, so the HASHGRAPH_TPU_WIRE_COLUMNAR env override must
    # not be able to change what it measures.
    "columnar-wire-storm": _Spec(_columnar_wire_storm, wire_columnar=True),
    # Rolling restart of every host, one at a time, under traffic — the
    # federation roll-deploy criterion: zero lost decisions plus
    # cross-host fingerprint equality after the last heal.
    "roll-deploy": _Spec(_roll_deploy),
    "timeout-liveness": _Spec(_timeout_liveness),
    # Kill-9 of a peer holding DEMOTED sessions (WAL recovery), plus a
    # lost-disk joiner catching up from tiered sources — the storage-
    # tiering criterion: the tier is a cache, fingerprints cannot tell.
    "tiered-crash-recovery": _Spec(
        _tiered_crash_recovery, escalate_sessions=4
    ),
    # Hot-shard SLO overload on the virtual clock: burn-rate alert fires
    # during the slowdown, clears after the heal, exactly one
    # exemplar-linked incident dump — the observability-plane criterion.
    "slo-burn": _Spec(_slo_burn),
    # φ-accrual liveness battery: suspicion that only the
    # accrual detector can see, per-peer learned tolerance, and a stall
    # past BOTH detectors — all three must end with zero stale
    # convictions under the fourth (liveness) verdict.
    "flapping-links": _Spec(_flapping_links),
    "slow-never-dead": _Spec(_slow_never_dead),
    # stale_after pinned UNDER the sessions' timeout hint so the binary
    # floor sits at the hint (500_000 ticks) and the 600_001-tick stall
    # genuinely trips it.
    "stale-partial-synchrony": _Spec(
        _stale_partial_synchrony, stale_after=100_000.0
    ),
}


def run_scenario(
    name: str,
    seed: int,
    *,
    root: "str | None" = None,
    blind: bool = False,
    signer_factory: "type | None" = None,
    overrides: "dict | None" = None,
    device: str = "cuda",
) -> dict:
    """One scenario at one seed -> the verdict JSON (a dict; serialize
    with ``sort_keys=True`` for the byte-identical determinism check).
    ``device`` is where every peer's engines live (``"cuda"`` by
    default, which raises without a GPU); the verdict JSON is the same
    on either device.
    ``blind=True`` disables the health/evidence layer first — the
    harness's self-test that a broken injector run FAILS.
    ``signer_factory`` overrides the cluster's scheme (default stub):
    the device-crypto battery re-runs the signature scenarios with
    ``Ed25519DeviceConsensusSigner`` to prove all four verdicts hold
    when rejects come from the device backend. ``overrides`` merges
    extra SimCluster kwargs over the spec's own — ``{"phi_threshold":
    None}`` runs the binary-watchdog-only baseline arm of the same
    scenario (the liveness A/B)."""
    spec = SCENARIOS[name]
    kwargs = dict(spec.cluster_kwargs)
    if overrides:
        kwargs.update(overrides)
    if signer_factory is not None:
        kwargs["signer_factory"] = signer_factory
    owns_root = root is None
    if owns_root:
        root = tempfile.mkdtemp(prefix=f"hashgraph-chaos-{name}-")
    try:
        with SimCluster(root, seed, device=device, **kwargs) as cluster:
            if blind:
                _blind(cluster)
            culprits, checks, detail = spec.body(cluster)
            result = _finish(cluster, culprits, checks, detail)
    finally:
        if owns_root:
            shutil.rmtree(root, ignore_errors=True)
    result["scenario"] = name
    result["seed"] = seed
    result["blind"] = blind
    return result


def run_corpus(
    seeds: "list[int]",
    names: "list[str] | None" = None,
    *,
    blind: bool = False,
    device: str = "cuda",
) -> dict:
    """The whole corpus × seeds, on ``device`` -> the machine-readable
    summary block: {scenarios: {passed, failed, seeds}, results,
    failures}."""
    names = list(SCENARIOS) if names is None else list(names)
    results: dict[str, dict] = {}
    failures: list[dict] = []
    passed = failed = 0
    for name in names:
        per_seed = {}
        for seed in seeds:
            outcome = run_scenario(name, seed, blind=blind, device=device)
            per_seed[str(seed)] = outcome["passed"]
            if outcome["passed"]:
                passed += 1
            else:
                failed += 1
                failures.append(
                    {
                        "scenario": name,
                        "seed": seed,
                        "verdicts": {
                            key: verdict["ok"]
                            for key, verdict in outcome["verdicts"].items()
                        },
                        "checks": outcome["checks"],
                    }
                )
        results[name] = per_seed
    return {
        "scenarios": {"passed": passed, "failed": failed, "seeds": seeds},
        "results": results,
        "failures": failures,
    }
