"""The four machine-checked verdicts every chaos scenario must pass.

1. **Convergence** — every honest live peer reaches state-fingerprint
   equality (order-insensitive digest over the exact canonical session
   bytes, read over ``OP_STATE_FINGERPRINT``).
2. **Accountability** — the union of the honest peers' health
   convictions (:meth:`HealthMonitor.convicted_peers`) names EXACTLY the
   injected culprits, each at (or past) the grade its misbehavior
   earns, with every retained :class:`EvidenceRecord` verifying OFFLINE
   (:func:`verify_evidence_record` re-checks the signed byte pairs with
   nothing but the scheme — the Polygraph property), and ZERO honest
   peers convicted.
3. **Safety** — no two honest peers decide the same session differently
   (True on one, False on another). Undecided / failed-by-local-timeout
   states are liveness, not safety, and are reported but not violations.
4. **Liveness** — once the network has stabilized (the verdicts run
   after convergence's repair rounds), every session that decided
   ANYWHERE is decided EVERYWHERE, every decision landed within a
   seed-deterministic tick bound of its creation
   (:attr:`SimCluster.decision_ticks`), and ZERO honest peers remain
   under a watchdog conviction — φ-accrual or binary-floor — at verdict
   time (a silence-driven suspicion that survives the heal is a stale
   conviction, the exact failure the read-time grading exists to
   prevent).

A harness must be able to detect its own blindness: a run whose
injectors fired but whose evidence layer was disabled FAILS verdict 2
(culprits uncovered), which is exactly what the corpus's
``blind``-mode self-test asserts.
"""

from __future__ import annotations

from ..obs.health import GRADE_FAULTY, _GRADE_RANK
from ..protocol import compute_vote_hash
from ..wire import Vote
from .cluster import SimCluster


def verify_evidence_record(record: dict, scheme) -> "tuple[bool, str]":
    """Offline re-verification of one evidence record (as_dict form):
    decode the retained byte pair and check it proves what it claims,
    holding nothing but the signature scheme. Returns (ok, reason)."""
    try:
        a = Vote.decode(bytes.fromhex(record["vote_a"]))
        b = Vote.decode(bytes.fromhex(record["vote_b"]))
    except (ValueError, IndexError) as exc:
        return False, f"undecodable evidence bytes: {exc!r}"
    offender = record["offender"]
    if a.vote_hash == b.vote_hash:
        return False, "retained pair does not conflict (equal hashes)"
    # Both kinds meet the double-sign bar: equivocations pair the two
    # conflicting votes the vote path admitted; fork records pair the
    # offender's ACCEPTED vote with its divergent one. Either way the
    # pair proves misbehavior only if both sides are the offender's own
    # validly-signed votes for one proposal.
    if a.vote_owner.hex() != offender or b.vote_owner.hex() != offender:
        return False, f"{record['kind']} pair not owned by the offender"
    if a.proposal_id != b.proposal_id:
        return False, f"{record['kind']} pair spans proposals"
    for side, vote in (("a", a), ("b", b)):
        if compute_vote_hash(vote) != vote.vote_hash:
            return False, f"vote_{side} hash does not recompute"
        if not scheme.verify(
            vote.vote_owner, vote.signing_payload(), vote.signature
        ):
            return False, f"vote_{side} signature fails offline verify"
    return True, "ok"


def accountability_verdict(
    cluster: SimCluster, culprits: "dict[str, str]"
) -> dict:
    """``culprits``: identity-hex -> minimum grade the injection must
    earn (``suspect`` or ``faulty``). Convictions are read from every
    honest live peer's monitor; exactness is two-sided — every culprit
    convicted somewhere at (>=) its grade, and NOBODY else convicted
    anywhere."""
    scheme = cluster.signer_factory
    convicted: dict[str, dict] = {}
    convicting: dict[str, list[str]] = {}
    evidence_total = 0
    evidence_failures: list[str] = []
    for peer in cluster.live_peers():
        for hexid, info in sorted(
            peer.monitor.convicted_peers(now=cluster.now).items()
        ):
            prior = convicted.get(hexid)
            if prior is None or (
                _GRADE_RANK[info["grade"]] > _GRADE_RANK[prior["grade"]]
            ):
                convicted[hexid] = {
                    "grade": info["grade"], "evidence": info["evidence"]
                }
            convicting.setdefault(hexid, []).append(peer.name)
        for record in peer.monitor.evidence():
            evidence_total += 1
            if record["offender"] not in culprits:
                evidence_failures.append(
                    f"{peer.name}: evidence names non-culprit "
                    f"{record['offender'][:12]}"
                )
                continue
            ok, reason = verify_evidence_record(record, scheme)
            if not ok:
                evidence_failures.append(f"{peer.name}: {reason}")
    honest = {p.identity.hex() for p in cluster.peers}
    false_convictions = sorted(set(convicted) & honest)
    missed = sorted(set(culprits) - set(convicted))
    unexpected = sorted(set(convicted) - set(culprits))
    undergraded = sorted(
        hexid
        for hexid, grade in culprits.items()
        if hexid in convicted
        and _GRADE_RANK[convicted[hexid]["grade"]] < _GRADE_RANK[grade]
    )
    missing_evidence = sorted(
        hexid for hexid, grade in culprits.items()
        if grade == GRADE_FAULTY
        and convicted.get(hexid, {}).get("evidence", 0) == 0
    )
    ok = not (
        missed
        or unexpected
        or undergraded
        or false_convictions
        or evidence_failures
        or missing_evidence
    )
    return {
        "ok": ok,
        "expected": dict(sorted(culprits.items())),
        "convicted": {k: convicted[k] for k in sorted(convicted)},
        "convicting_peers": {
            k: sorted(set(v)) for k, v in sorted(convicting.items())
        },
        "false_convictions": false_convictions,
        "missed_culprits": missed,
        "unexpected_convictions": unexpected,
        "undergraded": undergraded,
        "evidence_records": evidence_total,
        "evidence_failures": evidence_failures,
        "culprits_without_evidence": missing_evidence,
    }


def safety_verdict(cluster: SimCluster) -> dict:
    """Cross-peer decision agreement over every session the workload
    created. ``True`` vs ``False`` on two honest peers is the violation;
    None/'failed'/'missing' are liveness states, reported only."""
    violations: list[dict] = []
    decided_sessions = 0
    undecided = 0
    for session in cluster.sessions:
        results = cluster.results(session)
        values = {v for v in results.values() if isinstance(v, bool)}
        if values:
            decided_sessions += 1
        if len(values) > 1:
            violations.append(
                {
                    "scope": session.scope,
                    "proposal_id": session.pid,
                    "results": {k: results[k] for k in sorted(results)},
                }
            )
        undecided += sum(1 for v in results.values() if v is None)
    return {
        "ok": not violations,
        "sessions": len(cluster.sessions),
        "decided_sessions": decided_sessions,
        "undecided_reads": undecided,
        "violations": violations,
    }


def liveness_verdict(
    cluster: SimCluster, *, decide_bound: int = 1_000_000
) -> dict:
    """Decidability, decide latency, and zero stale convictions — run
    LAST, after convergence's repair rounds, so "the network has
    stabilized" is literally true when it reads the cluster.

    Violations:

    - a session decided on some live peer but not on all of them
      (``stuck_sessions`` — decisions must propagate once repair runs);
    - a decision that took more than ``decide_bound`` logical ticks from
      the session's creation (``late_decisions`` — the bound is generous
      but fixed, so a determinism regression that stalls deciding trips
      a hard assert instead of drifting silently);
    - any honest peer still flagged by any live peer's liveness watchdog
      (φ-accrual or binary silence floor) at verdict time
      (``stale_convictions`` — suspicion is graded at read time exactly
      so heal clears it; one surviving is a bug, not a judgment call).

    Sessions no peer decided are ``undecidable`` (quorum genuinely out
    of reach — e.g. expected_voters past the live set with no timeout
    fired) and are reported, not violations: decidability is the
    scenario's claim to make, propagation and promptness are this
    verdict's.
    """
    cluster.note_decisions()
    stuck: "list[dict]" = []
    late: "list[dict]" = []
    undecidable = 0
    max_ticks = 0
    for session in cluster.sessions:
        results = cluster.results(session)
        decided = [v for v in results.values() if isinstance(v, bool)]
        if not decided:
            undecidable += 1
            continue
        if len(decided) != len(results):
            stuck.append(
                {
                    "scope": session.scope,
                    "proposal_id": session.pid,
                    "results": {k: results[k] for k in sorted(results)},
                }
            )
        tick = cluster.decision_ticks.get((session.scope, session.pid))
        if tick is None:
            continue
        took = tick - session.created_tick
        if took > max_ticks:
            max_ticks = took
        if took > decide_bound:
            late.append(
                {
                    "scope": session.scope,
                    "proposal_id": session.pid,
                    "ticks": took,
                }
            )
    honest = {p.identity.hex() for p in cluster.peers}
    stale_convictions: "dict[str, list[str]]" = {}
    for peer in cluster.live_peers():
        flagged = set(peer.monitor.watchdog(now=cluster.now)) & honest
        for hexid in sorted(flagged):
            stale_convictions.setdefault(hexid, []).append(peer.name)
    ok = not (stuck or late or stale_convictions)
    return {
        "ok": ok,
        "sessions": len(cluster.sessions),
        "decided_sessions": len(cluster.sessions) - undecidable,
        "undecidable_sessions": undecidable,
        "stuck_sessions": stuck,
        "decide_bound_ticks": decide_bound,
        "max_decide_ticks": max_ticks,
        "late_decisions": late,
        "stale_convictions": {
            k: sorted(v) for k, v in sorted(stale_convictions.items())
        },
    }


def convergence_verdict(cluster: SimCluster, max_rounds: int = 8) -> dict:
    report = cluster.converge(max_rounds=max_rounds)
    return {
        "ok": report["ok"],
        "repair_rounds": report["rounds"],
        "fingerprints": {
            k: report["fingerprints"][k] for k in sorted(report["fingerprints"])
        },
    }
