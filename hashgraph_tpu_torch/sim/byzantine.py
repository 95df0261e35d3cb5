"""Byzantine actors: genuinely-keyed adversaries on the sim fabric.

Each injector owns a REAL signing key (seed-derived), so everything it
emits is *validly signed conflicting bytes* flowing through the live
validation paths — exactly what the accountability layer must convict
with self-authenticating evidence (Polygraph / BFT-forensics framing,
PAPERS.md), never stub markers a test could cheat on:

- :meth:`ByzantineActor.equivocate` — two validly-signed conflicting
  votes for one (scope, proposal), both fanned to every peer: the
  engines' duplicate-shaped admission statuses trip the equivocation
  probe and retain the signed pair (``verified=True`` evidence, grade
  ``faulty``);
- :meth:`ByzantineActor.fork_deliver` — a chain that diverges before
  the validated watermark, pushed over ``OP_DELIVER_PROPOSALS``:
  settles crypto-free as a redelivery while the fork evidence names the
  divergent vote's signer (grade ``suspect``);
- :meth:`ByzantineActor.expired_spam` — stale self-signed proposals
  and votes: zero crypto bought (the expiry fail-fasts), expired-gossip
  attribution to the spammer's identity;
- :meth:`ByzantineActor.signature_burst` — well-formed votes whose
  signatures a LINK MUTATOR corrupts in flight
  (:func:`corrupt_vote_batch_signatures` rides the
  ``LinkFaults.mutate`` hook — injector-driven frame mutation at the
  bridge codec layer): every frame claims the actor's own identity, so
  the invalid-signature burst lands on its scorecard and trips the
  stock ``invalid-signature-burst`` alert.
"""

from __future__ import annotations

from ..bridge import protocol as P
from ..protocol import build_vote, generate_id
from ..wire import Proposal, Vote
from .cluster import SimCluster, SimSession
from .core import derived_rng
from .transport import SimTransport


def corrupt_vote_batch_signatures(opcode: int, payload: bytes):
    """Link mutator: rewrite every vote in an ``OP_VOTE_BATCH`` frame
    with a flipped signature (decode through the public codecs, corrupt
    the signature field, re-encode). Non-vote frames pass untouched.
    The vote hashes stay valid, so the engines reject on exactly
    INVALID_VOTE_SIGNATURE and attribute the claimed signer."""
    if opcode != P.OP_VOTE_BATCH:
        return None
    now, groups = P.decode_vote_batch(P.Cursor(payload))
    mutated = []
    for peer_id, scope, votes in groups:
        out = []
        for blob in votes:
            vote = Vote.decode(blob)
            vote.signature = bytes(b ^ 0xFF for b in vote.signature)
            out.append(vote.encode())
        mutated.append((peer_id, scope, out))
    return P.encode_vote_batch(now, mutated)


class ByzantineActor:
    """A keyed adversary with its own transport (a pure sender: it
    serves nothing, so honest peers only ever see its signed bytes)."""

    def __init__(self, cluster: SimCluster, name: str = "byz"):
        self.cluster = cluster
        self.name = name
        key = derived_rng(cluster.seed, f"byz-key:{name}").randbytes(32)
        self.signer = cluster.signer_factory(key)
        self.identity = bytes(self.signer.identity())
        self.transport = SimTransport(cluster.network, name)
        for peer in cluster.live_peers():
            self.transport.connect(peer.name, peer.name, 0)

    # ── delivery plumbing ──────────────────────────────────────────────

    def send_votes(
        self, scope: str, vote_bytes_list: "list[bytes]", targets=None
    ) -> None:
        """One coalesced ``OP_VOTE_BATCH`` frame per target peer."""
        cluster = self.cluster
        for peer in targets if targets is not None else cluster.live_peers():
            self.transport.try_request(
                peer.name,
                P.OP_VOTE_BATCH,
                P.encode_vote_batch(
                    cluster.now, [(peer.peer_id, scope, vote_bytes_list)]
                ),
            )
        cluster.run_network()

    def deliver(self, scope: str, proposal: Proposal, targets=None) -> None:
        cluster = self.cluster
        wire = proposal.encode()
        for peer in targets if targets is not None else cluster.live_peers():
            self.transport.try_request(
                peer.name,
                P.OP_DELIVER_PROPOSALS,
                P.encode_deliver_proposals(
                    peer.peer_id, [(scope, wire)], cluster.now
                ),
            )
        cluster.run_network()

    # ── injectors ──────────────────────────────────────────────────────

    def join(self, session: SimSession):
        """Cast ONE legitimate vote on the canonical chain (an attacker's
        first vote IS valid traffic) and fan it to every peer. The vote
        joins the canonical chain; later injections conflict with it."""
        cluster = self.cluster
        vote = build_vote(session.proposal, True, self.signer, cluster.now)
        session.proposal.votes.append(vote)
        self.send_votes(session.scope, [vote.encode()])
        return vote

    def equivocate(self, session: SimSession) -> "tuple[bytes, bytes]":
        """Sign two conflicting votes for ``session``: a legitimate chain
        extension (:meth:`join`), then a conflicting one (same signer,
        opposite value, new chain position) fanned to every peer — each
        engine rejects it duplicate-shaped and retains the verified
        evidence pair."""
        first = self.join(session)
        second = build_vote(
            session.proposal, False, self.signer, self.cluster.now
        )
        self.send_votes(session.scope, [second.encode()])
        return first.encode(), second.encode()

    def fork_deliver(self, session: SimSession) -> Proposal:
        """Push a chain in which the actor's OWN accepted vote is
        replaced by a different one it signed — the double-sign shape the
        fork detector convicts on (a divergence at an honest peer's
        position is not attributable and is deliberately NOT evidence) —
        and that claims to extend past the receivers' heads, forcing the
        positional prefix walk instead of the benign equal-length tail
        compare. Requires a prior :meth:`join`; the watermark still
        settles the delivery crypto-free."""
        cluster = self.cluster
        position = next(
            i
            for i, vote in enumerate(session.proposal.votes)
            if vote.vote_owner == self.identity
        )
        fork = session.proposal.clone()
        fork.votes = [v.clone() for v in session.proposal.votes]
        prefix = fork.clone()
        prefix.votes = fork.votes[:position]
        fork.votes[position] = build_vote(
            prefix, False, self.signer, cluster.now
        )
        fork.votes.append(build_vote(fork, True, self.signer, cluster.now))
        self.deliver(session.scope, fork)
        return fork

    def expired_spam(self, scope: str, count: int = 4) -> int:
        """Stale self-signed sessions thrown at every peer: each is
        expired on arrival, so the engines reject without buying any
        crypto and score ``expired_gossip`` against this actor (the
        chain's most recent — here only — signer)."""
        cluster = self.cluster
        now = cluster.now
        for i in range(count):
            stale = Proposal(
                name=f"stale-{i}",
                payload=b"expired",
                proposal_id=generate_id(),
                proposal_owner=self.identity,
                expected_voters_count=3,
                timestamp=max(0, now - 1000),
                expiration_timestamp=max(1, now - 10),
                liveness_criteria_yes=True,
            )
            stale.votes.append(build_vote(stale, True, self.signer, stale.timestamp))
            wire = stale.encode()
            for peer in cluster.live_peers():
                self.transport.try_request(
                    peer.name,
                    P.OP_PROCESS_PROPOSAL,
                    P.u32(peer.peer_id)
                    + P.string(scope)
                    + P.u64(now)
                    + P.blob(wire),
                )
            cluster.run_network()
        return count

    def signature_burst(self, session: SimSession, count: int = 5) -> int:
        """``count`` well-formed votes for a live session whose
        signatures the link mutator corrupts in flight (install
        :func:`corrupt_vote_batch_signatures` on this actor's links
        first): each rejects as INVALID_VOTE_SIGNATURE on the claimed
        signer — this actor — and past 3 the stock
        ``invalid-signature-burst`` alert fires."""
        cluster = self.cluster
        votes = []
        base = session.proposal.clone()
        base.votes = [v.clone() for v in session.proposal.votes]
        for i in range(count):
            vote = build_vote(base, bool(i % 2), self.signer, cluster.now + i)
            votes.append(vote.encode())
            base.votes.append(vote)
        self.send_votes(session.scope, votes)
        return count

    def arm_frame_mutation(self) -> None:
        """Install the signature-corrupting mutator on every link leaving
        this actor (the injector-driven frame mutation seam)."""
        for peer in self.cluster.live_peers():
            self.cluster.network.set_link(
                self.name, peer.name, mutate=corrupt_vote_batch_signatures
            )
