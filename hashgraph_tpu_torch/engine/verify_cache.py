"""Memoized vote-admission verdicts: verify each unique vote ONCE.

Port of the JAX package's ``engine/verify_cache.py``: the class, its keys,
its LRU policy and its counters (on this package's process-wide metrics
registry, :mod:`hashgraph_tpu_torch.obs`) are that package's. The engine's
scheme tag hashes the scheme's module path, so a cache never serves a
verdict of the JAX package's schemes to the port's.

The reference protocol gossips *growing vote chains*: a chain of length L
delivered one extension at a time re-presents every earlier vote L times,
and gossip redelivery re-presents whole chains verbatim. Signature
verification is the costliest step of validated admission, so
re-verifying a vote that was already admitted — or already rejected — is
the largest avoidable cost under redelivery: O(L²) signature checks for an incrementally grown
chain. This module memoizes the *signature verdict* per unique
(vote content, signature) pair so that cost collapses to O(L).

What is cached — and why it is safe:

- The key is a SHA-256 over the length-framed triple (scheme tag,
  ``vote.signing_payload()``, signature) — see :meth:`VerifiedVoteCache.key`.
  ``signing_payload()`` is the exact byte string handed to
  ``scheme.verify``, so the key uniquely determines the (signer, message,
  signature) question whose answer it stores; a forged signature lives
  under its own key and can never poison (or be served) the verdict of
  the honestly signed vote. ``compute_vote_hash`` deliberately is NOT
  the key: it concatenates the variable-length
  ``vote_owner``/``parent_hash``/``received_hash`` fields without length
  framing, so two votes with *different* signing payloads (e.g. bytes
  shifted between ``parent_hash`` and ``received_hash``) can share a
  vote hash — keying on it would let a crafted never-signed vote be
  served the honest vote's cached ``True``.
- The value is exactly what ``ConsensusSignatureScheme.verify_batch``
  yields per item: ``True``, ``False``, or the ``ConsensusSchemeError``
  that scalar ``verify`` would have raised. Negative verdicts are cached
  too — a peer replaying a known-bad vote costs a dict probe, not an
  ECDSA recover.
- Context-dependent checks (replay guard, expiry, duplicate detection,
  chain linkage) are NOT cached: they depend on the receiving session and
  on ``now``, and they are cheap. The cache changes where signature
  verification happens, never its verdict — an engine with the cache
  disabled (``verify_cache=None``) produces byte-for-byte identical
  statuses.

The cache is bounded (entry count and approximate byte caps) with LRU
eviction, and thread-safe so one instance can be shared by several
engines in one process — a vote gossiped to N co-hosted peers is then
verified once, not N times.
Hit/miss/negative-hit/evict counters land on the process-wide metrics
registry (:mod:`hashgraph_tpu_torch.obs`) and appear in ``/metrics``.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

from ..obs import (
    VERIFY_CACHE_EVICTIONS_TOTAL,
    VERIFY_CACHE_HITS_TOTAL,
    VERIFY_CACHE_MISSES_TOTAL,
    VERIFY_CACHE_NEGATIVE_HITS_TOTAL,
)
from ..obs import registry as default_registry

__all__ = ["VerifiedVoteCache", "MISS"]

# Distinct sentinel for "no cached verdict": False and scheme errors are
# real (negative) verdicts, so None/False cannot signal a miss.
MISS = object()

# Flat per-entry overhead charged against max_bytes on top of the key
# length: OrderedDict node + key bytes object headers + value slot. An
# estimate (CPython internals vary by version) — the byte cap is a
# sizing guardrail, not an accounting ledger.
_ENTRY_OVERHEAD = 160


class VerifiedVoteCache:
    """Bounded, thread-safe LRU map: vote admission key -> signature verdict.

    ``max_entries`` bounds the entry count; ``max_bytes`` (optional)
    additionally bounds the approximate resident size (keys + flat
    per-entry overhead). Either cap triggers least-recently-*used*
    eviction — a hit refreshes recency, so hot chain prefixes survive
    churny gossip tails.
    """

    def __init__(
        self, max_entries: int = 1 << 16, max_bytes: int | None = None
    ):
        if max_entries <= 0:
            raise ValueError("max_entries must be positive")
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError("max_bytes must be positive when set")
        self.max_entries = int(max_entries)
        self.max_bytes = max_bytes
        self._entries: OrderedDict[bytes, object] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        reg = default_registry
        self._m_hits = reg.counter(VERIFY_CACHE_HITS_TOTAL)
        self._m_misses = reg.counter(VERIFY_CACHE_MISSES_TOTAL)
        self._m_negative_hits = reg.counter(VERIFY_CACHE_NEGATIVE_HITS_TOTAL)
        self._m_evictions = reg.counter(VERIFY_CACHE_EVICTIONS_TOTAL)

    @staticmethod
    def key(
        signing_payload: bytes, signature: bytes, scheme_tag: bytes = b""
    ) -> bytes:
        """Admission key for one vote: SHA-256 over the length-framed
        (scheme_tag, signing_payload) pair plus the signature.
        ``signing_payload`` MUST be ``vote.signing_payload()`` — the
        exact bytes the scheme verifies — so the key unambiguously
        determines the verification question (see module docstring for
        why ``compute_vote_hash`` is NOT a safe substitute). Each
        variable-length component is length-prefixed; the signature is
        terminal so it needs no frame. ``scheme_tag`` namespaces
        verdicts by signature-scheme identity (the engine derives it
        from its scheme type): one cache instance shared by engines with
        DIFFERENT schemes must never serve scheme A's verdict for scheme
        B's verification of the same bytes. The digest form also keeps
        every entry's key at a flat 32 bytes."""
        h = hashlib.sha256()
        h.update(len(scheme_tag).to_bytes(4, "little"))
        h.update(scheme_tag)
        h.update(len(signing_payload).to_bytes(4, "little"))
        h.update(signing_payload)
        h.update(signature)
        return h.digest()

    def get(self, key: bytes):
        """Cached verdict for ``key``, or :data:`MISS`. A hit refreshes
        LRU recency; negative verdicts (False / scheme error) count
        separately so poisoning attempts are visible in metrics."""
        with self._lock:
            verdict = self._entries.get(key, MISS)
            if verdict is MISS:
                self._m_misses.inc()
                return MISS
            self._entries.move_to_end(key)
        self._m_hits.inc()
        if verdict is not True:
            self._m_negative_hits.inc()
        return verdict

    def get_many(self, keys: "list[bytes]") -> list:
        """Batched :meth:`get`: one lock acquisition and one counter
        update for the whole batch — the engine's per-batch prepass calls
        this so a cache consult costs dict probes, not per-vote lock and
        metrics traffic. Returns one verdict-or-:data:`MISS` per key."""
        hits = misses = negatives = 0
        out = []
        entries = self._entries
        with self._lock:
            for key in keys:
                verdict = entries.get(key, MISS)
                if verdict is MISS:
                    misses += 1
                else:
                    entries.move_to_end(key)
                    hits += 1
                    negatives += verdict is not True
                out.append(verdict)
        if hits:
            self._m_hits.inc(hits)
        if misses:
            self._m_misses.inc(misses)
        if negatives:
            self._m_negative_hits.inc(negatives)
        return out

    def put(self, key: bytes, verdict) -> None:
        """Store one verdict, evicting LRU entries past either cap."""
        self.put_many([(key, verdict)])

    def put_many(self, items: "list[tuple[bytes, object]]") -> None:
        """Batched :meth:`put` (one lock acquisition, one eviction sweep)."""
        evicted = 0
        with self._lock:
            for key, verdict in items:
                old = self._entries.pop(key, MISS)
                if old is not MISS:
                    self._bytes -= len(key) + _ENTRY_OVERHEAD
                self._entries[key] = verdict
                self._bytes += len(key) + _ENTRY_OVERHEAD
            while len(self._entries) > self.max_entries or (
                self.max_bytes is not None
                and self._bytes > self.max_bytes
                and len(self._entries) > 1
            ):
                victim, _ = self._entries.popitem(last=False)
                self._bytes -= len(victim) + _ENTRY_OVERHEAD
                evicted += 1
        if evicted:
            self._m_evictions.inc(evicted)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes_used(self) -> int:
        """Approximate resident bytes (keys + flat per-entry overhead)."""
        with self._lock:
            return self._bytes

    def stats(self) -> dict:
        """Point-in-time sizing readout (the hit/miss/evict *rates* live
        on the process-wide metrics registry, not per instance)."""
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes_used": self._bytes,
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
            }
