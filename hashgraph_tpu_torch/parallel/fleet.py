"""The fleet's shard-availability errors.

Copies of the JAX package's ``parallel/fleet.py`` errors, which the
bridge server maps to ``STATUS_SHARD_MIGRATING``. The fleet itself
(placement, shards, the tally) is not ported yet.
"""

from __future__ import annotations

__all__ = ["ShardRecoveringError", "ShardMigratingError"]


class ShardRecoveringError(RuntimeError):
    """The scope's owning shard is mid-recovery (WAL replay in flight)."""

    def __init__(self, shard_id: str):
        super().__init__(
            f"shard {shard_id!r} is recovering; its scopes are briefly "
            "unavailable (other shards keep serving)"
        )
        self.shard_id = shard_id


class ShardMigratingError(ShardRecoveringError):
    """The scope's owning shard is mid-migration to another host.

    A subclass of :class:`ShardRecoveringError` so existing
    unavailability handling keeps working; ``retry_after`` carries the
    migration orchestrator's hint of when routes resume on the new
    owner — callers back off and retry instead of dropping votes (the
    federation driver buffers them as the migration tail)."""

    def __init__(self, shard_id: str, retry_after: float = 1.0):
        RuntimeError.__init__(
            self,
            f"shard {shard_id!r} is migrating; its scopes resume on the "
            f"new owner in ~{retry_after:.1f}s (retry with backoff)",
        )
        self.shard_id = shard_id
        self.retry_after = retry_after
