"""Bytes the arrival-ordered ingest scan needs for one call's votes, worked
out from the call's own inputs: what any scan must read and write, not
what one implementation moves.

Per session that the call touches, its scalars are read once (state, yes,
total, expected voters, required votes, round cap as 4-byte integers; the
mode and the liveness rule a byte each) and the state, yes and total
written once. Per vote that reaches the scan, the voter's mask byte is
read; per vote applied, a mask byte and a value byte are written.
"""

SESSION_READ_BYTES = 6 * 4 + 2
SESSION_WRITE_BYTES = 3 * 4


def bytes_needed(sessions: int, votes: int, applied: int) -> int:
    return (sessions * (SESSION_READ_BYTES + SESSION_WRITE_BYTES)
            + votes + 2 * applied)
