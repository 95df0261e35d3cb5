"""Segmented log files: naming, listing, scanning, tail repair.

A WAL directory holds segments named ``wal-<base_lsn>.seg`` where
``base_lsn`` (zero-padded, 20 digits so lexicographic order == numeric
order) is the LSN of the first record the segment holds (for an empty
just-rotated segment: the next LSN to be written). Segments are strictly
append-only; once the writer rotates past one it is *sealed* and never
modified again. That gives compaction a trivial correctness rule — a sealed
segment's records all have ``lsn < next_segment.base_lsn`` — and confines
torn-tail repair to the single active (last) segment.
"""

from __future__ import annotations

import os

from . import format as F

SEGMENT_PREFIX = "wal-"
SEGMENT_SUFFIX = ".seg"
_LSN_DIGITS = 20

DEFAULT_SEGMENT_BYTES = 64 * 1024 * 1024


def segment_name(base_lsn: int) -> str:
    return f"{SEGMENT_PREFIX}{base_lsn:0{_LSN_DIGITS}d}{SEGMENT_SUFFIX}"


def base_lsn_of(name: str) -> int | None:
    """Parse a segment filename; None for non-segment directory entries."""
    if not (name.startswith(SEGMENT_PREFIX) and name.endswith(SEGMENT_SUFFIX)):
        return None
    digits = name[len(SEGMENT_PREFIX) : -len(SEGMENT_SUFFIX)]
    if not digits.isdigit():
        return None
    return int(digits)


def list_segments(directory: str) -> list[tuple[int, str]]:
    """(base_lsn, absolute path) for every segment, ascending by base_lsn.
    Unrelated files in the directory are ignored."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    out = []
    for name in names:
        base = base_lsn_of(name)
        if base is not None:
            out.append((base, os.path.join(directory, name)))
    out.sort()
    return out


def scan_segment(path: str) -> tuple[list[tuple[int, int, bytes]], int, int]:
    """Parse one segment file.

    Returns ``(records, valid_end, file_size)`` — ``valid_end < file_size``
    marks a torn tail (see :func:`.format.scan_buffer`).
    Segments are bounded by the writer's rotation threshold, so reading one
    whole file at a time keeps recovery memory proportional to a single
    segment, not the log.
    """
    with open(path, "rb") as fh:
        data = fh.read()
    records, valid_end = F.scan_buffer(data)
    return records, valid_end, len(data)


def truncate_segment(path: str, valid_end: int) -> int:
    """Drop a torn tail in place; returns the number of bytes removed."""
    size = os.path.getsize(path)
    if valid_end >= size:
        return 0
    with open(path, "r+b") as fh:
        fh.truncate(valid_end)
        fh.flush()
        os.fsync(fh.fileno())
    return size - valid_end
