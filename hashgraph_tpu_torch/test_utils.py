"""Copy of ``hashgraph_tpu/test_utils.py`` for the PyTorch port, which imports
nothing of the JAX package.

Test helpers exported by the library itself
(reference: src/test_utils.rs:5-10).

The reference exposes a wall-clock helper for doctests and downstream test
suites; everything else in this framework takes caller-supplied ``now``
values, so tests can (and should) drive time arithmetically instead.
"""

from __future__ import annotations

import time

__all__ = ["now_ts"]


def now_ts() -> int:
    """Current Unix timestamp in seconds (reference: src/test_utils.rs:5-10)."""
    return int(time.time())
