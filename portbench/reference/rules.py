"""Upstream's session rules, restated plainly.

vacp2p/hashgraph-like-consensus v0.6.0: the decision rule
(``src/utils.rs:227-313``), the round caps (``src/session.rs:120-128,
306-366``) and the order of checks when a vote is added
(``src/session.rs:225-249``). The default threshold of 2/3 is the exact
integer ``ceil(2n/3)``; ``quorum_floor`` is the control's broken
guarantee (``floor(2n/3)``), never used by the reference itself.
"""

from __future__ import annotations

import math

GOSSIPSUB = "gossipsub"
P2P = "p2p"
GOSSIPSUB_MAX_ROUNDS = 2

# Outcomes of the decision rule, as small ints so that tables stay cheap.
UNDECIDED, NO, YES = 0, 1, 2


def threshold_value(n: int, threshold: float, quorum_floor: bool = False) -> int:
    """``ceil(n * t)``; exact ``ceil(2n/3)`` at the default 2/3."""
    if abs(threshold - 2.0 / 3.0) < 2.220446049250313e-16:
        return (2 * n) // 3 if quorum_floor else (2 * n + 2) // 3
    return max(int(math.ceil(n * threshold)), 0)


def decide(yes: int, total: int, n: int, threshold: float, liveness_yes: bool,
           timeout: bool = False, quorum_floor: bool = False) -> int:
    """The decision rule over counts: YES, NO or UNDECIDED."""
    no = max(total - yes, 0)
    silent = max(n - total, 0)
    if n <= 2:
        if total < n:
            return UNDECIDED
        return YES if yes == n else NO
    required = threshold_value(n, threshold, quorum_floor)
    if (n if timeout else total) < required:
        return UNDECIDED
    yes_weight = yes + (silent if liveness_yes else 0)
    no_weight = no + (0 if liveness_yes else silent)
    if yes_weight >= required and yes_weight > no_weight:
        return YES
    if no_weight >= required and no_weight > yes_weight:
        return NO
    if total == n and yes_weight == no_weight:
        return YES if liveness_yes else NO
    return UNDECIDED


def round_cap(mode: str, n: int, threshold: float, quorum_floor: bool = False) -> int:
    """Most votes a session accepts before a further one fails it: P2P's
    dynamic cap is ``ceil(2n/3)`` (a round a vote); Gossipsub keeps every
    vote in round 2 of 2, so only the expected-voter bound applies."""
    if mode == P2P:
        return threshold_value(n, threshold, quorum_floor)
    return n


def decision_table(n: int, threshold: float, liveness_yes: bool,
                   quorum_floor: bool = False) -> "list[list[int]]":
    """``table[yes][total]``: the rule for every count of one session size."""
    return [
        [decide(yes, total, n, threshold, liveness_yes, False, quorum_floor)
         if yes <= total else UNDECIDED for total in range(n + 1)]
        for yes in range(n + 1)
    ]
