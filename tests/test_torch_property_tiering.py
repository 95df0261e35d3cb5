"""Hypothesis search over the tiered-vs-untiered identity op space of the
port: the twin of ``tests/test_property_tiering.py``.

The script runner (and the seeded trials that always run) live in
``tests/test_torch_tiering.py``; here hypothesis hunts the op space on
``TorchConsensusEngine(device="cpu")``, shrinking to a minimal
counterexample. Tolerance: exact.
"""

import pytest

pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st

from test_torch_tiering import run_identity_script

_op = st.one_of(
    st.tuples(st.just("create"), st.integers(1, 4)),
    st.tuples(
        st.just("vote"),
        st.integers(0, 7),  # session pick (mod live)
        st.integers(0, 3),  # signer
        st.booleans(),
    ),
    st.tuples(st.just("timeout"), st.integers(0, 7)),
    st.tuples(st.just("sweep"), st.integers(1, 30)),
    st.tuples(st.just("demote"), st.integers(0, 7)),
    st.tuples(st.just("demote_all")),
)


@settings(max_examples=20, deadline=None)
@given(script=st.lists(_op, min_size=3, max_size=20))
def test_tiered_untiered_decision_identity(script):
    run_identity_script(script)
