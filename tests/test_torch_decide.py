"""Parity: the port's decision rule (hashgraph_tpu_torch.ops.decide) against
the JAX package's (hashgraph_tpu.ops.decide) and the scalar oracle.

Inputs are made with numpy from a seed and handed to both; tolerance:
exact equality (integer and boolean outputs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hashgraph_tpu import protocol as ref_protocol
from hashgraph_tpu.ops import decide as ref
from hashgraph_tpu_torch import protocol as port_protocol
from hashgraph_tpu_torch.ops import decide as port


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def random_tallies(seed, size=512, v_cap=40):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, v_cap + 1, size).astype(np.int32)
    tot = np.minimum(rng.integers(0, v_cap + 1, size), n).astype(np.int32)
    yes = (rng.random(size) * (tot + 1)).astype(np.int32)
    thr = rng.choice([2 / 3, 0.5, 0.9, 1.0, 0.34], size)
    req = ref.required_votes_np(n, thr).astype(np.int32)
    live = rng.random(size) < 0.5
    timeout = rng.random(size) < 0.5
    state = rng.integers(0, 5, size).astype(np.int32)
    return dict(n=n, tot=tot, yes=yes, thr=thr, req=req, live=live,
                timeout=timeout, state=state)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", range(4))
def test_required_votes_identical(seed):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 100_000, 2000)
    thr = rng.choice([2 / 3, 0.5, 0.9, 1.0, 0.1, 0.75, 1 / 3], 2000)
    np.testing.assert_array_equal(
        port.required_votes_np(n, thr), ref.required_votes_np(n, thr)
    )


@pytest.mark.parametrize("is_timeout", [False, True, "per-slot"])
@pytest.mark.parametrize("seed", range(3))
def test_decide_kernel_matches_reference(seed, is_timeout):
    c = random_tallies(seed)
    flag_np = c["timeout"] if is_timeout == "per-slot" else is_timeout
    flag_port = t(c["timeout"]) if is_timeout == "per-slot" else is_timeout
    d_ref, r_ref = ref.decide_kernel(
        jnp.asarray(c["yes"]), jnp.asarray(c["tot"]), jnp.asarray(c["n"]),
        jnp.asarray(c["req"]), jnp.asarray(c["live"]), jnp.asarray(flag_np),
    )
    d_port, r_port = port.decide_kernel(
        t(c["yes"]), t(c["tot"]), t(c["n"]), t(c["req"]), t(c["live"]), flag_port
    )
    d_ref = np.asarray(d_ref)
    np.testing.assert_array_equal(d_port.numpy(), d_ref)
    # result is meaningful only where decided
    np.testing.assert_array_equal(r_port.numpy()[d_ref], np.asarray(r_ref)[d_ref])


@pytest.mark.parametrize("seed", range(2))
def test_decide_kernel_matches_scalar_oracle(seed):
    """Against protocol.calculate_consensus_result of both packages."""
    c = random_tallies(seed, size=200)
    for is_timeout in (False, True):
        decided, result = port.decide_kernel(
            t(c["yes"]), t(c["tot"]), t(c["n"]), t(c["req"]), t(c["live"]),
            is_timeout,
        )
        for i in range(len(c["n"])):
            votes = [
                ref_protocol.Vote(vote_owner=bytes([k + 1]), vote=k < c["yes"][i])
                for k in range(int(c["tot"][i]))
            ]
            args = (int(c["n"][i]), float(c["thr"][i]), bool(c["live"][i]), is_timeout)
            expected = ref_protocol.calculate_consensus_result(votes, *args)
            port_votes = [
                port_protocol.Vote(vote_owner=v.vote_owner, vote=v.vote) for v in votes
            ]
            assert port_protocol.calculate_consensus_result(port_votes, *args) == expected
            got = bool(result[i]) if decided[i] else None
            assert got == expected, (i, args)


@pytest.mark.parametrize("seed", range(3))
def test_decide_and_timeout_update_match_reference(seed):
    c = random_tallies(seed)
    args_ref = [jnp.asarray(c[k]) for k in ("state", "yes", "tot", "n", "req", "live")]
    args_port = [t(c[k]) for k in ("state", "yes", "tot", "n", "req", "live")]
    np.testing.assert_array_equal(
        port.decide_update(*args_port).numpy(),
        np.asarray(ref.decide_update(*args_ref)),
    )
    np.testing.assert_array_equal(
        port.timeout_update(*args_port, t(c["timeout"])).numpy(),
        np.asarray(ref.timeout_update(*args_ref, jnp.asarray(c["timeout"]))),
    )
    has_p, res_p = port.state_result(t(c["state"]))
    has_r, res_r = ref.state_result(jnp.asarray(c["state"]))
    np.testing.assert_array_equal(has_p.numpy(), np.asarray(has_r))
    np.testing.assert_array_equal(res_p.numpy(), np.asarray(res_r))


@pytest.mark.parametrize("seed", range(3))
def test_timeout_body_matches_reference_with_pad_ids(seed):
    """Ids == P are pad sentinels: dropped on write, clipped on read."""
    c = random_tallies(seed, size=64)
    p = len(c["n"])
    rng = np.random.default_rng(100 + seed)
    ids = rng.choice(p, 20, replace=False).astype(np.int32)
    ids = np.concatenate([ids, np.full(5, p, np.int32)])
    rng.shuffle(ids)
    keys = ("state", "yes", "tot", "n", "req", "live")
    ref_state, ref_rows = ref.timeout_body(
        *[jnp.asarray(c[k]) for k in keys], jnp.asarray(ids)
    )
    port_state, port_rows = port.timeout_body(*[t(c[k].copy()) for k in keys], t(ids))
    np.testing.assert_array_equal(port_state.numpy(), np.asarray(ref_state))
    np.testing.assert_array_equal(port_rows.numpy(), np.asarray(ref_rows))


def test_state_codes_identical():
    for name in ("STATE_FREE", "STATE_ACTIVE", "STATE_FAILED",
                 "STATE_REACHED_NO", "STATE_REACHED_YES"):
        assert getattr(port, name) == getattr(ref, name)
