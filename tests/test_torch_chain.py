"""Parity: the port's chain check against the JAX package's ``ops/chain.py``.

Chains are built from seeded stub signers and seeded vote ids with the
port's ``build_vote``, then mutated as ``tests/test_ops_chain.py`` mutates
them. The same vote objects go through both packages in this process: the
port's ``pack_chain`` must give the JAX package's arrays, the port's
``chain_kernel``/``chain_kernel_batch`` (plain PyTorch on the CPU) the JAX
kernel's statuses, and ``first_chain_error`` the code of the port's scalar
``validate_vote_chain`` oracle (tolerance: exact, everything is int32).
The JAX packs reach the port through ``convert.chain_pack_from_numpy``.
"""

import random

import numpy as np
import pytest
import torch

from hashgraph_tpu.ops import chain as ref_chain
from hashgraph_tpu_torch import CreateProposalRequest, StubConsensusSigner, build_vote
from hashgraph_tpu_torch import protocol
from hashgraph_tpu_torch.convert import chain_pack_from_numpy, chain_pack_to_numpy
from hashgraph_tpu_torch.errors import ConsensusError, StatusCode
from hashgraph_tpu_torch.ops import chain
from hashgraph_tpu_torch.protocol import compute_vote_hash, validate_vote_chain

NOW = 1_700_000_000
FIELDS = list(chain.CHAIN_FIELDS)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def build_chain(n_votes=6, n_signers=3, seed=0, now=NOW):
    """A structurally valid chain via build_vote's linking rules, from
    seeded signers and seeded vote ids."""
    rng = np.random.default_rng(seed)
    ids = random.Random(seed)
    protocol.set_id_entropy(lambda: ids.getrandbits(128))
    try:
        signers = [StubConsensusSigner(bytes([seed % 251, k, 7])) for k in range(n_signers)]
        proposal = CreateProposalRequest("chain", b"", b"o", 64, 1000, True).into_proposal(
            now, pid=1000 + seed)
        for i in range(n_votes):
            signer = signers[int(rng.integers(n_signers))]
            proposal.votes.append(build_vote(proposal, bool(rng.random() < 0.5), signer, now + i))
    finally:
        protocol.set_id_entropy(None)
    return proposal.votes


def oracle_code(votes) -> int:
    try:
        validate_vote_chain(votes)
        return int(StatusCode.OK)
    except ConsensusError as exc:
        return int(exc.code)


def relink(votes, i):
    """Re-hash vote i after a mutation and point vote i+1's received link
    at it, so only the mutated rule can fail."""
    votes[i].vote_hash = compute_vote_hash(votes[i])
    if i + 1 < len(votes) and votes[i + 1].received_hash:
        votes[i + 1].received_hash = votes[i].vote_hash


def check(votes, pad_to=None):
    """Pack, run both packages' kernels, and compare with the oracle.
    Returns the port's per-vote statuses."""
    port_pack = chain.pack_chain(votes, pad_to=pad_to)
    ref_pack = ref_chain.pack_chain(votes, pad_to=pad_to)
    for name in FIELDS:
        assert port_pack[name].dtype == ref_pack[name].dtype, name
        np.testing.assert_array_equal(port_pack[name], ref_pack[name], err_msg=name)
    ref_statuses = np.asarray(ref_chain.chain_kernel(*(ref_pack[k] for k in FIELDS)))
    tensors = chain_pack_from_numpy(ref_pack, device="cpu")
    statuses = chain.chain_kernel(*(tensors[k] for k in FIELDS))
    assert statuses.dtype == torch.int32
    np.testing.assert_array_equal(statuses.numpy(), ref_statuses)
    assert chain.first_chain_error(statuses.numpy()) == oracle_code(votes)
    return statuses.numpy()


def owner_pairs(votes):
    by_owner: dict[bytes, list[int]] = {}
    for idx, v in enumerate(votes):
        by_owner.setdefault(v.vote_owner, []).append(idx)
    return by_owner


@pytest.mark.parametrize("seed", range(5))
def test_valid_chains(seed):
    votes = build_chain(n_votes=8, n_signers=3, seed=seed)
    assert oracle_code(votes) == int(StatusCode.OK)
    assert (check(votes) == int(StatusCode.OK)).all()


@pytest.mark.parametrize("pad_to", [5, 6, 16])
def test_pad_rows_are_inert(pad_to):
    votes = build_chain(n_votes=5)
    statuses = check(votes, pad_to=pad_to)
    assert (statuses[5:] == int(StatusCode.OK)).all()
    votes[3].received_hash = b"\x13" * 32
    check(votes, pad_to=pad_to)


def test_pad_row_never_matches_as_a_parent():
    """A pad row packs as all zeros, as an empty hash does: only ``valid``
    keeps the empty parent hashes of real votes from matching it."""
    votes = build_chain(n_votes=3)
    assert votes[0].parent_hash == b""
    tensors = chain_pack_from_numpy(chain.pack_chain(votes, pad_to=8), device="cpu")
    packed = {k: t[None] for k, t in tensors.items()}
    eq = chain.parent_matches(packed["parent_hash"], packed["vote_hash"], packed["valid"])
    assert not eq[0, :, 3:].any()
    assert (packed["parent_hash"][0, 0] == packed["vote_hash"][0, 5]).all()
    check(votes, pad_to=8)


def test_tampered_received_hash():
    votes = build_chain(n_votes=5)
    votes[3].received_hash = b"\x13" * 32
    assert oracle_code(votes) == int(StatusCode.RECEIVED_HASH_MISMATCH)
    check(votes)


def test_reordered_votes():
    votes = build_chain(n_votes=6)
    votes[2], votes[4] = votes[4], votes[2]
    check(votes)


def test_received_ts_regression():
    votes = build_chain(n_votes=4)
    votes[2].timestamp = votes[3].timestamp + 100
    relink(votes, 2)
    assert oracle_code(votes) == int(StatusCode.RECEIVED_HASH_MISMATCH)
    check(votes)


def test_parent_wrong_owner():
    votes = build_chain(n_votes=6, n_signers=2, seed=3)
    linked = [i for i, v in enumerate(votes) if v.parent_hash]
    assert linked, "the seeded chain has a parent link"
    i = linked[0]
    other = next(j for j, v in enumerate(votes) if v.vote_owner != votes[i].vote_owner)
    votes[i].parent_hash = votes[other].vote_hash
    assert oracle_code(votes) == int(StatusCode.PARENT_HASH_MISMATCH)
    check(votes)


def test_parent_points_forward():
    votes = build_chain(n_votes=6, n_signers=2, seed=1)
    earlier, later = next(ix for ix in owner_pairs(votes).values() if len(ix) >= 2)[:2]
    votes[earlier].parent_hash = votes[later].vote_hash
    assert oracle_code(votes) == int(StatusCode.PARENT_HASH_MISMATCH)
    check(votes)


def test_unknown_parent_hash():
    votes = build_chain(n_votes=4)
    votes[2].parent_hash = b"\x77" * 32
    assert oracle_code(votes) == int(StatusCode.PARENT_HASH_MISMATCH)
    check(votes)


def test_shadowed_hash_last_occurrence_wins():
    """Two votes share a vote_hash; the index resolves to the LAST one, so
    a parent link to the valid earlier vote fails once a different owner's
    later vote claims the same hash."""
    votes = build_chain(n_votes=5, n_signers=2, seed=2)
    earlier, later = next(ix for ix in owner_pairs(votes).values() if len(ix) >= 2)[:2]
    votes[later].parent_hash = votes[earlier].vote_hash
    assert oracle_code(votes) == int(StatusCode.OK)
    check(votes)
    other = next(i for i, v in enumerate(votes) if v.vote_owner != votes[earlier].vote_owner)
    shadow = votes[other].clone()
    shadow.vote_hash = votes[earlier].vote_hash
    shadow.received_hash = b""
    shadow.parent_hash = b""
    shadow.timestamp = votes[-1].timestamp
    votes.append(shadow)
    assert oracle_code(votes) == int(StatusCode.PARENT_HASH_MISMATCH)
    check(votes)


def test_shadow_by_the_same_owner_later_fails_forward():
    """The last occurrence is by the same owner but after the child: the
    parent index points forward, so the link fails although an earlier
    match exists."""
    votes = build_chain(n_votes=5, n_signers=2, seed=2)
    earlier, later = next(ix for ix in owner_pairs(votes).values() if len(ix) >= 2)[:2]
    votes[later].parent_hash = votes[earlier].vote_hash
    twin = votes[earlier].clone()
    twin.received_hash = b""
    twin.parent_hash = b""
    twin.timestamp = votes[-1].timestamp
    votes.append(twin)
    assert oracle_code(votes) == int(StatusCode.PARENT_HASH_MISMATCH)
    check(votes)


@pytest.mark.parametrize("length", [33, 64, 100])
def test_long_hash_canonicalisation(length):
    votes = build_chain(n_votes=3)
    votes[1].parent_hash = b"\x55" * length
    assert oracle_code(votes) == int(StatusCode.PARENT_HASH_MISMATCH)
    check(votes)


def test_long_hashes_match_each_other():
    """A parent hash over 32 bytes equal to a vote hash over 32 bytes is a
    match after canonicalisation (same SHA-256, same sentinel)."""
    votes = build_chain(n_votes=4, n_signers=1)
    long = b"\x21" * 48
    votes[0].vote_hash = long
    votes[1].received_hash = long
    votes[1].parent_hash = long
    assert oracle_code(votes) == int(StatusCode.OK)
    check(votes)
    votes[1].parent_hash = b"\x21" * 47 + b"\x22"
    assert oracle_code(votes) == int(StatusCode.PARENT_HASH_MISMATCH)
    check(votes)


@pytest.mark.parametrize("hi", [0, 5, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])
def test_timestamps_differing_in_the_lo_word(hi):
    """Timestamps with one hi word whose lo words straddle the bias's sign
    boundary, in order and out of order."""
    for pair in ((0x7FFFFFFF, 0x80000000), (0x80000000, 0x7FFFFFFF),
                 (0, 0xFFFFFFFF), (0xFFFFFFFF, 0)):
        votes = build_chain(n_votes=3, n_signers=1)
        votes[0].timestamp = (hi << 32) | pair[0]
        relink(votes, 0)
        votes[1].timestamp = (hi << 32) | pair[1]
        relink(votes, 1)
        votes[2].timestamp = max(votes[0].timestamp, votes[1].timestamp)
        relink(votes, 2)
        check(votes)


@pytest.mark.parametrize("seed", range(3))
def test_timestamps_at_or_above_two_to_the_63(seed):
    rng = np.random.default_rng(seed)
    votes = build_chain(n_votes=6, n_signers=2, seed=seed)
    base = (1 << 63) - 2
    for i in range(len(votes)):
        votes[i].timestamp = base + int(rng.integers(0, 5))
        relink(votes, i)
    check(votes)
    votes[-1].timestamp = (1 << 64) - 1
    relink(votes, len(votes) - 1)
    check(votes)


@pytest.mark.parametrize("seed", range(8))
def test_randomized_mutations(seed):
    rng = np.random.default_rng(100 + seed)
    votes = build_chain(n_votes=10, n_signers=4, seed=seed)
    for _ in range(3):
        i = int(rng.integers(1, len(votes)))
        kind = rng.random()
        if kind < 0.3:
            votes[i].received_hash = bytes(rng.integers(0, 256, 32, np.uint8))
        elif kind < 0.6:
            votes[i].parent_hash = bytes(rng.integers(0, 256, 32, np.uint8))
        elif kind < 0.8:
            votes[i].timestamp = int(rng.integers(0, NOW * 2))
        else:
            j = int(rng.integers(0, len(votes)))
            votes[i], votes[j] = votes[j], votes[i]
    check(votes)


def mixed_batch(seed=0):
    """Chains of mixed lengths (1 to 12 votes), some mutated."""
    rng = np.random.default_rng(seed)
    chains = []
    for s in range(9):
        votes = build_chain(n_votes=int(rng.integers(1, 13)), n_signers=3, seed=10 * seed + s)
        if len(votes) > 2 and s % 3 == 1:
            votes[int(rng.integers(1, len(votes)))].received_hash = b"\x99" * 32
        if len(votes) > 2 and s % 3 == 2:
            votes[int(rng.integers(1, len(votes)))].parent_hash = b"\x42" * 32
        chains.append(votes)
    return chains


@pytest.mark.parametrize("seed", range(3))
def test_batched_kernel_on_mixed_lengths(seed, monkeypatch):
    chains = mixed_batch(seed)
    packs = [ref_chain.pack_chain(c, pad_to=12) for c in chains]
    ref_batch = {k: np.stack([p[k] for p in packs]) for k in FIELDS}
    port_batch = chain.pack_chains(chains + [build_chain(n_votes=12, seed=99)])
    for name in FIELDS:
        np.testing.assert_array_equal(port_batch[name][:-1], ref_batch[name], err_msg=name)
    ref_statuses = np.asarray(ref_chain.chain_kernel_batch(*(ref_batch[k] for k in FIELDS)))
    tensors = chain_pack_from_numpy(ref_batch, device="cpu")
    statuses = chain.chain_kernel_batch(*(tensors[k] for k in FIELDS)).numpy()
    np.testing.assert_array_equal(statuses, ref_statuses)
    for i, votes in enumerate(chains):
        assert chain.first_chain_error(statuses[i]) == oracle_code(votes), i
    # A budget of one chain per piece (or less, or two) splits the batch;
    # the statuses stay the same.
    for budget in (144, 1, 300):
        monkeypatch.setattr(chain, "CHAIN_CELL_BUDGET", budget)
        split = chain.chain_kernel_batch(*(tensors[k] for k in FIELDS))
        np.testing.assert_array_equal(split.numpy(), statuses)


@pytest.mark.parametrize("seed", range(3))
def test_word_by_word_match_equals_the_4d_form(seed):
    chains = mixed_batch(seed)
    # Shadowing and long hashes put several matches in one row.
    chains[0] = chains[0] + [chains[0][0].clone()]
    chains[1][0].parent_hash = b"\x55" * 40
    tensors = chain_pack_from_numpy(chain.pack_chains(chains), device="cpu")
    parent, vote, valid = tensors["parent_hash"], tensors["vote_hash"], tensors["valid"]
    four_d = (parent[:, :, None, :] == vote[:, None, :, :]).all(-1) & valid[:, None, :]
    words = chain.parent_matches(parent, vote, valid)
    assert words.shape == four_d.shape == (len(chains), parent.shape[1], parent.shape[1])
    assert torch.equal(words, four_d)
    assert words.any()


def test_pack_round_trips_through_convert():
    chains = mixed_batch(1)
    pack = ref_chain.pack_chain(chains[0], pad_to=12)
    back = chain_pack_to_numpy(chain_pack_from_numpy(pack, device="cpu"))
    for name in FIELDS:
        assert back[name].dtype == pack[name].dtype, name
        np.testing.assert_array_equal(back[name], pack[name], err_msg=name)
    with pytest.raises(ValueError):
        chain_pack_from_numpy({**pack, "owner": pack["owner"].astype(np.int64)}, device="cpu")
    with pytest.raises(ValueError):
        chain_pack_from_numpy({**pack, "ts": pack["ts"][:, :1].copy()}, device="cpu")


def test_short_chains_and_empty_batch():
    for n in (0, 1, 2):
        votes = build_chain(n_votes=n)
        if n:
            check(votes)
        assert oracle_code(votes) == int(StatusCode.OK)
    empty = {k: torch.zeros((3, 0) + ((9,) if "hash" in k else (2,) if k == "ts" else ()),
                            dtype=dt) for k, dt in chain.CHAIN_FIELDS.items()}
    assert chain.chain_kernel_batch(*(empty[k] for k in FIELDS)).shape == (3, 0)
