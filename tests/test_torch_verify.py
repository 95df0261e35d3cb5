"""Parity: the port's Ed25519 signers and device batch verification
(hashgraph_tpu_torch.signing.ed25519 over hashgraph_tpu_torch.crypto_device)
against the pure-Python RFC 8032 twin and the JAX package, on the CPU.

The device signer runs its pipeline on the CPU through its one class-level
seam (a subclass that sets ``device = "cpu"``). Verdicts must be identical
to the twin's item for item (tolerance: exact). The engine parity test runs
the JAX engine with its ``Ed25519DeviceConsensusSigner`` in a subprocess
(``python tests/test_torch_verify.py --reference``), so this test process
never runs the JAX backend and its metric counters stay where they were;
both sides mint proposal and vote ids from the same seeded entropy, so they
sign and ingest the same vote bytes.
"""

import json
import os
import random
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from hashgraph_tpu.obs import (
    DEVICE_VERIFY_BATCHES_TOTAL,
    DEVICE_VERIFY_FALLBACKS_TOTAL,
    DEVICE_VERIFY_SIGNATURES_TOTAL,
    registry,
)
from hashgraph_tpu.signing import Ed25519ConsensusSigner as RefSigner
from hashgraph_tpu.signing import _ed25519 as ref_py
from hashgraph_tpu_torch.errors import ConsensusSchemeError
from hashgraph_tpu_torch.signing import (
    Ed25519ConsensusSigner,
    Ed25519DeviceConsensusSigner,
)
from hashgraph_tpu_torch.signing import _ed25519 as py
from test_torch_engine import Recorder, call, results

NOW = 1_700_000_000
REPO = Path(__file__).resolve().parent.parent
L = py.L
JAX_COUNTERS = (DEVICE_VERIFY_BATCHES_TOTAL, DEVICE_VERIFY_SIGNATURES_TOTAL,
                DEVICE_VERIFY_FALLBACKS_TOTAL)
COUNTERS_AT_IMPORT = [registry.counter(name).value for name in JAX_COUNTERS]


class CpuSigner(Ed25519DeviceConsensusSigner):
    """The device signer with its batch pipeline on the CPU."""

    device = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


RFC8032_VECTORS = [
    # (seed hex, public hex, message hex, signature hex) — RFC 8032 §7.1
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


def twin_expected(idents, payloads, sigs):
    """The oracle: the JAX package's pure-Python twin per item, with the
    seam's length-error convention layered on."""
    return [
        "scheme-error" if len(s) != 64 or len(i) != 32 else ref_py.verify(bytes(i), p, bytes(s))
        for i, p, s in zip(idents, payloads, sigs)
    ]


def assert_decision_identical(idents, payloads, sigs):
    want = twin_expected(idents, payloads, sigs)
    for got in (CpuSigner.verify_batch(idents, payloads, sigs),
                Ed25519ConsensusSigner.verify_batch(idents, payloads, sigs)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if w == "scheme-error":
                assert isinstance(g, ConsensusSchemeError)
            else:
                assert g is w, (g, w)


def test_rfc8032_vectors_pinned():
    idents, payloads, sigs = [], [], []
    for seed_hex, pub_hex, msg_hex, sig_hex in RFC8032_VECTORS:
        signer = CpuSigner(bytes.fromhex(seed_hex))
        assert signer.identity().hex() == pub_hex
        msg = bytes.fromhex(msg_hex)
        sig = signer.sign(msg)
        assert sig.hex() == sig_hex
        assert CpuSigner.verify(signer.identity(), msg, sig) is True
        idents.append(signer.identity())
        payloads.append(msg)
        sigs.append(sig)
    assert CpuSigner.verify_batch(idents, payloads, sigs) == [True] * 3
    bad = list(sigs)
    bad[1] = bytes([bad[1][0] ^ 1]) + bad[1][1:]
    assert CpuSigner.verify_batch(idents, payloads, bad) == [True, False, True]


@pytest.mark.parametrize("seed", range(3))
def test_keys_and_signatures_identical_to_the_jax_signer(seed):
    rng = random.Random(seed)
    key = rng.randbytes(32)
    ours, ref = Ed25519ConsensusSigner(key), RefSigner(key, device_verify=False)
    assert ours.identity() == ref.identity()
    assert ours.private_key_bytes() == ref.private_key_bytes() == key
    for n in (0, 1, 63, 64, 200):
        msg = rng.randbytes(n)
        assert ours.sign(msg) == ref.sign(msg)


def test_selection_seam(monkeypatch):
    """device_verify / env select the device signer; without a GPU it
    raises rather than degrade; the CPU is reached only by asking."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("HASHGRAPH_TPU_DEVICE_VERIFY", raising=False)
    seed = b"\x42" * 32
    assert type(Ed25519ConsensusSigner(seed)) is Ed25519ConsensusSigner
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Ed25519ConsensusSigner(seed, device_verify=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Ed25519DeviceConsensusSigner(seed)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Ed25519DeviceConsensusSigner.random()
    monkeypatch.setenv("HASHGRAPH_TPU_DEVICE_VERIFY", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Ed25519ConsensusSigner(seed)
    assert type(Ed25519ConsensusSigner(seed, device_verify=False)) is Ed25519ConsensusSigner
    monkeypatch.setenv("HASHGRAPH_TPU_DEVICE_VERIFY", "0")
    assert type(Ed25519ConsensusSigner(seed)) is Ed25519ConsensusSigner
    cpu = CpuSigner(seed)
    assert type(cpu) is CpuSigner and type(CpuSigner.random()) is CpuSigner
    assert cpu.identity() == Ed25519ConsensusSigner(seed).identity()
    with pytest.raises(ValueError):
        Ed25519ConsensusSigner(b"short")


LOW_ORDER = [b"\x01" + b"\x00" * 31, bytes(32), b"\xec" + b"\xff" * 30 + b"\x7f"]


def fuzz_round(rng, signers, round_no, size=6):
    """One batch: every mutation class the wire can produce."""
    idents, payloads, sigs = [], [], []
    for i in range(size):
        s = signers[rng.randrange(len(signers))]
        payload = b"fuzz-%d-%d" % (round_no, i)
        ident, sig = s.identity(), s.sign(payload)
        mutation = rng.randrange(9)
        if mutation == 1:
            sig = bytes([sig[0] ^ (1 << rng.randrange(8))]) + sig[1:]
        elif mutation == 2:  # corrupt s, keep it canonical
            s_int = (int.from_bytes(sig[32:], "little") + 1 + rng.getrandbits(100)) % L
            sig = sig[:32] + s_int.to_bytes(32, "little")
        elif mutation == 3:  # non-canonical scalar s + L
            s_int = int.from_bytes(sig[32:], "little")
            if s_int + L < 2**256:
                sig = sig[:32] + (s_int + L).to_bytes(32, "little")
        elif mutation == 4:  # undecodable / non-canonical A
            ident = rng.choice([b"\xff" * 32, py.P.to_bytes(32, "little")])
        elif mutation == 5:  # low-order or identity R
            sig = rng.choice(LOW_ORDER) + sig[32:]
        elif mutation == 6:  # cross-wired payload
            payload = b"someone-else's-bytes"
        elif mutation == 7:  # low-order A
            ident = rng.choice(LOW_ORDER)
        elif mutation == 8:  # R with its sign bit flipped
            sig = sig[:31] + bytes([sig[31] ^ 0x80]) + sig[32:]
        idents.append(ident)
        payloads.append(payload)
        sigs.append(sig)
    return idents, payloads, sigs


@pytest.mark.parametrize("round_no", range(5))
def test_seeded_fuzz_decision_identity(round_no):
    rng = random.Random(0xF0D5 + round_no)
    signers = [Ed25519ConsensusSigner(rng.randbytes(32)) for _ in range(3)]
    assert_decision_identical(*fuzz_round(rng, signers, round_no))


def test_ragged_batches_scheme_errors_and_empty():
    s = CpuSigner(b"\x07" * 32)
    sig = s.sign(b"p")
    out = CpuSigner.verify_batch(
        [s.identity(), b"\x01" * 5, s.identity()], [b"p"] * 3, [sig, sig, b"xx"])
    assert out[0] is True
    assert isinstance(out[1], ConsensusSchemeError)
    assert isinstance(out[2], ConsensusSchemeError)
    assert CpuSigner.verify_batch([s.identity()] * 4, [b"p"] * 2, [sig] * 4) == [True, True]
    assert CpuSigner.verify_batch([], [], []) == []
    with pytest.raises(ConsensusSchemeError):
        CpuSigner.verify(s.identity(), b"p", sig[:63])
    with pytest.raises(ConsensusSchemeError):
        Ed25519ConsensusSigner.verify(b"\x01" * 31, b"p", sig)


def test_blame_fallback_names_exactly_the_bad_row():
    """A wrong but well-encoded s survives decompression, so the linear
    combination itself fails and the host blame pass names the row."""
    rng = random.Random(4)
    signers = [Ed25519ConsensusSigner(rng.randbytes(32)) for _ in range(3)]
    payloads = [b"blame-%d" % i for i in range(6)]
    idents = [signers[i % 3].identity() for i in range(6)]
    sigs = [signers[i % 3].sign(p) for i, p in enumerate(payloads)]
    pend = CpuSigner.verify_batch_submit(idents, payloads, sigs)
    assert pend.collect() == [True] * 6
    phases = CpuSigner.device_phase_seconds()
    assert set(phases) == {"submit", "decompress", "hash", "msm", "fallback", "total"}
    assert phases["fallback"] == 0.0 and phases["msm"] > 0.0
    s_int = int.from_bytes(sigs[4][32:], "little")
    sigs[4] = sigs[4][:32] + ((s_int + 7) % L).to_bytes(32, "little")
    assert CpuSigner.verify_batch(idents, payloads, sigs) == [True] * 4 + [False, True]
    assert CpuSigner.device_phase_seconds()["fallback"] > 0.0


def test_scalars_at_or_above_l_never_reach_the_device():
    s = Ed25519ConsensusSigner(b"\x09" * 32)
    sigs = []
    for i in range(3):
        sig = s.sign(b"m%d" % i)
        s_int = int.from_bytes(sig[32:], "little") + L
        sigs.append(sig[:32] + s_int.to_bytes(32, "little"))
    assert CpuSigner.verify_batch([s.identity()] * 3, [b"m0", b"m1", b"m2"], sigs) == [False] * 3
    phases = CpuSigner.device_phase_seconds()
    assert phases["decompress"] == phases["msm"] == 0.0


# ── The engine: JAX engine + JAX device signer against the port engine ──


def port_api():
    import hashgraph_tpu_torch as pkg
    from hashgraph_tpu_torch import protocol
    from hashgraph_tpu_torch.events import BroadcastEventBus

    def make_engine(signer, capacity, voter_capacity):
        return pkg.TorchConsensusEngine(
            signer, capacity, voter_capacity,
            event_bus=BroadcastEventBus(max_queued_events=100_000), device="cpu")

    return SimpleNamespace(pkg=pkg, protocol=protocol, make_engine=make_engine,
                           device_signer=CpuSigner, host_signer=Ed25519ConsensusSigner)


def reference_api():
    import hashgraph_tpu as pkg
    from hashgraph_tpu import protocol
    from hashgraph_tpu.engine import TpuConsensusEngine
    from hashgraph_tpu.events import BroadcastEventBus
    from hashgraph_tpu.obs.health import HealthMonitor
    from hashgraph_tpu.signing import Ed25519DeviceConsensusSigner as RefDevice

    def make_engine(signer, capacity, voter_capacity):
        return TpuConsensusEngine(
            signer, event_bus=BroadcastEventBus(max_queued_events=100_000),
            capacity=capacity, voter_capacity=voter_capacity, verify_cache=None,
            health_monitor=HealthMonitor())

    def device_signer(seed):
        signer = RefSigner(seed, device_verify=True)
        assert type(signer) is RefDevice
        return signer

    return SimpleNamespace(pkg=pkg, protocol=protocol, make_engine=make_engine,
                           device_signer=device_signer,
                           host_signer=lambda seed: RefSigner(seed, device_verify=False))


def corrupt(api, vote, kind):
    """Damage a signed vote's signature (or its owner key) in one of the
    ways the device path must reject."""
    sig = vote.signature
    s_int = int.from_bytes(sig[32:], "little")
    if kind == "scalar":  # canonical but wrong: only the MSM can tell
        vote.signature = sig[:32] + ((s_int + 7) % L).to_bytes(32, "little")
    elif kind == "s>=L":
        vote.signature = sig[:32] + (s_int + L).to_bytes(32, "little")
    elif kind == "R-sign":
        vote.signature = sig[:31] + bytes([sig[31] ^ 0x80]) + sig[32:]
    elif kind == "bad-A":  # an owner key that does not decode
        vote.vote_owner = b"\xff" * 32
        vote.vote_hash = api.pkg.compute_vote_hash(vote)
    elif kind == "short":
        vote.signature = sig[:63]


def scenario_verify(api, seed):
    """Validated ingest_votes batches signed with Ed25519: good votes,
    chained votes and every rejection class, through the engine's batch
    verification seam (two batches of seven, one lane bucket)."""
    rng = random.Random(seed)
    api.protocol.set_id_entropy(lambda: rng.getrandbits(128))
    try:
        engine = api.make_engine(api.device_signer(bytes([seed]) * 32), 16, 8)
        rec = Recorder(engine)
        voters = [api.host_signer(bytes([seed, i]) * 16) for i in range(7)]
        for i, n in enumerate((3, 4, 6)):
            rec.created("s", [engine.create_proposal("s", api.pkg.CreateProposalRequest(
                name=f"p{i}", payload=bytes([i]), proposal_owner=b"owner",
                expected_voters_count=n, expiration_timestamp=100,
                liveness_criteria_yes=True), NOW)])
        log = []
        plan = [
            [(0, 0, None), (0, 1, "scalar"), (1, 2, None), (1, 3, "s>=L"),
             (2, 4, "R-sign"), (2, 5, "bad-A"), (2, 6, None)],
            [(0, 1, None), (0, 2, None), (1, 3, None), (1, 4, "short"),
             (2, 0, None), (2, 1, None), (2, 3, None)],
        ]
        for wave, items in enumerate(plan):
            shadow = {}
            batch = []
            for k, v, kind in items:
                if k not in shadow:
                    shadow[k] = engine.get_proposal("s", rec.pids[("s", k)])
                vote = api.pkg.build_vote(shadow[k], bool(rng.random() < 0.8), voters[v],
                                          NOW + 1 + wave)
                if kind is not None:
                    corrupt(api, vote, kind)
                shadow[k].votes.append(vote)
                batch.append(("s", vote))
            log.append(call(engine.ingest_votes, batch, NOW + 1 + wave))
            log.append(rec.events())
        log.append(results(api, engine, rec, "s"))
        return log
    finally:
        api.protocol.set_id_entropy(None)


SEEDS = (1, 2)


def run_all(api):
    return {str(seed): scenario_verify(api, seed) for seed in SEEDS}


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's results, computed in a fresh interpreter."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("HASHGRAPH_TPU_DEVICE_VERIFY_PALLAS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run(
        [sys.executable, __file__, "--reference"],
        capture_output=True, text=True, timeout=600, cwd=str(REPO), env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    return json.loads(json.dumps(run_all(port_api())))


@pytest.mark.parametrize("seed", SEEDS)
def test_engine_with_device_verification_matches_reference(reference, port, seed):
    ref_log, port_log = reference[str(seed)], port[str(seed)]
    assert len(port_log) == len(ref_log)
    for i, (a, b) in enumerate(zip(port_log, ref_log)):
        assert a == b, f"seed {seed} step {i}"


def test_engine_scenario_reaches_every_rejection(port):
    from hashgraph_tpu_torch.errors import StatusCode

    statuses = [code for log in port.values() for entry in log[:4:2] for code in entry]
    for code in ("OK", "INVALID_VOTE_SIGNATURE", "SIGNATURE_SCHEME"):
        assert int(getattr(StatusCode, code)) in statuses, code
    assert "ConsensusReached" in json.dumps(port)


def test_jax_backend_counters_did_not_move():
    """Nothing in this module ran the JAX package's device backend in this
    process (its reference side runs in a subprocess)."""
    assert [registry.counter(name).value for name in JAX_COUNTERS] == COUNTERS_AT_IMPORT


if __name__ == "__main__" and sys.argv[1:] == ["--reference"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(run_all(reference_api())))
