"""Signed votes for the wire cells, and the reference's check of them.

Both run in worker processes of their own interpreter, talking over pipes
(nothing in ``/dev/shm``), with ``cryptography``'s Ed25519, never the program's signer.
Each voter's key comes from the seed, its scope and its place in the group.
A proposal's votes are chained in arrival order: vote k's
``received_hash`` is vote k-1's hash, and nobody votes twice, so the
parent hash stays empty.

This module imports no torch, so that workers start quickly.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from portbench.reference import wire

# The order of Ed25519's base point (RFC 8032, section 5.1).
L = 2**252 + 27742317777372353535851937790883648493


def worker_count() -> int:
    """The machine's cores but one, which the run itself keeps."""
    return max(1, min(len(os.sched_getaffinity(0)) - 1, 16))


def member_seed(seed: int, scope: int, member: int) -> bytes:
    return hashlib.sha256(
        b"portbench/member" + (seed & (2**128 - 1)).to_bytes(16, "little")
        + scope.to_bytes(4, "little") + member.to_bytes(4, "little")
    ).digest()


def _keys(seed: int):
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

    cache: dict = {}

    def key(scope: int, member: int):
        got = cache.get((scope, member))
        if got is None:
            got = Ed25519PrivateKey.from_private_bytes(member_seed(seed, scope, member))
            cache[(scope, member)] = got
        return got

    return key


def sign_task(task) -> "tuple[np.ndarray, bytes, np.ndarray]":
    """Sign the votes of some proposals. ``task`` is ``(seed, items)``, an
    item ``(p, scope, pid, members, values, vote_ids, timestamps)`` for
    the votes that will be sent, in chain order. Returns the proposal
    indices, the votes' bytes end to end and each vote's length."""
    from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat

    seed, items = task
    key = _keys(seed)
    public: dict = {}
    chunks: list = []
    lengths: list = []
    done: list = []
    for p, scope, pid, members, values, vote_ids, timestamps in items:
        received = b""
        for member, value, vote_id, ts in zip(members, values, vote_ids, timestamps):
            k = key(scope, member)
            owner = public.get((scope, member))
            if owner is None:
                owner = k.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
                public[(scope, member)] = owner
            vhash = wire.vote_hash(vote_id, owner, pid, ts, value, b"", received)
            payload = wire.signed_fields(vote_id, owner, pid, ts, value, b"", received, vhash)
            encoded = wire.with_signature(payload, k.sign(payload))
            chunks.append(encoded)
            lengths.append(len(encoded))
            received = vhash
        done.append(p)
    return np.array(done, np.int64), b"".join(chunks), np.array(lengths, np.int64)


def check_task(task) -> "dict[str, np.ndarray]":
    """The reference's reading of some rows: each decoded, its hash worked
    out again and its signature verified. ``task`` is ``(data, offsets)``.
    Identities, hashes and received hashes come back as 32-byte rows (an
    empty received hash as zeros, ``received_len`` 0)."""
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey

    data, offsets = task
    rows = len(offsets) - 1
    out = {
        "proposal_id": np.zeros(rows, np.int64),
        "timestamp": np.zeros(rows, np.uint64),
        "value": np.zeros(rows, bool),
        "owner": np.zeros((rows, 32), np.uint8),
        "received": np.zeros((rows, 32), np.uint8),
        "received_len": np.zeros(rows, np.int8),
        "hash": np.zeros((rows, 32), np.uint8),
        "hash_ok": np.zeros(rows, bool),
        "sig_ok": np.zeros(rows, bool),
    }
    keys: dict = {}
    for i in range(rows):
        vote = wire.decode(data[offsets[i]:offsets[i + 1]])
        owner, received, vhash = vote["owner"], vote["received"], vote["hash"]
        if len(owner) != 32 or len(vhash) != 32 or len(received) not in (0, 32) or vote["parent"]:
            raise ValueError("a row the benchmark did not make")
        out["proposal_id"][i] = vote["proposal_id"]
        out["timestamp"][i] = vote["timestamp"]
        out["value"][i] = vote["value"]
        out["owner"][i] = np.frombuffer(owner, np.uint8)
        out["hash"][i] = np.frombuffer(vhash, np.uint8)
        if received:
            out["received"][i] = np.frombuffer(received, np.uint8)
            out["received_len"][i] = 32
        out["hash_ok"][i] = vhash == wire.vote_hash(
            vote["vote_id"], owner, vote["proposal_id"], vote["timestamp"],
            vote["value"], vote["parent"], received)
        public = keys.get(owner)
        if public is None:
            public = keys[owner] = Ed25519PublicKey.from_public_bytes(owner)
        try:
            public.verify(vote["signature"], vote["payload"])
            out["sig_ok"][i] = True
        except InvalidSignature:
            pass
    return out


def _serve() -> None:
    """A worker: read ``(function name, task)`` pickles from stdin, answer
    each with the result's pickle on stdout, until stdin closes."""
    import pickle
    import struct
    import sys

    rx, tx = sys.stdin.buffer, sys.stdout.buffer
    while True:
        head = rx.read(8)
        if len(head) < 8:
            return
        name, task = pickle.loads(rx.read(struct.unpack("<Q", head)[0]))
        out = pickle.dumps(globals()[name](task), protocol=pickle.HIGHEST_PROTOCOL)
        tx.write(struct.pack("<Q", len(out)) + out)
        tx.flush()


def run_tasks(fn, tasks: list, workers: "int | None" = None) -> list:
    """``fn`` (a function of this module) over ``tasks`` in worker
    processes, results in task order. Every worker has ended when this
    returns, also when a task fails."""
    import pickle
    import struct
    import subprocess
    import sys
    import threading
    from pathlib import Path

    workers = min(worker_count() if workers is None else workers, len(tasks))
    if workers <= 1:
        return [fn(t) for t in tasks]
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=root)
    procs = [
        subprocess.Popen([sys.executable, "-c", "import portbench.corpus as c; c._serve()"],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=root, env=env)
        for _ in range(workers)
    ]
    results: list = [None] * len(tasks)
    errors: list = []
    next_task = iter(range(len(tasks)))
    lock = threading.Lock()

    def drive(proc) -> None:
        try:
            while True:
                with lock:
                    i = next(next_task, None)
                if i is None or errors:
                    return
                msg = pickle.dumps((fn.__name__, tasks[i]), protocol=pickle.HIGHEST_PROTOCOL)
                proc.stdin.write(struct.pack("<Q", len(msg)) + msg)
                proc.stdin.flush()
                head = proc.stdout.read(8)
                if len(head) < 8:
                    raise RuntimeError(f"a worker ended early (exit {proc.wait()})")
                results[i] = pickle.loads(proc.stdout.read(struct.unpack("<Q", head)[0]))
        except Exception as exc:  # reported once every worker has ended
            errors.append(exc)

    threads = [threading.Thread(target=drive, args=(p,)) for p in procs]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        for p in procs:
            p.stdin.close()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p.stdout.close()
    if errors:
        raise errors[0]
    return results
