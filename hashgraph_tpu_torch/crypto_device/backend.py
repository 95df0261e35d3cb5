"""The device batch-verify pipeline behind the ``verify_batch_submit`` seam.

Port of ``hashgraph_tpu/crypto_device/backend.py``. Three device stages over
one signature batch:

1. **decompress** — A and R encodings for every lane, stacked into one
   ``curve.decompress`` (the shared inverse-sqrt chain);
2. **hash** — vectorized SHA-512 challenge hashes k_i over R||A||M;
3. **msm** — the randomized-linear-combination check, one Straus MSM
   across all lanes (``msm.msm_is_identity``).

Host work between stages is O(n) bookkeeping: canonical-scalar checks
(s < L), mod-L scalar algebra for the randomizers, and window
decomposition. Lane counts and SHA block counts pad to power-of-two buckets,
as in the JAX package.

Failure semantics: the combination accepting proves every lane verifies
under the cofactored criterion; it failing says only "at least one lane is
bad", so the batch drops to the host verifiers for exact per-item blame:
the native runtime's batch verification, or the pure-Python twin
(``signing/_ed25519.py``) where the library is absent. Verdicts are
therefore decision-identical to the twin on every input.

The pipeline runs on the device it is given, ``"cuda"`` by default; it
raises when that is a GPU and none is present. Each batch keeps its own
phase seconds (the ``phases`` of the collect that :func:`verify_batch_begin`
returns): ``submit`` is the host precheck and packing; ``decompress`` and
``hash`` are each stage's enqueue in :func:`verify_batch_begin` plus the
wait for its result at collect (with eager PyTorch the enqueue is most of
a stage's cost); ``msm`` is the scalar algebra, the nibbles, the MSM and
the verdict read; ``fallback`` the host blame. :func:`last_phase_seconds`
gives those of the batch collected last. With the process-wide tracer on,
each phase's parts are also spans (``verify.submit``,
``verify.decompress.enqueue``, ``verify.hash.enqueue``,
``verify.decompress.wait``, ``verify.hash.wait``, ``verify.msm.scalars``,
``verify.msm.nibbles``, ``verify.msm.device``, ``verify.fallback``), each
tagged with the batch's number.
Each batch counts on :mod:`..obs`'s registry, as the JAX backend's does:
``hashgraph_device_verify_batches_total`` and ``_signatures_total`` at
submit, ``_fallbacks_total`` per host blame, and the batch's work seconds
(the phases' sum) in ``hashgraph_device_verify_seconds``.
"""

from __future__ import annotations

import itertools
import secrets

import numpy as np
import torch

from ..obs import (
    DEVICE_VERIFY_BATCHES_TOTAL,
    DEVICE_VERIFY_FALLBACKS_TOTAL,
    DEVICE_VERIFY_SECONDS,
    DEVICE_VERIFY_SIGNATURES_TOTAL,
    registry,
    stage_span,
)
from ..signing._ed25519 import L  # ONE home for the group order
from ..tracing import tracer

# The identity's encoding (y=1): the inert pad for unused lanes.
_PAD_ENC = b"\x01" + b"\x00" * 31

_last_collected: "dict[str, float]" = {}
_batch_numbers = itertools.count()


def last_phase_seconds() -> "dict[str, float]":
    """Per-phase seconds of the batch collected last."""
    return dict(_last_collected)


def _bucket(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _mark(device: torch.device):
    """A point on the device's stream to wait for (None on the CPU, where
    every op has finished when it returns)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def verify_batch_begin(
    identities: "list[bytes]",
    payloads: "list[bytes]",
    signatures: "list[bytes]",
    device="cuda",
):
    """Enqueue decompression and the challenge hashes on ``device`` now;
    the returned zero-arg collect yields one bool per item, and its
    ``phases`` attribute holds this batch's phase seconds. Lengths must
    be pre-checked by the seam."""
    from ..engine.pool import resolve_device
    from . import curve, sha512

    device = resolve_device(device)
    n = len(identities)
    verdicts = [False] * n
    phases = {
        "submit": 0.0, "decompress": 0.0, "hash": 0.0, "msm": 0.0,
        "fallback": 0.0,
    }
    batch = next(_batch_numbers)
    registry.counter(DEVICE_VERIFY_BATCHES_TOTAL).inc()
    registry.counter(DEVICE_VERIFY_SIGNATURES_TOTAL).inc(n)

    with stage_span(tracer, "verify.submit", phases, "submit", batch=batch):
        # Host precheck: non-canonical scalars (s >= L) are False without
        # touching the device, as in the host verifiers.
        live = [
            i for i in range(n)
            if int.from_bytes(signatures[i][32:], "little") < L
        ]
        if live:
            k = len(live)
            lanes = _bucket(2 * k)
            enc = np.zeros((lanes, 32), np.uint8)
            enc[2 * k:] = np.frombuffer(_PAD_ENC, np.uint8)
            for j, i in enumerate(live):
                enc[j] = np.frombuffer(identities[i], np.uint8)
                enc[k + j] = np.frombuffer(signatures[i][:32], np.uint8)
            # Challenge hashes k_i = SHA-512(R || A || M), bucketed on
            # lanes and block count.
            msgs = [signatures[i][:32] + identities[i] + payloads[i] for i in live]
            blocks = _bucket(max(sha512.blocks_needed(len(m)) for m in msgs), 1)
            hash_lanes = _bucket(k)
    if not live:
        _finish_phases(phases)

        def _nothing_live() -> "list[bool]":
            return verdicts

        _nothing_live.phases = phases
        return _nothing_live

    with stage_span(tracer, "verify.decompress.enqueue", phases, "decompress", batch=batch):
        points_dev, ok_dev = curve.decompress(torch.from_numpy(enc).to(device))
        decompressed = _mark(device)
    with stage_span(tracer, "verify.hash.enqueue", phases, "hash", batch=batch):
        digests_dev = sha512.sha512_batch_dispatch(
            msgs + [b""] * (hash_lanes - k), blocks, device
        )

    def _collect() -> "list[bool]":
        from . import msm

        with stage_span(tracer, "verify.decompress.wait", phases, "decompress", batch=batch):
            if decompressed is not None:
                decompressed.synchronize()
            ok = ok_dev.cpu().numpy()
        with stage_span(tracer, "verify.hash.wait", phases, "hash", batch=batch):
            digests = sha512.digest_bytes(digests_dev)[:k]

        with stage_span(tracer, "verify.msm.scalars", phases, "msm", batch=batch):
            ok_a, ok_r = ok[:k], ok[k:2 * k]
            surv = [j for j in range(k) if ok_a[j] and ok_r[j]]
            if surv:
                # Randomized linear combination (fresh nonzero 128-bit z
                # per item per batch, from secrets: predictable z would
                # let a forger craft a batch that passes): accept iff
                # 8*(S*B + sum -z_i h_i A_i + sum -z_i R_i) == O.
                h = [int.from_bytes(bytes(digests[j]), "little") % L for j in surv]
                z = [1 + secrets.randbelow((1 << 128) - 1) for _ in surv]
                m = len(surv)
                msm_lanes = _bucket(2 * m + 1)
                s_total = 0
                for row, j in enumerate(surv):
                    s = int.from_bytes(signatures[live[j]][32:], "little")
                    s_total = (s_total + z[row] * s) % L
                scalars = [(-(z[r] * h[r])) % L for r in range(m)]
                scalars += [(-z[r]) % L for r in range(m)]
                scalars.append(s_total)
        if not surv:
            _finish_phases(phases)
            return verdicts
        with stage_span(tracer, "verify.msm.nibbles", phases, "msm", batch=batch):
            nibbles = np.zeros((msm_lanes, msm.WINDOWS), np.int32)
            nibbles[:2 * m + 1] = msm.scalars_to_nibbles(scalars)
        with stage_span(tracer, "verify.msm.device", phases, "msm", batch=batch):
            # Lanes: A_i, then R_i, then B, then identity padding.
            rows = np.array(surv + [k + j for j in surv], np.int64)
            pts = curve.identity((msm_lanes,), device).clone()
            pts[:2 * m] = points_dev[torch.from_numpy(rows).to(device)]
            pts[2 * m] = curve.base_point((), device)
            accepted = msm.msm_accepts(pts, torch.from_numpy(nibbles).to(device))

        if accepted:
            for j in surv:
                verdicts[live[j]] = True
        else:
            registry.counter(DEVICE_VERIFY_FALLBACKS_TOTAL).inc()
            with stage_span(tracer, "verify.fallback", phases, "fallback", batch=batch):
                rows_i = [live[j] for j in surv]
                host = _host_blame(
                    [identities[i] for i in rows_i],
                    [payloads[i] for i in rows_i],
                    [signatures[i] for i in rows_i],
                )
                for i, verdict in zip(rows_i, host):
                    verdicts[i] = bool(verdict)
        _finish_phases(phases)
        return verdicts

    _collect.phases = phases
    return _collect


def _finish_phases(phases: "dict[str, float]") -> None:
    # Work, not wall: total = what begin+collect actually spent, so an
    # async caller's overlap gap never inflates the histogram.
    global _last_collected
    phases["total"] = sum(phases.values())
    registry.histogram(DEVICE_VERIFY_SECONDS).observe(phases["total"])
    _last_collected = phases


def _host_blame(identities, payloads, signatures) -> "list[bool]":
    """Exact per-item verdicts from the host verifiers (the native pool's
    batch if the library is present, else the pure-Python twin): the blame
    pass after a failed linear combination."""
    from .. import native
    from ..signing import _ed25519 as _py

    results = native.ed25519_verify_batch(
        [bytes(i) for i in identities],
        list(payloads),
        [bytes(s) for s in signatures],
    )
    if results is not None:
        return [code == 1 for code in results]
    return [
        _py.verify(bytes(i), p, bytes(s))
        for i, p, s in zip(identities, payloads, signatures)
    ]


def verify_batch(identities, payloads, signatures, device="cuda") -> "list[bool]":
    """Synchronous wrapper: begin + collect."""
    return verify_batch_begin(identities, payloads, signatures, device)()
