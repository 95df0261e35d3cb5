"""hashgraph_tpu_torch.crypto_device — device Ed25519 batch verification.

Port of ``hashgraph_tpu/crypto_device``: the randomized-linear-combination
check — batched point decompression, vectorized SHA-512 challenge hashes
and one Straus multi-scalar multiply across every signature lane — runs in
PyTorch on the GPU, with the field product as a hand-written CUDA kernel
(``csrc/fe_mul.cu``).

Layering:

- :mod:`.field`      — radix-2^16 int64-limb GF(2^255-19) core
- :mod:`.cuda_field` — the field product's kernel wrapper
- :mod:`.sha512`     — vectorized SHA-512 in 32-bit pairs, ragged batches
- :mod:`.curve`      — extended-Edwards point ops + batched decompression
- :mod:`.msm`        — the Straus MSM + cofactored identity test
- :mod:`.backend`    — pipeline orchestration, buckets, phase split, blame

The public seam is not here: engines select the backend through
``Ed25519ConsensusSigner(device_verify=True)`` (or the
``HASHGRAPH_TPU_DEVICE_VERIFY`` env), and every caller keeps speaking
``SignatureScheme.verify_batch_submit`` / ``PendingVerdicts``.
"""

from __future__ import annotations

from .backend import last_phase_seconds, verify_batch, verify_batch_begin

__all__ = [
    "verify_batch",
    "verify_batch_begin",
    "last_phase_seconds",
]
