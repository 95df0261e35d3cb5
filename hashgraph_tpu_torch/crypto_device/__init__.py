"""hashgraph_tpu_torch.crypto_device — device Ed25519 batch verification.

Port of ``hashgraph_tpu/crypto_device``: the randomized-linear-combination
check — batched point decompression, vectorized SHA-512 challenge hashes
and one Straus multi-scalar multiply across every signature lane — runs on
the GPU: the MSM as two hand-written CUDA kernels (``csrc/ed_msm.cu``),
decompression's inverse-square-root chain as one (``csrc/fe_pow22523.cu``)
and its remaining field products as another (``csrc/fe_mul.cu``), all over
the shared arithmetic of ``csrc/fe25519.cuh`` and ``csrc/
fe25519_group.cuh``, and the challenge hashes as one more
(``csrc/sha512.cu`` over ``csrc/sha512.cuh``); the rest is PyTorch.

Layering:

- :mod:`.field`      — radix-2^16 int64-limb GF(2^255-19) core
- :mod:`.cuda_field` — the field product's and the chain's kernel wrappers
- :mod:`.sha512`     — SHA-512 of ragged batches: the kernel's wrapper, the plain version
- :mod:`.curve`      — extended-Edwards point ops + batched decompression
- :mod:`.msm`        — the Straus MSM + cofactored identity test
- :mod:`.cuda_msm`   — the MSM's kernel wrappers
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
