"""The GF(2^255-19) field product: the CUDA kernel and its dispatch.

Replaces ``hashgraph_tpu/crypto_device/pallas_msm.py::_mul_kernel``, the
TPU kernel of the field multiply. :func:`fe_mul` takes two int64
``[..., 16]`` tensors of carried limbs and returns their carried product:

- on CUDA tensors it launches ``csrc/fe_mul.cu`` (built at first use by
  :mod:`hashgraph_tpu_torch._build`) on PyTorch's current stream, one
  thread per lane;
- on CPU tensors it runs the plain version,
  :func:`hashgraph_tpu_torch.crypto_device.field._mul_plain`.

Nothing falls back: a CUDA call whose build or launch fails raises, and so
does a CUDA operand that is not a contiguous int64 ``[..., 16]`` tensor of
the other operand's shape (``field.mul`` broadcasts and makes operands
contiguous before it calls here).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import field

KERNEL = "fe_mul"


@functools.cache
def _kernel():
    """The bound C entry point, built at first use and bound once (the
    multiply runs thousands of times a batch)."""
    fn = _build.library(KERNEL).hg_fe_mul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Carried product of carried field elements, lane by lane."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return field._mul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"fe_mul: unsupported device {a.device}")
    for label, t in (("a", a), ("b", b)):
        if (t.dtype != torch.int64 or t.device != a.device or not t.is_contiguous()
                or t.shape != a.shape or t.shape[-1:] != (field.LIMBS,)):
            raise ValueError(
                f"fe_mul: {label} must be a contiguous int64 [..., 16] tensor of "
                f"shape {tuple(a.shape)} on {a.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} (contiguous: {t.is_contiguous()})"
            )
    out = torch.empty_like(a)
    lanes = a.numel() // field.LIMBS
    if lanes == 0:
        return out
    err = _kernel()(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), lanes,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fe_mul: kernel launch failed (cudaError {err})")
    _build.launches[KERNEL] += 1
    return out
