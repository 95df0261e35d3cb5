"""The GF(2^255-19) field kernels and their dispatch: the product and the
inverse-square-root chain.

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

:func:`fe_pow22523` is ``field.pow22523``'s chain, z^((p-5)/8), as one
launch of ``csrc/fe_pow22523.cu`` (a group of threads per lane,
``kPowGroup``, running the 262 products of ``csrc/fe25519_group.cuh`` in
registers, each thread holding its share of every element's limbs) on
CUDA tensors, and the plain version :func:`hashgraph_tpu_torch.
crypto_device.field._pow22523_plain` on CPU tensors, with the same checks.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import field

KERNEL = "fe_mul"
POW_KERNEL = "fe_pow22523"


@functools.cache
def _kernel():
    """The bound C entry point, built at first use and bound once."""
    fn = _build.library(KERNEL).hg_fe_mul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _pow_kernel():
    fn = _build.library(POW_KERNEL).hg_fe_pow22523
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(kernel: str, label: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.shape[-1:] != (field.LIMBS,):
        raise ValueError(f"{kernel}: {label} must be [..., 16], got {tuple(t.shape)}")
    _build.check_operand(kernel, label, t, torch.int64, like.shape, like.device)


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Carried product of carried field elements, lane by lane."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return field._mul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"fe_mul: unsupported device {a.device}")
    _check(KERNEL, "a", a, a)
    _check(KERNEL, "b", b, a)
    out = torch.empty_like(a)
    lanes = a.numel() // field.LIMBS
    if lanes == 0:
        return out
    _build.launched(KERNEL, _kernel()(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), lanes,
        torch.cuda.current_stream(a.device).cuda_stream,
    ))
    return out


def fe_pow22523(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8) of carried field elements, lane by lane."""
    if z.device.type == "cpu":
        return field._pow22523_plain(z)
    if z.device.type != "cuda":
        raise ValueError(f"fe_pow22523: unsupported device {z.device}")
    _check(POW_KERNEL, "z", z, z)
    out = torch.empty_like(z)
    lanes = z.numel() // field.LIMBS
    if lanes == 0:
        return out
    _build.launched(POW_KERNEL, _pow_kernel()(
        z.data_ptr(), out.data_ptr(), lanes,
        torch.cuda.current_stream(z.device).cuda_stream,
    ))
    return out
