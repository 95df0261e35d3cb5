"""The Straus MSM's two CUDA kernels and their dispatch.

They replace, for the MSM, ``hashgraph_tpu/crypto_device/pallas_msm.py::
_mul_kernel`` as the JAX package's jitted MSM (``msm.py:59``) fused it:
the point formulas run around the field product inside the kernels of
``csrc/ed_msm.cu`` (built at first use by :mod:`hashgraph_tpu_torch._build`),
launched on PyTorch's current stream:

- :func:`msm_windows` — one launch: per lane the window table and the 64
  windows, a group of threads (``csrc/ed_msm.cu``'s ``kGroup``) sharing
  each lane's accumulator;
- :func:`msm_reduce` — the tree over the lane accumulators and the
  cofactored identity test of its root: blocks of ``span`` points
  (``kTreeSpan``) each run their levels of the tree in shared memory, a
  group of threads (``kTreeGroup``) a point, and one single-block launch
  runs the rest of the tree, ``8 * root`` and the test. That is
  ``len(tree_passes(lanes, span))`` launches: two at 16,384 lanes, one
  where the lanes fit one block. The root and the int32 verdict stay on the
  device.

They take CUDA tensors only: :func:`.msm.msm_is_identity` runs the plain
versions on CPU tensors and calls here for CUDA ones. Nothing falls back:
a call whose build or launch fails raises, and so does an operand of the
wrong dtype, shape, contiguity or device. Every launch adds one to
``_build.launches`` under its kernel's name.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

SOURCE = "ed_msm"
WINDOWS_KERNEL = "msm_windows"
REDUCE_KERNEL = "msm_reduce"
KERNELS = (WINDOWS_KERNEL, REDUCE_KERNEL)

_ENTRIES = 16  # window table entries per lane
_POINT = (4, 16)  # extended coordinates x limbs


@functools.cache
def _lib() -> ctypes.CDLL:
    """The bound C entry points, built at first use and bound once."""
    lib = _build.library(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args in (
        ("hg_msm_table_lanes", [i32]),
        ("hg_msm_windows", [ptr] * 4 + [i32, i32, ptr]),
        ("hg_msm_tree_span", []),
        ("hg_msm_tree_partials", [ptr, ptr, i32, ptr]),
        ("hg_msm_tree_root", [ptr, i32, ptr, ptr, ptr]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _device(kernel: str, t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: takes CUDA tensors, got one on {t.device}")
    return t.device


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def msm_windows(points: torch.Tensor, nibbles: torch.Tensor) -> torch.Tensor:
    """Per-lane window accumulators, int64[Lanes, 4, 16], of points
    int64[Lanes, 4, 16] under MSB-first nibbles in [0, 16), int32[Lanes, W]
    (the kernel reads their low 4 bits)."""
    dev = _device(WINDOWS_KERNEL, points)
    lanes = points.shape[0]
    _build.check_operand(WINDOWS_KERNEL, "points", points, torch.int64, (lanes, *_POINT), dev)
    if nibbles.dim() != 2:
        raise ValueError(f"{WINDOWS_KERNEL}: nibbles must be [Lanes, W], got "
                         f"{tuple(nibbles.shape)}")
    _build.check_operand(WINDOWS_KERNEL, "nibbles", nibbles, torch.int32,
                         (lanes, nibbles.shape[1]), dev)
    out = torch.empty_like(points)
    if lanes == 0:
        return out
    # Each group's table (the lanes padded to the launch grid), entry by
    # entry as 64 uint16 limbs (int16 bits).
    # Dropping it on return is safe: the caching allocator hands the block
    # out again only to work ordered after this launch on the stream.
    lib = _lib()
    table = torch.empty((lib.hg_msm_table_lanes(lanes), _ENTRIES, 4 * 16),
                        dtype=torch.int16, device=dev)
    _build.launched(WINDOWS_KERNEL, lib.hg_msm_windows(
        points.data_ptr(), nibbles.data_ptr(), table.data_ptr(), out.data_ptr(),
        lanes, nibbles.shape[1], _stream(dev)))
    return out


def tree_passes(lanes: int, span: int) -> "list[int]":
    """Point counts entering each launch of :func:`msm_reduce` over
    ``lanes`` points: a pass of ``span``-point blocks while the count is
    above ``span`` (each block's partial is its span's subtree, so the
    count becomes ``ceil(count / span)``), then the root launch."""
    counts = [lanes]
    while counts[-1] > span:
        counts.append(-(-counts[-1] // span))
    return counts


def msm_reduce(acc: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """The root of the tree reduction over int64[Lanes, 4, 16], the sum of
    every lane as int64[4, 16], and int32[] 1 iff 8 * root is the identity:
    one launch per entry of :func:`tree_passes`."""
    dev = _device(REDUCE_KERNEL, acc)
    lanes = acc.shape[0]
    _build.check_operand(REDUCE_KERNEL, "acc", acc, torch.int64, (lanes, *_POINT), dev)
    if lanes == 0:
        raise ValueError(f"{REDUCE_KERNEL}: no lanes to reduce")
    return _tree(_lib(), acc, lambda err: _build.launched(REDUCE_KERNEL, err))


def _tree(lib: ctypes.CDLL, acc: torch.Tensor, launched) -> "tuple[torch.Tensor, torch.Tensor]":
    """:func:`msm_reduce`'s launches through ``lib``'s entry points (a
    build of ``csrc/ed_msm.cu``) on a checked ``acc``; ``launched`` takes
    each launch's cudaError."""
    span, src = lib.hg_msm_tree_span(), acc
    for count in tree_passes(acc.shape[0], span)[:-1]:
        partials = torch.empty((-(-count // span), *_POINT), dtype=torch.int64, device=acc.device)
        launched(lib.hg_msm_tree_partials(
            src.data_ptr(), partials.data_ptr(), count, _stream(acc.device)))
        src = partials
    root = torch.empty(_POINT, dtype=torch.int64, device=acc.device)
    verdict = torch.empty((), dtype=torch.int32, device=acc.device)
    launched(lib.hg_msm_tree_root(src.data_ptr(), src.shape[0], root.data_ptr(),
                                  verdict.data_ptr(), _stream(acc.device)))
    return root, verdict
