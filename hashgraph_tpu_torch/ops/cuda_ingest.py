"""The arrival-ordered ingest scan: the CUDA kernel and its dispatch.

Replaces ``hashgraph_tpu/ops/pallas_ingest.py::_ingest_block_kernel``, the
TPU kernel of the scan. :func:`ingest_scan` takes the pool tensors and the
packed batch, updates the pool in place and returns the int8 ``[S, L+1]``
output (statuses, then each row's final state):

- on CUDA tensors it launches ``csrc/ingest_scan.cu`` (built at first use
  by :mod:`hashgraph_tpu_torch._build`) on PyTorch's current stream: one
  launch over the real rows, after a launch over the pad rows when the
  caller says the batch holds any;
- on CPU tensors it runs the plain version,
  :func:`hashgraph_tpu_torch.ops.ingest.ingest_body`.

Nothing falls back: a CUDA call whose build or launch fails raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ingest import grid_layout, ingest_body

KERNEL = "ingest_scan"

# Device launches the wrapper's calls made, as the C entry point reports
# them: one a call, two for a call with pad rows. ``_build.launches[KERNEL]``
# counts calls.
grid_launches = 0

_CELL_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}
_POOL_DTYPES = (
    ("state", torch.int32),
    ("yes", torch.int32),
    ("tot", torch.int32),
    ("vote_mask", torch.bool),
    ("vote_val", torch.bool),
    ("n", torch.int32),
    ("req", torch.int32),
    ("cap", torch.int32),
    ("gossipsub", torch.bool),
    ("liveness", torch.bool),
    ("slot_pack", torch.int32),
)


@functools.cache
def _bound():
    """The kernel's C entry point, built at first use and bound once."""
    fn = _build.library(KERNEL).hg_ingest_scan
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ingest_scan(
    state, yes, tot, vote_mask, vote_val, n, req, cap, gossipsub, liveness,
    slot_pack, grid_pack, pad_rows: bool = True,
) -> torch.Tensor:
    """Apply the packed vote batch to the pool in arrival order; returns
    the int8 ``[S, L+1]`` output. Same contract as :func:`ingest_body`.

    ``pad_rows`` says whether ``slot_pack`` may hold pad rows (ids >= P);
    when it is False the kernel's pad-row launch is skipped, and a pad row
    in the batch would be left unwritten in the output."""
    global grid_launches
    tensors = (state, yes, tot, vote_mask, vote_val, n, req, cap, gossipsub,
               liveness, slot_pack)
    if state.device.type == "cpu":
        return ingest_body(*tensors, grid_pack)[-1]
    if state.device.type != "cuda":
        raise ValueError(f"ingest_scan: unsupported device {state.device}")
    for (label, dtype), t in zip(_POOL_DTYPES, tensors):
        if t.dtype != dtype or t.device != state.device or not t.is_contiguous():
            raise ValueError(
                f"ingest_scan: {label} must be a contiguous {dtype} tensor on "
                f"{state.device}, got {t.dtype} on {t.device}"
            )
    if grid_pack.dtype not in _CELL_BYTES or grid_pack.device != state.device:
        raise ValueError(
            f"ingest_scan: grid must be uint8, int16 or int32 on {state.device}, "
            f"got {grid_pack.dtype} on {grid_pack.device}"
        )
    grid_pack = grid_pack.contiguous()
    p, v = vote_mask.shape
    s_count, depth = grid_pack.shape
    if slot_pack.shape != (s_count,):
        raise ValueError("ingest_scan: slot_pack and grid rows differ")
    lane_mask, val_bit, valid_bit = grid_layout(grid_pack.dtype)
    out = torch.empty((s_count, depth + 1), dtype=torch.int8, device=state.device)
    if s_count == 0:
        return out
    launched = ctypes.c_int(0)
    err = _bound()(
        *(t.data_ptr() for t in tensors),
        grid_pack.data_ptr(),
        out.data_ptr(),
        s_count, depth, p, v, _CELL_BYTES[grid_pack.dtype],
        lane_mask, val_bit, valid_bit, int(pad_rows), ctypes.byref(launched),
        torch.cuda.current_stream(state.device).cuda_stream,
    )
    _build.launched(KERNEL, err)
    with _build._count_lock:
        grid_launches += launched.value
    return out
