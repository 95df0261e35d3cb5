"""Carry pool state across between the JAX package and the port.

:func:`pool_from_numpy` builds a port :class:`ProposalPool` from the arrays
of a pool of the JAX package, given as numpy (device arrays and host
mirrors), so traffic that started there can continue on the port.
:func:`pool_to_numpy` is its inverse. :func:`sharded_pool_from_numpy`
does the same for the JAX package's ``ShardedPool``, whose global arrays it
splits into the port's per-device blocks (:func:`pool_to_numpy`
concatenates them again, in mesh order). :func:`field_from_numpy` and
:func:`points_from_numpy` carry field elements and curve points of the
device verifier across (the JAX package's uint32 limbs to the port's
int64), with their inverses. :func:`chain_pack_from_numpy` takes the
arrays of the JAX package's ``ops.chain.pack_chain`` (one chain, or a
batch stacked on a leading axis) to the tensors of the port's chain check,
and :func:`chain_pack_to_numpy` gives them back. This module takes and gives numpy only:
extracting the arrays from JAX is the caller's business.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import resolve_device
from .engine.pool import ProposalPool, SlotMeta, SlotTensors
from .ops.chain import CHAIN_FIELDS

# Device arrays: name -> (pool attribute, dtype).
DEVICE_ARRAYS = {
    "state": ("_state", torch.int32),
    "yes": ("_yes", torch.int32),
    "tot": ("_tot", torch.int32),
    "vote_mask": ("_vote_mask", torch.bool),
    "vote_val": ("_vote_val", torch.bool),
    "n": ("_n", torch.int32),
    "req": ("_req", torch.int32),
    "cap": ("_cap", torch.int32),
    "gossip": ("_gossip", torch.bool),
    "liveness": ("_liveness", torch.bool),
}

# Host mirrors: name -> pool attribute. ``meta`` maps slot -> (key,
# expiry, created_at); the rest are numpy arrays, lists, dicts or ints.
HOST_FIELDS = {
    "state_host": "_state_host",
    "expiry_host": "_expiry_host",
    "free": "_free",
    "gid_of": "_gid_of",
    "owners": "_owners",
    "gid_refs": "_gid_refs",
    "gid_live": "_gid_live",
    "gid_gen": "_gid_gen",
    "gen_floor": "_gen_floor",
    "free_gids": "_free_gids",
    "lane_gids": "_lane_gids",
    "lane_count": "_lane_count",
}


def _copy(value):
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, (list, dict)):
        return type(value)(value)
    return value


def _fill_rows(rows: SlotTensors, arrays: dict, lo: int, hi: int) -> None:
    """Set ``rows``' tensors to rows ``[lo, hi)`` of the given arrays."""
    for name, (attr, dtype) in DEVICE_ARRAYS.items():
        # torch.tensor copies: the pool never aliases the caller's arrays.
        setattr(rows, attr, torch.tensor(
            np.asarray(arrays[name])[lo:hi], dtype=dtype, device=rows.device
        ))


def _fill_host(pool: ProposalPool, arrays: dict, host_meta: dict) -> None:
    """Check the arrays' rows and set the pool's host mirrors."""
    for name in DEVICE_ARRAYS:
        rows = np.asarray(arrays[name]).shape[0]
        if rows != pool.capacity:
            raise ValueError(f"{name}: {rows} rows, expected {pool.capacity}")
    for name, attr in HOST_FIELDS.items():
        setattr(pool, attr, _copy(host_meta[name]))
    pool._meta = {
        int(slot): SlotMeta(key=key, expiry=int(expiry), created_at=int(created))
        for slot, (key, expiry, created) in host_meta["meta"].items()
    }
    pool._inflight = []


def pool_from_numpy(arrays: dict, host_meta: dict, device="cuda") -> ProposalPool:
    """A port pool holding exactly the given state.

    ``arrays`` has one numpy array per name of :data:`DEVICE_ARRAYS`
    (``state [P]``, ``vote_mask [P, V]`` ...); ``host_meta`` has one value
    per name of :data:`HOST_FIELDS` plus ``meta``. Capacity and voter
    capacity come from the shape of ``vote_mask``.
    """
    p, v = np.asarray(arrays["vote_mask"]).shape
    pool = ProposalPool.__new__(ProposalPool)
    pool.capacity = int(p)
    pool.voter_capacity = int(v)
    pool.device = resolve_device(device)
    _fill_host(pool, arrays, host_meta)
    _fill_rows(pool, arrays, 0, pool.capacity)
    return pool


def sharded_pool_from_numpy(arrays: dict, host_meta: dict, mesh) -> "ShardedPool":
    """A port :class:`~.parallel.ShardedPool` holding exactly the state of
    a JAX ``ShardedPool``: ``arrays`` are its global arrays (``np.asarray``
    of each sharded array, in global slot order), split here into one block
    a mesh entry; ``host_meta`` as :func:`pool_from_numpy` takes it (the
    round-robin free list included). The capacity must divide evenly over
    the mesh."""
    from .parallel.sharded import ShardedPool

    p, v = np.asarray(arrays["vote_mask"]).shape
    mesh = [resolve_device(d) for d in mesh]
    if not mesh or p % len(mesh):
        raise ValueError(f"{p} slots do not split over a mesh of {len(mesh)}")
    pool = ShardedPool.__new__(ShardedPool)
    pool.mesh = mesh
    pool.n_devices = len(mesh)
    pool.local_capacity = p // len(mesh)
    pool.scan_dispatches = [0] * len(mesh)
    pool.capacity = int(p)
    pool.voter_capacity = int(v)
    pool.device = mesh[0]
    _fill_host(pool, arrays, host_meta)
    pool._blocks = []
    for d, device in enumerate(mesh):
        block = SlotTensors.__new__(SlotTensors)
        block.capacity, block.voter_capacity, block.device = pool.local_capacity, int(v), device
        _fill_rows(block, arrays, d * pool.local_capacity, (d + 1) * pool.local_capacity)
        pool._blocks.append(block)
    return pool


def pool_to_numpy(pool: ProposalPool) -> tuple[dict, dict]:
    """``(arrays, host_meta)`` of a port pool, in the form
    :func:`pool_from_numpy` takes; a sharded pool's blocks are
    concatenated in mesh order (global slot order)."""
    pool._flush_writes()
    blocks = getattr(pool, "_blocks", [pool])
    arrays = {
        name: np.concatenate([getattr(b, attr).cpu().numpy() for b in blocks])
        for name, (attr, _) in DEVICE_ARRAYS.items()
    }
    host_meta = {name: _copy(getattr(pool, attr)) for name, attr in HOST_FIELDS.items()}
    host_meta["meta"] = {
        slot: (m.key, m.expiry, m.created_at) for slot, m in pool._meta.items()
    }
    return arrays, host_meta


def field_from_numpy(limbs, device="cuda") -> torch.Tensor:
    """Field elements of the JAX package (``uint32[..., 16]`` radix-2^16
    limbs) as the port's ``int64[..., 16]``."""
    arr = np.asarray(limbs)
    if arr.shape[-1:] != (16,):
        raise ValueError(f"field elements need 16 limbs, got shape {arr.shape}")
    return torch.tensor(arr.astype(np.int64), device=resolve_device(device))


def field_to_numpy(limbs: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`field_from_numpy`: ``uint32[..., 16]``."""
    return limbs.cpu().numpy().astype(np.uint32)


def points_from_numpy(points, device="cuda") -> torch.Tensor:
    """Extended points of the JAX package (``uint32[..., 4, 16]``) as the
    port's ``int64[..., 4, 16]``."""
    arr = np.asarray(points)
    if arr.shape[-2:] != (4, 16):
        raise ValueError(f"points need shape [..., 4, 16], got {arr.shape}")
    return field_from_numpy(arr, device)


def points_to_numpy(points: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`points_from_numpy`: ``uint32[..., 4, 16]``."""
    return field_to_numpy(points)


def chain_pack_from_numpy(pack: dict, device="cuda") -> "dict[str, torch.Tensor]":
    """A ``pack_chain`` dict (``vote_hash``, ``received_hash``,
    ``parent_hash`` ``[..., V, 9]``, ``owner`` ``[..., V]``, ``ts``
    ``[..., V, 2]``, ``valid`` ``[..., V]``) as tensors on ``device``, in the
    dtypes ``ops.chain`` takes (int32, ``valid`` bool)."""
    dev = resolve_device(device)
    out = {}
    for name, dtype in CHAIN_FIELDS.items():
        arr = np.asarray(pack[name])
        if name != "valid" and arr.dtype != np.int32:
            raise ValueError(f"{name}: dtype {arr.dtype}, expected int32")
        out[name] = torch.tensor(arr, dtype=dtype, device=dev)
    shape = tuple(out["owner"].shape)
    for name in ("vote_hash", "received_hash", "parent_hash"):
        if tuple(out[name].shape) != shape + (9,):
            raise ValueError(f"{name}: shape {tuple(out[name].shape)}, expected {shape + (9,)}")
    if tuple(out["ts"].shape) != shape + (2,) or tuple(out["valid"].shape) != shape:
        raise ValueError("ts and valid must match owner's shape")
    return out


def chain_pack_to_numpy(tensors: dict) -> "dict[str, np.ndarray]":
    """The inverse of :func:`chain_pack_from_numpy`: int32 arrays and a
    bool ``valid``, as ``pack_chain`` makes them."""
    return {
        name: tensors[name].cpu().numpy().astype(bool if name == "valid" else np.int32)
        for name in CHAIN_FIELDS
    }
