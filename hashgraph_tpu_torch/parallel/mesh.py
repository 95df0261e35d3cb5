"""Device-mesh helpers for the sharded consensus pool.

Port of ``hashgraph_tpu/parallel/mesh.py``. The unit of parallelism is the
proposal: every proposal slot is independent (no cross-proposal dataflow
in the protocol — the reference partitions state the same way by
scope/proposal, src/storage.rs:188-194), so the natural mesh is one axis
over all devices with the slot axis split across it. On PyTorch a mesh is
a list of ``torch.device``s in slot-block order; an entry may repeat
(several blocks on one card).
"""

from __future__ import annotations

import torch

from ..engine.pool import resolve_device

__all__ = ["PROPOSAL_AXIS", "consensus_mesh"]

PROPOSAL_AXIS = "p"


def consensus_mesh(n_devices: int | None = None, device="cuda") -> list[torch.device]:
    """A 1-D mesh over the first ``n_devices`` visible GPUs (default: all).

    Without a GPU it raises, as every pool does: ``device="cpu"`` gives
    ``n_devices`` (default 1) entries of the CPU, the counterpart of the
    JAX package's ``--xla_force_host_platform_device_count``, which is
    how the tests run the sharded path without a card.
    """
    base = resolve_device(device)
    if base.type == "cpu":
        return [base] * (1 if n_devices is None else n_devices)
    if base.type != "cuda":
        raise ValueError(f"consensus_mesh: unsupported device {base}")
    count = torch.cuda.device_count()
    if n_devices is not None:
        if n_devices > count:
            raise ValueError(f"requested {n_devices} devices, have {count}")
        count = n_devices
    return [torch.device("cuda", i) for i in range(count)]
