#!/usr/bin/env python3
"""Time the port's scan kernel and count its small-call path's scan calls
for the package of one tree, so that two trees can be compared on the same
GPU.

    python3 compare_trees.py TREE

TREE is the root of a checkout of this repo (``.`` for this one). The
script imports ``hashgraph_tpu_torch`` from TREE and its measuring helpers
from ``chip_smoke.py`` beside it, so every tree is measured the same way,
and prints one JSON line:

- ``scan``: the ``ingest_scan`` wrapper at the config-3 shape (P=100,000,
  V=1,024, S=10,000, L=8, uint16 grid) on two seeded batches, the one
  ``chip_smoke.py`` phase 2 times (no pad rows, as the engine sends) and one
  with 2% pad rows (the batch the scan was first timed on). Per batch: ``ms``,
  the kernel's device time a call with the inputs put back before every
  call (``chip_smoke.restored_ms``); ``call_ms``, the same with the host's
  enqueue; the device launches of one call where the tree counts them; and
  ``empty_kernel_ms``, an empty kernel timed the same way after the same
  restore (the floor of the reading). Each result is first checked
  bit-exact against the plain scan;
- ``config2``: one P2P proposal x 1,024 voters in 8 columnar calls of 128
  votes (``chip_smoke.config2_traffic``) on a fresh GPU engine, after one
  warm-up run: the scan wrapper calls of each of 3 runs.

End-to-end speed is the benchmark's (``portbench/``). Run this once for
each tree on one machine, back to back in the order A, B, B, A, and compare
only runs made together. It needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import sys
from pathlib import Path


def main() -> int:
    tree = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.ops import cuda_ingest
    from hashgraph_tpu_torch.ops.ingest import ingest_body

    if not torch.cuda.is_available():
        print("compare_trees: no CUDA device is available", file=sys.stderr)
        return 2
    package = Path(cuda_ingest.__file__).resolve().parents[2]
    if package != tree:
        raise AssertionError(f"imported the package from {package}, not {tree}")
    dev = torch.device("cuda")
    takes_pad = "pad_rows" in inspect.signature(cuda_ingest.ingest_scan).parameters

    scan = {}
    for label, seed, pad_share in (("no pad rows", 104, 0.0), ("2% pad rows", 103, 0.02)):
        pool, slot_pack, grid = cs.random_rows(
            seed, cs.CAPACITY, cs.VOTER_CAPACITY, 10_000, 8, np.uint16, pad_share)
        has_pad = bool(((slot_pack & ((1 << 30) - 1)) >= cs.CAPACITY).any())
        base, sp, g = cs.to_device(pool, slot_pack, grid, dev)
        work = [t.clone() for t in base]
        kwargs = {"pad_rows": has_pad} if takes_pad else {}

        def call():
            return cuda_ingest.ingest_scan(*work, sp, g, **kwargs)

        def restore():
            for w, b0 in zip(work, base):
                w.copy_(b0)

        plain = [t.clone() for t in base]
        plain_out = ingest_body(*plain, sp, g)[-1]
        before = getattr(cuda_ingest, "grid_launches", None)
        out = call()
        torch.cuda.synchronize()
        launches = None if before is None else cuda_ingest.grid_launches - before
        for a, b in zip(plain + [plain_out], work + [out]):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: the scan differs from the plain scan")
        scan[label] = dict(ms=cs.restored_ms(call, restore, 20),
                           call_ms=cs.event_ms(call, restore, 20),
                           device_launches_per_call=launches,
                           empty_kernel_ms=cs.restored_ms(lambda: torch.cuda._sleep(0),
                                                          restore, 20))

    calls = []
    for rep in range(4):
        run = cs.Run(cs.make_engine(dev))
        before = _build.launches[cuda_ingest.KERNEL]
        cs.config2_traffic(run, 4)
        if rep > 0:
            calls.append(_build.launches[cuda_ingest.KERNEL] - before)
        del run

    print(json.dumps({"tree": str(tree), "device": cs.nvidia_smi(), "scan": scan,
                      "config2": {"scan_wrapper_calls": calls}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
