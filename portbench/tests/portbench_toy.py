"""Toy configurations and traffic for the CPU tests: the cells' files with
their scale cut so that a run takes seconds."""

import copy

from portbench import harness


def config(name: str, **scale) -> dict:
    cfg = copy.deepcopy(harness.load_json(harness.HERE / "configs" / f"{name}.json"))
    cfg.update(scopes=4, sessions_per_scope=3, max_sessions_per_scope=3, voters=8)
    cfg["engine"] = dict(cfg["engine"], capacity=64, voter_capacity=max(64, cfg["voters"]))
    cfg.update(scale)
    return cfg


def traffic(name: str, **params) -> dict:
    tr = copy.deepcopy(harness.load_json(harness.HERE / "traffic" / f"{name}.json"))
    if name == "signed_wire":
        tr.update(rows_per_call=24, window_calls=4, check_share=1.0, profile_calls=1,
                  redelivery_share=0.1, forged_every=2, forged_per_frame=1)
    else:
        tr.update(rows_per_call=20, window_calls=12, redelivery_share=0.1)
    tr.update(params)
    return tr


def cpu_signer():
    """The device signer's class, verifying on the CPU."""
    from hashgraph_tpu_torch.signing.ed25519 import Ed25519DeviceConsensusSigner

    class CpuSigner(Ed25519DeviceConsensusSigner):
        device = "cpu"

    return CpuSigner
