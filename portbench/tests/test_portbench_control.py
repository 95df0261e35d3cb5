"""The comparison must fail what it should: the control (the reference
with the quorum at floor(2n/3) in the program's place) and, with the timed
path broken underneath a whole run, each fault a cell can have, the
signature verification's among them."""

import numpy as np
import pytest

import portbench_toy as toy
from portbench import control, harness, run
from portbench.harness import Ctx

CELLS = [
    ("groups64-columnar", "groups-64", "columnar_shallow", "ingest_columnar_multi"),
    ("groups64-signed-device", "groups-64", "signed_wire", "ingest_wire_columnar"),
]


@pytest.mark.parametrize("cell,config,traffic,entry", CELLS)
def test_control_is_not_correct(cell, config, traffic, entry):
    tr = toy.traffic(traffic)
    ctx = Ctx(name=cell, config=toy.config(config), traffic=tr, seed=31, device="cpu")
    driver = harness.load_module(harness.HERE / "drivers" / f"{tr['driver']}.py").Driver(ctx)
    driver.prepare()
    driver.handed = range(driver.sched.ramp_calls, driver.sched.calls)
    counts = control.counts(driver)
    assert counts["status_mismatches"] > 0 and counts["event_mismatches"] > 0


def _no_op(original):
    """A step that returns its state unchanged: every row answered OK,
    nothing applied."""
    def step(self, *args, **kwargs):
        rows = len(args[2]) if original.__name__ == "ingest_wire_columnar" else len(args[1])
        return np.zeros(rows, np.int32)
    return step


def _half(original):
    """Half the batch left out: the odd rows never reach the node, yet are
    answered as the even ones' first answer."""
    def step(self, *args, **kwargs):
        if original.__name__ == "ingest_columnar_multi":
            scopes, idx, pids, gids, values, now = args[:6]
            keep = np.arange(len(pids)) % 2 == 0
            got = original(self, scopes, idx[keep], pids[keep], gids[keep], values[keep], now,
                           **kwargs)
        else:
            from hashgraph_tpu_torch.bridge.columnar import pack_rows

            scopes, idx, cols, data, offsets, now = args[:6]
            keep = np.arange(len(cols)) % 2 == 0
            sub_data, sub_offsets, sub_cols = pack_rows(data, offsets, cols, np.nonzero(keep)[0])
            kwargs.pop("_prepass", None)
            got = original(self, scopes, idx[keep], sub_cols, sub_data, sub_offsets, now, **kwargs)
        out = np.full(len(keep), got[0] if len(got) else 0, np.int32)
        out[keep] = got
        return out
    return step


def _altered(original):
    """An answer altered where it is produced: the first row's status."""
    def step(self, *args, **kwargs):
        got = np.array(original(self, *args, **kwargs))
        if len(got):
            got[0] = 7 if got[0] != 7 else 0
        return got
    return step


@pytest.mark.parametrize("fault", [_no_op, _half, _altered])
@pytest.mark.parametrize("cell,config,traffic,entry", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, config, traffic, entry, fault):
    from hashgraph_tpu_torch.engine import TorchConsensusEngine

    original = getattr(TorchConsensusEngine, entry)
    monkeypatch.setattr(TorchConsensusEngine, entry, fault(original))
    res = run.run(cell, toy.config(config), toy.traffic(traffic), 41, 30.0, False, device="cpu",
                  signer_class=toy.cpu_signer() if traffic == "signed_wire" else None)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("accepts", [True, False], ids=["accepts-all", "refuses-all"])
def test_a_broken_device_verifier_is_not_correct(monkeypatch, accepts):
    """The device check's answer altered where it is produced: every batch
    accepted lets the forged rows through; every batch refused blames
    every frame on the host, which then answers rightly."""
    from hashgraph_tpu_torch.crypto_device import msm

    monkeypatch.setattr(msm, "msm_accepts", lambda *a, **k: accepts)
    res = run.run("groups64-signed-device", toy.config("groups-64"), toy.traffic("signed_wire"),
                  43, 30.0, False, device="cpu", signer_class=toy.cpu_signer())
    assert res["correct"] is False
    bad = {k for k, v in res["checks"].items() if v["value"] > v["limit"]}
    assert ("status_mismatches" in bad) if accepts else (bad == {"blame_mismatches"})
