"""The chaos simulator held byte for byte against the JAX package's.

For every scenario of ``SCENARIOS`` at the reference's pinned ``SEED``,
for ``partition-heal`` and ``storm`` at two more seeds, and for
``columnar-wire-storm`` with the apply reactor forced on (the reference's
merge fault included), the port's verdict JSON (``run_scenario(...,
device="cpu")`` serialised with ``sort_keys=True``) must equal the JAX
package's exactly. Nothing is masked: the verdicts carry no wall time and
no package name (ids, signatures, WAL bytes and fingerprints are pure
functions of the seed in both packages).

The JAX side never runs in this process (its registry, tracer and flight
recorder stay untouched): ``python tests/test_torch_sim_parity.py
--reference`` runs every case on the JAX CPU backend and prints one JSON
object, case -> verdict JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SEED = 424242
EXTRA_SEEDS = (7, 1001)
SCENARIO_NAMES = (
    "partition-heal", "asymmetric-partition", "storm", "crash-restart-wal",
    "crash-restart-catchup", "equivocator", "forker", "expired-spam-burst",
    "columnar-wire-storm", "roll-deploy", "timeout-liveness",
    "tiered-crash-recovery", "slo-burn", "flapping-links", "slow-never-dead",
    "stale-partial-synchrony",
)
REACTOR_ON = {"apply_reactor": True}


def cases() -> "list[tuple[str, str, int, dict | None]]":
    """(case id, scenario, seed, overrides) of every compared run."""
    out = [(f"{name}@{SEED}", name, SEED, None) for name in SCENARIO_NAMES]
    out += [(f"{name}@{seed}", name, seed, None)
            for name in ("partition-heal", "storm") for seed in EXTRA_SEEDS]
    out.append((f"columnar-wire-storm@{SEED}+reactor", "columnar-wire-storm", SEED, REACTOR_ON))
    return out


CASES = cases()


def verdict_json(pkg: str, name: str, seed: int, overrides) -> str:
    import importlib

    scenarios = importlib.import_module(f"{pkg}.sim.scenarios")
    kwargs = {"overrides": overrides} if overrides else {}
    if pkg == "hashgraph_tpu_torch":
        kwargs["device"] = "cpu"
    return json.dumps(scenarios.run_scenario(name, seed, **kwargs), sort_keys=True)


@pytest.fixture(scope="module")
def reference() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, __file__, "--reference"], capture_output=True,
                          text=True, timeout=600, cwd=str(REPO), env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_case_list_covers_every_scenario():
    from hashgraph_tpu_torch.sim import SCENARIOS

    assert sorted(SCENARIOS) == sorted(SCENARIO_NAMES)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_verdict_json_is_byte_identical(case, reference):
    case_id, name, seed, overrides = case
    ours = verdict_json("hashgraph_tpu_torch", name, seed, overrides)
    assert json.loads(ours)["passed"], ours
    assert ours == reference[case_id]


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps({case_id: verdict_json("hashgraph_tpu", name, seed, overrides)
                      for case_id, name, seed, overrides in CASES}))
