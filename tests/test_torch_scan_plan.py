"""The columnar path's dispatch plan: one scan dispatch per call while the
padded [slots, depth] grid stays within the pool's cell budget, segments
of ``max_depth`` past it.

The port's plan is device-independent, so the CPU shows it: the pool's
``ingest_async_grouped`` is wrapped to record each dispatch. Statuses,
events and results of the same calls are held against the JAX package's
engine, which runs in a subprocess (``python tests/test_torch_scan_plan.py
--reference``) as in ``tests/test_torch_engine.py`` (tolerance: exact).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from test_torch_engine import NOW, Recorder, call, port_api, reference_api, request, results

REPO = Path(__file__).resolve().parent.parent
ROWS = 601  # 1 deep row and 600 shallow ones: 1024 x 256 padded cells
DEEP = 200


def plan_trace(api, record=None):
    """Call 1 votes once on every row (the closed-form fresh path); call 2
    is skewed, one row 200 votes deep beside 600 rows of one vote, beyond
    the cell budget; calls 3 and 4 are config 2's shape, 128 votes on one
    row with ``max_depth=8``, on a gossipsub and on a P2P proposal."""
    pkg = api.pkg
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 1024, 256)
    if record is not None:
        pool = engine.pool()
        inner = pool.ingest_async_grouped

        def recorded(uniq, row, col, depth, *args, fresh=False, **kwargs):
            record[-1].append([len(uniq), int(depth), bool(fresh)])
            return inner(uniq, row, col, depth, *args, fresh=fresh, **kwargs)

        pool.ingest_async_grouped = recorded
    rec = Recorder(engine)
    engine.scope("p2p").p2p_preset().initialize()
    rec.created("gs", engine.create_proposals(
        "gs", [request(api, i, 150, live=bool(i % 2)) for i in range(ROWS)], NOW))
    rec.created("p2p", engine.create_proposals("p2p", [request(api, 0, 100)], NOW))
    pids = np.array([rec.pids[("gs", k)] for k in range(ROWS)])
    gids = np.array([engine.voter_gid(b"v%d" % i) for i in range(400)])
    rng = np.random.default_rng(7)
    log = []

    def ingest(scope, rows_p, rows_v, depth_cap):
        if record is not None:
            record.append([])
        vals = rng.random(len(rows_p)) < 0.7
        log.append(call(engine.ingest_columnar, scope, rows_p, rows_v, vals,
                        NOW + 1 + len(log), depth_cap))
        log.append(rec.events())

    ingest("gs", pids, gids[np.arange(ROWS) % 400], 8)
    deep = np.concatenate([np.zeros(DEEP, np.int64), np.arange(1, ROWS)])
    order = rng.permutation(len(deep))
    ingest("gs", pids[deep[order]], gids[(deep[order] + 1 + np.arange(len(deep))) % 400], 8)
    ingest("gs", np.full(128, pids[0]), gids[200:328], 8)
    p2p = rec.pids[("p2p", 0)]
    ingest("p2p", np.full(6, p2p), gids[:6], 8)
    ingest("p2p", np.full(128, p2p), gids[6:134], 8)
    log.append(results(api, engine, rec, "gs"))
    log.append(results(api, engine, rec, "p2p"))
    return log


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(REPO / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    proc = subprocess.run([sys.executable, __file__, "--reference"], capture_output=True,
                          text=True, timeout=600, cwd=str(REPO), env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    record: list = []
    try:
        log = json.loads(json.dumps(plan_trace(port_api(), record)))
    finally:
        torch.set_num_threads(prev)
    return log, record


def test_config2_shaped_call_is_one_dispatch(port):
    """One row, 128 votes, max_depth=8: one scan dispatch of depth 128,
    where segmenting by max_depth made 16."""
    _, record = port
    for call_plan in (record[2], record[4]):
        assert call_plan == [[1, 128, False]]


def test_skewed_call_beyond_the_budget_is_segmented(port):
    """A 200-deep row beside 600 one-vote rows pads past the cell budget,
    so the call still goes in ceil(200 / 8) segments of depth 8."""
    _, record = port
    assert record[0] == [[ROWS, 1, True]]
    assert len(record[1]) == -(-DEEP // 8)
    assert all(depth == 8 and not fresh for _, depth, fresh in record[1])
    assert record[1][0][0] == ROWS and all(s == 1 for s, _, _ in record[1][1:])


def test_plans_give_the_reference_statuses(reference, port):
    log, _ = port
    assert len(log) == len(reference)
    for i, (a, b) in enumerate(zip(log, reference)):
        assert a == b, f"step {i}"
    from hashgraph_tpu_torch.errors import StatusCode

    statuses = {c for entry in log[:-2:2] for c in entry}
    for code in ("OK", "ALREADY_REACHED"):
        assert int(getattr(StatusCode, code)) in statuses, code


if __name__ == "__main__" and sys.argv[1:] == ["--reference"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(plan_trace(reference_api())))
