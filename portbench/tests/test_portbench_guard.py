"""The import guard compares whole top-level names: the port's name begins
with the JAX package's, and must not count."""

import subprocess
import sys
import types

from portbench import harness


def test_whole_names(monkeypatch):
    for name in ("hashgraph_tpu_torch", "hashgraph_tpu_torch.engine", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_loaded() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN_MODULES for m in harness.forbidden_loaded())
    assert "hashgraph_tpu_torch" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "hashgraph_tpu.engine", types.ModuleType("x"))
    assert "hashgraph_tpu.engine" in harness.forbidden_loaded()


def test_a_run_loads_nothing_of_jax():
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import portbench_toy as toy\n"
        "from portbench import run, harness\n"
        "run.run('groups64-columnar', toy.config('groups-64'), toy.traffic('columnar_shallow'),"
        " 5, 0.2, False, device='cpu')\n"
        "print(harness.forbidden_loaded())\n"
    ) % (str(harness.ROOT), str(harness.HERE / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "groups64-columnar",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=harness.ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
