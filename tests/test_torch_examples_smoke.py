"""Parity: the port's three smoke programs (``metrics_smoke``,
``trace_smoke`` and ``catchup_smoke`` in ``examples_torch/``) against the
JAX package's, run as programs on the CPU.

Each case runs the reference (``JAX_PLATFORMS=cpu python
examples/<name>.py``) and the twin (``python examples_torch/<name>.py
--device cpu``) side by side from the repository root: both exit 0 and
end on the same ``<name>-smoke OK`` line (nothing is masked: the smokes
print only that line). An ``ast`` read of both ``metrics_smoke`` files,
with neither imported (the reference imports the JAX bridge), checks that
the twin requires the reference's families less exactly the three
``hashgraph_jax_*`` ones, the port's documented divergence. Without
``--device`` on a machine with no GPU each twin exits non-zero with the
engine's "no CUDA device is available" error.
"""

import ast

import pytest
import torch

from test_torch_examples import REPO, finish, run_both, start

SMOKES = ("metrics_smoke", "trace_smoke", "catchup_smoke")
JAX_FAMILIES = {
    "hashgraph_jax_live_buffer_bytes",
    "hashgraph_jax_compile_cache_hits_total",
    "hashgraph_jax_compile_cache_misses_total",
}


@pytest.mark.parametrize("name", SMOKES)
def test_smoke_ends_on_the_reference_ok_line(name):
    (ref_rc, ref_out, ref_err), (rc, out, err) = run_both(name, ("--device", "cpu"))
    assert ref_rc == 0, ref_err[-4000:]
    assert rc == 0, err[-4000:]
    ok = f"{name.replace('_', '-')} OK"
    assert ref_out.splitlines()[-1] == ok
    assert out.splitlines() == ref_out.splitlines()


def required_families(path) -> "list[str]":
    """The literal ``REQUIRED_FAMILIES`` list of a smoke program."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "REQUIRED_FAMILIES" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no REQUIRED_FAMILIES")


def test_metrics_smoke_requires_the_reference_families_less_jax():
    ref = required_families(REPO / "examples" / "metrics_smoke.py")
    twin = required_families(REPO / "examples_torch" / "metrics_smoke.py")
    assert JAX_FAMILIES <= set(ref)
    assert twin == [f for f in ref if f not in JAX_FAMILIES]


@pytest.mark.parametrize("name", SMOKES)
def test_smoke_without_device_has_no_cpu_fallback(name):
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    rc, out, err = finish(start(f"examples_torch/{name}.py", reference=False))
    assert rc != 0
    assert "no CUDA device is available" in err, err[-4000:]
    assert "OK" not in out
