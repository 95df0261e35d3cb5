"""The port imports no JAX and nothing of the JAX package.

The run-time check happens in a fresh interpreter with ``jax`` and
``hashgraph_tpu`` blocked in ``sys.modules``, so this test process keeps
its own modules untouched: a vote cycle on the engine and the README
quick-start on the service over the pool-backed storage, with Ethereum
signers on the port's native runtime. A static scan covers every import statement of
the package, of ``chip_smoke.py`` and of ``compare_trees.py``, including
imports inside functions, and every string literal of the package outside
docstrings: none may name the JAX package (``hashgraph_tpu`` as a module
or ``hashgraph-tpu`` as a distribution), since a ``sys.modules`` key or a
metadata lookup by that name reaches the JAX package without an import.
The example programs under ``examples_torch/`` are scanned the same way,
and none may reach into the JAX package's ``examples/`` (the C embedder
they build is the shared ``native/bridge_client.c``); three of them also
run to their end with ``jax`` and ``hashgraph_tpu`` blocked.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "hashgraph_tpu_torch"
EXAMPLES = sorted((REPO / "examples_torch").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "hashgraph_tpu")

CYCLE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["hashgraph_tpu"] = None
import hashgraph_tpu_torch as ht
for info in pkgutil.walk_packages(ht.__path__, "hashgraph_tpu_torch."):
    importlib.import_module(info.name)
import torch
torch.set_num_threads(1)
eng = ht.TorchConsensusEngine(ht.StubConsensusSigner(b"me"), 8, 4, device="cpu")
rx = eng.event_bus().subscribe()
p = eng.create_proposal("s", ht.CreateProposalRequest(
    name="x", payload=b"", proposal_owner=b"me", expected_voters_count=3,
    expiration_timestamp=60, liveness_criteria_yes=True), 1000)
eng.cast_vote("s", p.proposal_id, True, 1001)
prop = eng.get_proposal("s", p.proposal_id)
eng.process_incoming_vote(
    "s", ht.build_vote(prop, True, ht.StubConsensusSigner(b"peer"), 1002), 1002)
assert eng.get_consensus_result("s", p.proposal_id) is True
assert type(rx.try_recv()[1]).__name__ == "ConsensusReached"
# The README quick-start through the service layer: three Ethereum-signed
# peers over one pool-backed storage, the native runtime signing.
from hashgraph_tpu_torch import native
from hashgraph_tpu_torch.ops.decide import STATE_REACHED_YES
assert native.available()
storage, bus = ht.TorchBackedStorage(device="cpu"), ht.BroadcastEventBus()
peers = [ht.ConsensusService(storage, bus, ht.EthereumConsensusSigner(k)) for k in (1, 2, 3)]
rx = bus.subscribe()
p = peers[0].create_proposal("deployments", ht.CreateProposalRequest(
    name="ship-v2", payload=b"git:abc123", proposal_owner=peers[0].signer().identity(),
    expected_voters_count=3, expiration_timestamp=60, liveness_criteria_yes=True), 1000)
peers[0].cast_vote("deployments", p.proposal_id, True, 1000)
peers[1].cast_vote("deployments", p.proposal_id, True, 1000)
assert rx.try_recv()[1] == ht.ConsensusReached(p.proposal_id, True, 1000)
late = ht.build_vote(storage.get_proposal("deployments", p.proposal_id), False,
                     peers[2].signer(), 1000)
peers[0].process_incoming_vote("deployments", late, 1000)
assert storage.get_consensus_result("deployments", p.proposal_id) is True
assert storage.device_state_of("deployments", p.proposal_id) == STATE_REACHED_YES
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("jax", "jaxlib") or m.startswith("hashgraph_tpu.")))
print("LOADED", loaded)
"""


def test_full_cycle_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", CYCLE],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOADED []" in proc.stdout


BRIDGE = r"""
import sys
from hashgraph_tpu_torch.bridge import BridgeClient, BridgeServer, columnar
import hashgraph_tpu_torch.gossip, hashgraph_tpu_torch.parallel
from hashgraph_tpu_torch.gossip import shm
from hashgraph_tpu_torch.parallel import ShardMigratingError
import torch
torch.set_num_threads(1)
with BridgeServer(capacity=8, voter_capacity=4, device="cpu") as server:
    with BridgeClient(*server.address) as client:
        peer, identity = client.add_peer()
        assert len(identity) == 20
        pid, _ = client.create_proposal(peer, "s", 1000, "p", b"", 1, 60)
        client.cast_vote(peer, "s", pid, True, 1001)
        assert client.get_result(peer, "s", pid) is True
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "hashgraph_tpu")))
print("LOADED", loaded)
"""


def test_bridge_gossip_and_parallel_load_no_jax():
    """Importing the bridge, gossip and parallel packages and serving a
    proposal over the bridge, in a fresh interpreter with nothing blocked,
    leaves neither JAX nor the JAX package in ``sys.modules``."""
    proc = subprocess.run(
        [sys.executable, "-c", BRIDGE],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOADED []" in proc.stdout


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"] + EXAMPLES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_native_paths(path):
    """The port builds and loads its own native runtime: nothing names the
    JAX package's build output or its loader."""
    text = path.read_text()
    for name in ("native/build", "hashgraph_tpu/native.py"):
        assert name not in text, f"{path.relative_to(REPO)} names {name}"


def _imports(path: Path):
    """(module, line) for every import statement in a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module, node.lineno


SOURCES = (sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "compare_trees.py"]
           + EXAMPLES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_anywhere(path):
    bad = [(m, line) for m, line in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_build_or_triton_at_import_time(path):
    """Kernels are built inside the function that launches them: nothing at
    module level imports triton or PyTorch's extension builder."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert not name.startswith(("triton", "torch.utils.cpp_extension")), name


REFERENCE_NAME = re.compile(r"hashgraph_tpu(?!_torch)|hashgraph-tpu")


def _docstring_nodes(tree):
    """The string constants that are docstrings of the module, a class or
    a function."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                out.add(id(body[0].value))
    return out


def reference_name_strings(path: Path):
    """(line, text) of every string literal outside docstrings that names
    the JAX package (comments are not in the tree)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = _docstring_nodes(tree)
    return [
        (node.lineno, node.value)
        for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
        and id(node) not in docs and REFERENCE_NAME.search(node.value)
    ]


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + EXAMPLES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_string_names_the_reference_package(path):
    bad = reference_name_strings(path)
    assert not bad, f"{path.relative_to(REPO)} names the JAX package in {bad}"


def test_string_scan_sees_what_imports_miss(tmp_path):
    """The scan catches the by-name reaches an import scan cannot see, and
    leaves docstrings, comments and the port's own name alone."""
    src = tmp_path / "probe.py"
    src.write_text(
        '"""Docstring naming hashgraph_tpu."""\n'
        "import sys  # a comment naming hashgraph_tpu\n"
        "def f():\n"
        '    """hashgraph-tpu in a docstring."""\n'
        '    a = sys.modules.get("hashgraph_tpu")\n'
        '    b = version("hashgraph-tpu")\n'
        '    c = sys.modules.get("hashgraph_tpu.native")\n'
        '    d = f"{a}hashgraph_tpu_torch"\n'
    )
    assert [line for line, _ in reference_name_strings(src)] == [5, 6, 7]


REFERENCE_EXAMPLES = re.compile(r"(?<!\w)examples/")


def test_example_twins_are_all_here():
    assert [p.name for p in EXAMPLES] == sorted(p.name for p in (REPO / "examples").glob("*.py"))


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: str(p.relative_to(REPO)))
def test_example_twin_reaches_no_reference_example(path):
    """No path into the JAX package's ``examples/``, in code or text; the
    one shared file a twin reads is ``native/bridge_client.c``."""
    text = path.read_text()
    assert not REFERENCE_EXAMPLES.search(text), REFERENCE_EXAMPLES.search(text)
    joined = [node.lineno for node in ast.walk(ast.parse(text))
              if isinstance(node, ast.Constant) and node.value == "examples"]
    assert not joined, f"a path joined from 'examples' at lines {joined}"
    shared = set(re.findall(r"native/[\w.]+", text))
    assert shared <= {"native/bridge_client.c"}, shared


BLOCKED_RUN = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["hashgraph_tpu"] = None
path, *args = sys.argv[1:]
sys.argv = [path, *args]
from hashgraph_tpu_torch import native
native._load()  # built before the twin's server runs, not while its client waits
runpy.run_path(path, run_name="__main__")
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("jax", "jaxlib") or m.startswith("hashgraph_tpu.")))
print("LOADED", loaded)
"""


@pytest.mark.parametrize("args", [("quickstart.py",), ("gossip_simulation.py",),
                                  ("bridge_embedder.py", "--device", "cpu")],
                         ids=lambda a: a[0])
def test_example_twin_runs_with_jax_blocked(args):
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, f"examples_torch/{args[0]}", *args[1:]],
        capture_output=True, text=True, timeout=180, cwd=str(REPO),
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1] == "LOADED []"
