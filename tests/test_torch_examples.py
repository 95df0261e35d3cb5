"""Parity: the port's example programs (``examples_torch/``) against the
JAX package's (``examples/``), run as programs on the CPU.

Each case starts the reference as ``JAX_PLATFORMS=cpu python
examples/<name>.py`` and the twin as ``python examples_torch/<name>.py
[--device cpu]``, each in a subprocess from the repository root, side by
side. Exit codes must be equal, and stdout equal line for line after
masking (``chip_smoke.EXAMPLE_MASKS``, which phase 17 applies between a
twin's card and CPU runs). Masked, and only these (each is filled by wall
time, ``os.urandom`` or the kernel):

- proposal ids (``quickstart``, ``gossip_simulation``, and the C
  embedder's ``proposal N created`` in ``bridge_embedder``): minted from
  the wall clock and random bytes;
- peer identity hex (``bridge_embedder``'s ``address 0x...``): keys from
  ``os.urandom``;
- trace-id hex (``gossip_simulation``'s ``one trace (...)``): random;
- the seconds and votes/s figures of ``batch_engine``'s rate line: wall
  time;
- the listening port of ``bridge_embedder``'s first line, which the
  kernel assigns.

Also here: every twin keeps its reference's command-line flags (read from
both files' ``add_argument`` calls), adding ``--device`` where the program
does device work; and a twin run without ``--device`` on a machine with
no GPU exits non-zero with the engine's "no CUDA device is available"
error, so no twin moves to the CPU by itself.

Tolerance: exact, after the masks above.
"""

import ast
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from chip_smoke import EXAMPLE_MASKS, masked_transcript as masked  # noqa: E402

TIMEOUT = 180  # seconds any one program may take before it is killed

# The twins that do device work take --device; the other two drive the
# scalar service over in-memory storage, as their references do.
DEVICE_TWINS = (
    "batch_engine", "bridge_embedder", "catchup_smoke", "trace_smoke",
    "metrics_smoke", "gossip_peer", "federation_host", "federation_scrape_smoke",
)
HOST_TWINS = ("quickstart", "gossip_simulation")
ALL_TWINS = HOST_TWINS + DEVICE_TWINS

@functools.lru_cache(maxsize=None)
def native_library() -> "str | None":
    """The port's build of ``native/consensus_native.cpp`` (made once, under
    its file lock), or None without a compiler."""
    from hashgraph_tpu_torch import native

    lib = native._load()
    return None if lib is None else lib._name


def reference_env() -> dict:
    """The reference's environment: the JAX package on the CPU, without
    the test harness's forced virtual device count. It loads the port's
    build of the same native source (``HASHGRAPH_TPU_NATIVE``, the JAX
    package's own override): the JAX package compiles its copy at first
    use, about 10 s with no lock between processes, and a reference started
    on a fresh checkout of a busy host would time out its own bridge
    client (10 s) while its server compiles."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    if native_library() is not None:
        env["HASHGRAPH_TPU_NATIVE"] = native_library()
    return env


def twin_env() -> dict:
    """The twin's environment: one intra-op thread, as the port's tests
    keep torch, so concurrent programs do not oversubscribe the cores. The
    port's native library is built first, so no twin's server compiles it
    while its client waits."""
    native_library()
    return dict(os.environ, OMP_NUM_THREADS="1")


def start(path: str, *args: str, reference: bool, env=None, **kw) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, path, *args], cwd=str(REPO), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env or (reference_env() if reference else twin_env()), **kw,
    )


def finish(proc: subprocess.Popen, timeout: float = TIMEOUT) -> "tuple[int, str, str]":
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"{proc.args} ran past {timeout} s: {out[-2000:]} {err[-2000:]}")
    return proc.returncode, out, err


def run_both(name: str, twin_args=(), tmp=None) -> "tuple[tuple, tuple]":
    """(rc, stdout, stderr) of the reference and of the twin, run side by
    side; with ``tmp``, both get it as their TMPDIR."""
    extra = {} if tmp is None else {"TMPDIR": str(tmp)}
    ref = start(f"examples/{name}.py", reference=True, env={**reference_env(), **extra})
    port = start(f"examples_torch/{name}.py", *twin_args, reference=False,
                 env={**twin_env(), **extra})
    return finish(ref), finish(port)


def test_masks_touch_only_their_fields():
    assert set(EXAMPLE_MASKS) == {"quickstart", "batch_engine", "gossip_simulation",
                                  "bridge_embedder"}
    assert masked("batch_engine", "4000 votes in 0.97s (4,128 votes/sec incl. host build_vote)") == [
        "4000 votes in <masked>s (<masked> votes/sec incl. host build_vote)"]
    assert masked("bridge_embedder", "  bob: peer 2, address 0xfbb9\nbob: peer 5, identity 20 bytes") == [
        "  bob: peer 2, address 0x<masked>", "bob: peer 5, identity 20 bytes"]
    assert masked("quickstart", "alice voted YES -> active") == ["alice voted YES -> active"]


@pytest.mark.parametrize("name", ("quickstart", "batch_engine", "gossip_simulation",
                                  "bridge_embedder"))
def test_transcript_equals_reference(name):
    twin_args = ("--device", "cpu") if name in DEVICE_TWINS else ()
    (ref_rc, ref_out, ref_err), (rc, out, err) = run_both(name, twin_args)
    assert ref_rc == 0, ref_err[-4000:]
    assert rc == ref_rc, err[-4000:]
    assert masked(name, out) == masked(name, ref_out)


def _flags(path: Path) -> "set[str]":
    """The option strings of every ``add_argument`` call in a program."""
    tree = ast.parse(path.read_text())
    return {
        arg.value
        for node in ast.walk(tree)
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"
        for arg in node.args if isinstance(arg, ast.Constant)
    }


@pytest.mark.parametrize("name", ALL_TWINS)
def test_twin_keeps_the_reference_flags(name):
    ref = _flags(REPO / "examples" / f"{name}.py")
    twin = _flags(REPO / "examples_torch" / f"{name}.py")
    assert twin == ref | ({"--device"} if name in DEVICE_TWINS else set())


def test_batch_engine_without_device_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    rc, out, err = finish(start("examples_torch/batch_engine.py", reference=False))
    assert rc != 0
    assert "no CUDA device is available" in err, err[-4000:]
    assert "votes dispatched" not in out
