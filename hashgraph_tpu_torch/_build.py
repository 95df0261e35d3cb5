"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes). Wrappers pass raw device pointers from
``tensor.data_ptr()`` and PyTorch's current stream. Libraries land in
``_build/`` beside this file (listed in ``.gitignore``), named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
unchanged source is not compiled again.

There is no fallback: a missing ``nvcc`` or a failed build raises
:class:`BuildError` carrying the compiler's output.

:func:`host_library` builds the native host runtime (a C++ source with a C
interface) the same way with ``g++``, into the same directory.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

# The host runtime's flags: the JAX package's, plus two that keep the
# library's process-wide state (its verify pool is a function-local static)
# its own when the JAX package's copy is loaded in the same process: no GNU
# unique symbols, which the dynamic linker would merge across both
# libraries, and references bound inside the library. ``-march=native`` is
# tried first and dropped if the compiler refuses it.
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
              "-fno-gnu-unique", "-Wl,-Bsymbolic")
HOST_NATIVE_FLAGS = ("-march=native",)

# Kernel launches per kernel name: each wrapper adds one where it launches
# its kernel, so a caller can show that a path really ran through it.
launches: collections.Counter = collections.Counter()
# Launches come from several threads at once (the bridge's reader threads
# start signature batches while serial lanes run scans): ``+=`` on the
# Counter is a read and a write, so a count is taken under this lock.
_count_lock = threading.Lock()

_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    """A CUDA source could not be compiled or loaded."""


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def sources() -> list[str]:
    """Names (file stems) of every CUDA source of the port."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    """The library's path, named by a hash of the source, every shared
    header under ``csrc/`` (so an edited header rebuilds what includes it)
    and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, ctypes.CDLL]:
    """Compile (one ``nvcc`` per source, all started together) and load the
    named sources, default all; returns name -> loaded library."""
    names = sources() if names is None else list(names)
    with _lock:
        todo = [name for name in names if name not in _libs]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            compiler = nvcc()
            procs = {}
            for name in todo:
                target = _target(name)
                if target.exists():
                    continue
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                procs[name] = (
                    subprocess.Popen(
                        [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                        stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT,
                        text=True,
                    ),
                    tmp,
                    target,
                )
            failed = []
            for name, (proc, tmp, target) in procs.items():
                output, _ = proc.communicate()
                _logs[name] = output
                if proc.returncode != 0:
                    failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{output}")
                else:
                    tmp.replace(target)
            if failed:
                raise BuildError("CUDA build failed:\n" + "\n".join(failed))
            for name in todo:
                try:
                    _libs[name] = ctypes.CDLL(str(_target(name)))
                except OSError as exc:
                    raise BuildError(f"cannot load {name}: {exc}") from exc
        return {name: _libs[name] for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built at first use."""
    return build([name])[name]


def cpu_tag() -> str:
    """Fingerprint of this host's instruction-set extensions (the ``flags``
    line of ``/proc/cpuinfo``): a ``-march=native`` library built on another
    host could stop at its first AVX or ADX instruction."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    return hashlib.sha256(line.encode()).hexdigest()[:16]
    except OSError:
        pass
    return platform.machine()


def host_library(source: Path) -> Path:
    """Path of the shared library ``g++`` builds from a C++ ``source``,
    building it if needed: ``-march=native`` first, then portable. Named by
    a hash of the source, the flags and :func:`cpu_tag`; written to a
    temporary file and renamed, under a file lock, so that processes
    building at once neither race nor build twice. Raises
    :class:`BuildError` if the compiler is missing or fails, and
    ``OSError`` if the source cannot be read."""
    digest = hashlib.sha256(Path(source).read_bytes())
    digest.update("\0".join(HOST_FLAGS + HOST_NATIVE_FLAGS).encode())
    digest.update(cpu_tag().encode())
    stem = Path(source).stem
    target = BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target
    compiler = shutil.which("g++")
    if compiler is None:
        raise BuildError(f"g++ not found: cannot build {source}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"lib{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():
            return target
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        failures = []
        for extra in (HOST_NATIVE_FLAGS, ()):
            try:
                proc = subprocess.run(
                    [compiler, *HOST_FLAGS, *extra, "-o", str(tmp), str(source)],
                    capture_output=True, text=True, timeout=600,
                )
            except subprocess.TimeoutExpired as exc:
                failures.append(f"{' '.join(extra) or 'portable'}: timed out after "
                                f"{exc.timeout} s")
                continue
            if proc.returncode == 0:
                tmp.replace(target)
                return target
            failures.append(f"{' '.join(extra) or 'portable'} (g++ exit "
                            f"{proc.returncode}):\n{proc.stderr}")
        tmp.unlink(missing_ok=True)
        raise BuildError(f"cannot build {source}:\n" + "\n".join(failures))


def check_operand(kernel: str, label: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's raw pointer needs."""
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device
            or not t.is_contiguous()):
        raise ValueError(
            f"{kernel}: {label} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous: {t.is_contiguous()})")


def launched(kernel: str, err: int) -> None:
    """Raise if a launch returned a non-zero ``cudaError``, else count it
    under the kernel's name."""
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed (cudaError {err})")
    with _count_lock:
        launches[kernel] += 1


def build_log(name: str) -> str:
    """What ``nvcc`` printed for a source built by this process (registers,
    shared memory and spills per kernel); empty if it was not rebuilt."""
    return _logs.get(name, "")
