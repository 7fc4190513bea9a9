"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``kernels/_build/lib<name>-<hash>.so`` (the hash is the source's, so an
edited source never loads a stale library), then loaded with ``ctypes``.
Nothing here includes PyTorch's headers, which keeps a build at seconds;
the wrappers pass raw pointers and the current stream. ``-Xptxas -v``
makes nvcc report each kernel's registers and spills; :func:`ptxas_log`
returns that report.

Nothing is compiled at import time: the CPU tests import every module
and this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
#: nvcc's output per source compiled by this process
_logs: dict[str, str] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on the PATH."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source
    and of every shared ``csrc/*.cuh`` header it may include."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, out: Path | None = None):
    """Start ``nvcc`` for one source into ``out`` (the library by
    default); None when that file exists."""
    out = out or library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    _logs[name] = log


def build(names) -> float:
    """Compile every named source that is not built yet, one ``nvcc``
    per source, all started together. Returns the seconds it took."""
    t0 = time.perf_counter()
    started = [(n, _start(n)) for n in names]
    for n, s in started:
        _finish(n, s)
    return time.perf_counter() - t0


def kernel_sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def ptxas_log(name: str) -> str:
    """nvcc's report for ``csrc/<name>.cu`` (``-Xptxas -v``: registers,
    spills per kernel): this process's build's, else that of a compile
    into a scratch file, deleted after."""
    if name not in _logs:
        scratch = BUILD_DIR / f"report-{name}-{os.getpid()}.so"
        _finish(name, _start(name, scratch))
        scratch.unlink(missing_ok=True)
    return _logs[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


__all__ = ["BUILD_DIR", "build", "kernel_sources", "library_path", "load",
           "nvcc", "ptxas_log"]
