"""Build the port's CUDA sources with ``nvcc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, ``build/kernels/<name>-<hash>.so`` at the repository root, keyed
by a hash of the source and the flags, so a changed source rebuilds and an
unchanged one loads at once. Nothing here runs at import: the CPU tests
import every module, and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# -fmad=false keeps every multiply and add separately rounded, as in the
# plain PyTorch version, so a kernel follows it op for op: every kernel but
# these, which are held to a tolerance rather than to bit-equality and may
# fuse a multiply and an add.
FUSED_MULTIPLY_ADD = frozenset({"flash_attention"})


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``."""
    if name in FUSED_MULTIPLY_ADD:
        return NVCC_FLAGS
    return (*NVCC_FLAGS, "-fmad=false")


@dataclass(frozen=True)
class Built:
    """A loaded kernel library and what its build reported."""

    lib: ctypes.CDLL
    path: Path
    seconds: float          # 0.0 when the library was already built
    ptxas_log: str          # nvcc's -Xptxas -v report (registers, spills)


_LOADED: dict[tuple[str, ...], Built] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin, /usr/local/cuda)")


def load(name: str, defines: tuple[str, ...] = ()) -> Built:
    """Compile ``csrc/<name>.cu`` (with ``-D`` for each of ``defines``) if
    its hashed library is missing, then load it. Raises on any build or load
    failure."""
    key = (name, *defines)
    if key in _LOADED:
        return _LOADED[key]
    src = CSRC / f"{name}.cu"
    flags = (*nvcc_flags(name), *(f"-D{d}" for d in defines))
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                            ).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: a concurrent process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, out)
    built = Built(lib=ctypes.CDLL(str(out)), path=out, seconds=seconds,
                  ptxas_log=log)
    _LOADED[key] = built
    return built
