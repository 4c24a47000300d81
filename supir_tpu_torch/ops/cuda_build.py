"""Build the port's CUDA C++ kernels with nvcc and load them with ctypes.

Each source under `supir_tpu_torch/csrc/` is compiled on first use into a
shared library with a plain C interface, under `build/supir_tpu_torch/` at
the root of the checkout. The library's file name carries a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source is rebuilt and a stale library is never loaded. `build_all` starts
one nvcc per source, all at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "supir_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _library_path(source: str) -> Path:
    """Where `csrc/<source>`'s library goes: its name carries a hash of the
    source, the shared headers (a source that includes an edited header is
    rebuilt) and the flags."""
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def _compile(source: str) -> Path:
    """Compile `csrc/<source>` unless its library exists; return its path."""
    src = CSRC / source
    out = _library_path(source)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
            # ptxas -v reports registers, shared memory and spills per kernel
            out.with_suffix(".ptxas.txt").write_text(proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def build_all(sources) -> dict[str, float]:
    """Compile every source in parallel (one nvcc each), then load them;
    returns the seconds each build took. A failed build raises."""

    def one(source):
        t0 = time.perf_counter()
        _compile(source)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {source: pool.submit(one, source) for source in sources}
        seconds = {source: f.result() for source, f in futures.items()}
    for source in sources:
        load_library(source)
    return seconds


def ptxas_report(source: str) -> str:
    """The `-Xptxas -v` lines nvcc printed for `source` as it stands under
    CSRC: registers, shared memory and spills per kernel (empty if no build
    directory holds its library's report)."""
    path = _library_path(source).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def load_library(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` if needed and return the loaded library."""
    if source in _loaded:
        return _loaded[source]
    lib = ctypes.CDLL(str(_compile(source)))
    _loaded[source] = lib
    return lib
