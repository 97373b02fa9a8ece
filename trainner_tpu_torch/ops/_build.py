"""Builds the port's CUDA kernels and loads them with ctypes.

Each source under ``trainner_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, in
``<repo>/build/kernels/``. The library's file name carries a hash of the
source, the headers beside it (``*.cuh``) and the flags, so a library is
rebuilt only when one of them changes.
Nothing is built when this module is imported: ``load`` builds at first use,
and ``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("rdb5c.cu", "rdb5c_bwd.cu", "blur_per_sample.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    /usr/local/cuda/bin/nvcc."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str) -> Path:
    text = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def _start(source: str):
    """Starts nvcc for one source; returns (process, tmp, final) or None
    when the library is already built."""
    final = library_path(source)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def build_all(sources: List[str] = SOURCES) -> Dict[str, str]:
    """Compiles every source that has no current library, all nvcc
    processes running together. Returns the compiler's output by source
    (register and shared-memory use from -Xptxas -v); raises on failure."""
    jobs = {s: _start(s) for s in sources}
    logs = {}
    for source, job in jobs.items():
        if job is None:
            continue
        proc, tmp, final = job
        out, _ = proc.communicate()
        logs[source] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {source}:\n{out}")
        os.replace(tmp, final)
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build_all([source])
            lib = ctypes.CDLL(str(library_path(source)))
            _libs[source] = lib
        return lib
