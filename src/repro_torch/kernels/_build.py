"""Build and load the port's hand-written CUDA kernels.

Each `.cu` file under `csrc/` has a plain C interface. It is compiled with
`nvcc` for `sm_90a` into its own shared library and loaded with `ctypes`, so
no PyTorch header is ever compiled (a build takes seconds, not minutes). The
libraries go to `build/repro_torch_kernels/` at the repository root (listed
in `.gitignore`; `REPRO_TORCH_BUILD_DIR` overrides it), named by a hash of
their source and flags, and are built at first use: nothing is compiled when
a module is imported. `build_all` starts one `nvcc` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "decode_attention": CSRC / "decode_attention.cu",
    "prefill_attention": CSRC / "prefill_attention.cu",
    "wkv6": CSRC / "wkv6.cu",
    "rglru": CSRC / "rglru.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# what the last build of each library printed (ptxas registers, spills, smem)
BUILD_LOG: Dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch are built from source at "
                       "first use and need the CUDA toolkit")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
    out = lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name].name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees half a library


def build_all() -> float:
    """Build every library that is missing, one `nvcc` per source, all at
    once. Returns the seconds spent (0.0 when everything was built)."""
    t0 = time.perf_counter()
    jobs = {n: j for n in SOURCES if (j := _start(n)) is not None}
    for n, j in jobs.items():
        _finish(n, j)
    return time.perf_counter() - t0 if jobs else 0.0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if it is missing."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def ensure_built() -> float:
    """Build and load every kernel library. Returns the seconds this call
    spent, so a caller can charge them to its compile time."""
    if len(_LIBS) == len(SOURCES):
        return 0.0
    t0 = time.perf_counter()
    build_all()
    for n in SOURCES:
        load(n)
    return time.perf_counter() - t0
