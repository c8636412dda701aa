"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/*.cu` file has a plain C interface and is compiled on first
use into a shared library under `build/kernels/` at the repository root,
named by a hash of its source and its own nvcc flags, so a changed source
or a changed flag is rebuilt and an unchanged one is reused. All sources
are compiled in parallel, one nvcc process each. Nothing falls back: a
missing nvcc, a failed compile or a failed load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
SOURCES = {
    "fedgia_update": _PKG / "fedgia_update" / "csrc" / "fedgia_update.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "rwkv6_scan": _PKG / "rwkv6_scan" / "csrc" / "rwkv6_scan.cu",
    # not a kernel port: the round driver's conditional graph nodes
    "graph_if": _PKG.parent / "core" / "csrc" / "graph_if.cu",
}
COMMON_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Each source's own flags. fedgia_update: IEEE division and no FMA
# contraction, because the kernel is held to its plain PyTorch version
# bit for bit. rwkv6_scan: no contraction either, so each state element
# keeps the exact update fmaf(w, S, k*v) with k*v rounded on its own.
# flash_attention is held to its plain version at a tolerance, so nvcc
# may contract; it needs no library beyond the CUDA runtime (it reaches
# cuTensorMapEncodeTiled through the runtime's entry-point
# lookup, so nothing links libcuda).
SOURCE_FLAGS = {
    "fedgia_update": ("--fmad=false",),
    "flash_attention": (),
    "rwkv6_scan": ("--fmad=false",),
    "graph_if": (),
}


def nvcc_flags(name: str) -> tuple:
    return COMMON_FLAGS + SOURCE_FLAGS[name]


_lock = threading.Lock()
_libs: dict = {}
# compiler output (ptxas register and spill report) of each build made by
# this process, by kernel name
build_logs: dict = {}


def nvcc_path() -> str:
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built from source")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all) that are not built yet,
    in parallel. Returns {name: library path}."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).is_file()]
    if todo:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for n in todo:
            final = library_path(n)
            tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *nvcc_flags(n), "-o", str(tmp), str(SOURCES[n])]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for n, tmp, p in procs:
            out, _ = p.communicate()
            build_logs[n] = out
            if p.returncode != 0:
                failed.append(f"{n} (nvcc exit {p.returncode}):\n{out}")
            else:
                os.replace(tmp, library_path(n))
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
