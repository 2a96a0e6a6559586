"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded through ``ctypes``
(no PyTorch headers, so a build takes seconds). The libraries go to
``build/gllm_tpu_torch/<hash>/`` at the root of the checkout, keyed by a
hash of the sources and flags, and are built at first use: all sources
compile in parallel, one ``nvcc`` each. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "gllm_tpu_torch"
SOURCES = ("decode_attention", "ragged_attention", "mla_decode_attention",
           "mla_ragged_attention", "mla_unified_attention", "gdn_scan",
           "graph_cond", "threefry")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

# dtype codes of csrc/paged_kv.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# cache codes of csrc/paged_kv.cuh: the cache holds q's dtype, int8 (with
# per-page scales) or fp8 (e4m3, no scales)
CACHE_NATIVE, CACHE_INT8, CACHE_FP8 = 0, 1, 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of each library's C entry point (pointers and the stream as
# c_void_p; an int argument left to ctypes' default would cut a pointer)
_SIGNATURES = {
    "decode_attention": ("gllm_decode_attention",
                         [_P] * 9 + [_I] * 9 + [_F, _I, _I, _P]),
    "ragged_attention": ("gllm_ragged_attention",
                         [_P] * 10 + [_I] * 10 + [_F, _I, _I, _I, _P]),
    "mla_decode_attention": ("gllm_mla_decode_attention",
                             [_P] * 6 + [_I] * 8 + [_F, _I, _I, _P]),
    "mla_ragged_attention": ("gllm_mla_ragged_attention",
                             [_P] * 6 + [_I] * 7 + [_F, _I, _I, _P]),
    "mla_unified_attention": ("gllm_mla_unified_attention",
                              [_P] * 7 + [_I] * 9 + [_F, _I, _I, _I, _P]),
    "gdn_scan": ("gllm_gdn_chunk_scan", [_P] * 9 + [_I] * 5 + [_P]),
    "threefry": ("gllm_threefry_noise", [_P] * 3 + [_I] * 5 + [_P]),
    # not a kernel port: the conditional nodes of runner/graphs.py
    "graph_cond": ("gllm_graph_conditional", [_I, _P, _P, _P]),
}

_lock = threading.Lock()
_libs: Optional[Dict[str, ctypes._CFuncPtr]] = None
# what the last build printed: per source, nvcc's -Xptxas -v lines, and
# the wall seconds of the build (0 when the cache was warm)
build_log: Dict[str, str] = {}
build_seconds = 0.0


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "gllm_tpu_torch need the CUDA toolkit")
    return found


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every source that has no library in the cache yet; returns
    name → library path. Raises with nvcc's output when a build fails."""
    global build_seconds
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.monotonic()
    procs = {}
    paths = {}
    for name in SOURCES:
        lib = out_dir / f"lib{name}.so"
        paths[name] = lib
        if lib.exists():
            log = lib.with_suffix(".log")
            build_log[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc={proc.returncode}) ---\n"
                          f"{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    build_seconds = time.monotonic() - t0 if procs else 0.0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def kernel(name: str):
    """The C entry point of library ``name`` (built and loaded on first
    use)."""
    global _libs
    if _libs is None:
        with _lock:
            if _libs is None:
                libs = {}
                for lib_name, path in build().items():
                    sym, argtypes = _SIGNATURES[lib_name]
                    fn = getattr(ctypes.CDLL(str(path)), sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    libs[lib_name] = fn
                _libs = libs
    return _libs[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({_error_name(rc)}) at launch")


def _error_name(rc: int) -> str:
    try:
        cudart = ctypes.CDLL("libcudart.so")
        cudart.cudaGetErrorString.restype = ctypes.c_char_p
        return cudart.cudaGetErrorString(ctypes.c_int(rc)).decode()
    except OSError:
        return "unknown"
