"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under
``<repo>/build/repro_torch/<hash of the sources and flags>/``, and loaded
with ``ctypes``.  Building happens at first use (or all at once through
:func:`build_all`, which starts one ``nvcc`` per source in parallel).
Nothing here runs at import time, so the CPU tests import every module
without a toolchain.

A failed build raises; a non-zero ``cudaError_t`` returned by a C entry
point raises (:func:`call`).  Nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("sparse_gemv.cu", "sparse_matmul.cu", "sparse_attention.cu",
           "dense_matmul.cu", "sparse_matmul_int8.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# src/repro_torch/kernels/build.py -> repository root
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(source: str) -> Path:
    return BUILD_ROOT / _digest() / (Path(source).stem + ".so")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def build_all(sources: Iterable[str] = SOURCES,
              extra_flags: Iterable[str] = ()) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns ``{source: compiler output}``; raises on failure."""
    todo = [s for s in sources if not lib_path(s).exists()]
    logs: Dict[str, str] = {}
    if not todo:
        return logs
    nvcc = nvcc_path()
    procs = {}
    for src in todo:
        out = lib_path(src)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for src, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[src] = text
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)              # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if missing."""
    lib = _LIBS.get(source)
    if lib is None:
        if not lib_path(source).exists():
            build_all([source])
        lib = ctypes.CDLL(str(lib_path(source)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return lib


def call(source: str, name: str, argtypes, *args) -> None:
    """Call the C entry point ``name`` of one kernel library (its signature
    declared once); a non-zero ``cudaError_t`` raises."""
    fn = _FUNCS.get((source, name))
    if fn is None:
        fn = getattr(load(source), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FUNCS[(source, name)] = fn
    err = fn(*args)
    if err != 0:
        msg = load(source).repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def refuse_growth_under_capture(what: str) -> None:
    """A per-device buffer that would be created or grown while a CUDA graph
    is captured raises: it would live in the graph's private pool while the
    wrappers' dict handed it to later eager calls.  Warm up at the graph's
    shapes first.  (Where torch has no CUDA device nothing is captured.)"""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{what} would grow during a CUDA graph capture; run the same "
            "shapes eagerly once before capturing")


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device, contiguous; returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return dev
