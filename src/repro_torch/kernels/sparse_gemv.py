"""Sparse GEMV for at most 8 rows: the decode-tick linears.

Replaces ``repro/kernels/sparse_gemv.py:sparse_gemv_pallas`` with the CUDA
kernel in ``csrc/sparse_gemv.cu``.  Bound on the H100: device-memory bytes
(bitmap + packed values + x + y over 3.35 TB/s), since M <= 8 rows do at
most 16 flops per stored weight.  The design splits every compressed block
by rows across thread blocks so 8-24 column blocks still spread over the
132 SMs, expands bits in place against the x sliver in shared memory, and
sums the f32 partials over the K splits in a second small kernel.

Output is in the dtype of x (bf16 on the serving path, f32 in f32
configs); CPU tensors take the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sparse_format import BlockSparseWeight
from . import build
from .sparse_matmul import sparse_matmul_plain

_SRC = "sparse_gemv.cu"
_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
MAX_ROWS = 8
ROWS_PER_CTA = 64


def sparse_gemv_plain(x: torch.Tensor, sw: BlockSparseWeight,
                      out_dtype=None) -> torch.Tensor:
    """Plain version (twin of ``kernels/ref.py:sparse_gemv_ref``, which is
    the sparse matmul oracle)."""
    return sparse_matmul_plain(x, sw, out_dtype)


def sparse_gemv(x: torch.Tensor, sw: BlockSparseWeight,
                out_dtype=None) -> torch.Tensor:
    """``x [M<=8, K] @ unpack(sw)``; CPU tensors take the plain version."""
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"gemv path is for m<={MAX_ROWS}, got {x.shape[0]}")
    if x.device.type == "cpu":
        return sparse_gemv_plain(x, sw, out_dtype)
    if x.dtype not in build.DTYPE_CODE or \
            sw.values.dtype not in build.DTYPE_CODE:
        raise TypeError(f"sparse_gemv kernel takes f32/bf16, got {x.dtype} "
                        f"/ {sw.values.dtype}")
    if sw.bitmap.dim() != 3:
        raise ValueError("sparse_gemv takes one (un-stacked) weight")
    x = x.contiguous()
    build.require_cuda(x, sw.bitmap, sw.values)
    bk, bn = sw.block
    kb, nb, _ = sw.bitmap.shape
    m, k = x.shape
    if k > kb * bk:
        raise ValueError(f"x has K={k}, weight holds {kb * bk}")
    if bn > 256:
        raise ValueError(f"sparse_gemv kernel needs bn <= 256, got {bn}")
    rpc = min(bk, ROWS_PER_CTA)
    n_split = kb * (-(-bk // rpc))
    partial = torch.empty((n_split, m, nb * bn), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((m, nb * bn), dtype=x.dtype, device=x.device)
    build.call(_SRC, "sparse_gemv_launch", _ARGS, build.ptr(x),
               build.DTYPE_CODE[x.dtype], m, k, build.ptr(sw.bitmap),
               build.ptr(sw.values), build.DTYPE_CODE[sw.values.dtype], kb,
               nb, bk, bn, sw.capacity, rpc, build.ptr(partial),
               build.ptr(out), build.stream())
    sparse_gemv.launches += 1
    out = out[:, : sw.shape[1]]
    return out if out_dtype in (None, x.dtype) else out.to(out_dtype)


sparse_gemv.launches = 0
