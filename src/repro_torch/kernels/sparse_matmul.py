"""Sparse GEMM for more than 8 rows: ``x [M, K] @ unpack(sw)``.

Replaces ``repro/kernels/sparse_matmul.py:sparse_matmul_pallas`` with the
CUDA kernel in ``csrc/sparse_matmul.cu``.  Bound on the H100: at a 256-row
prefill chunk about 240 flop per stored byte, near the bf16 ridge, so bytes
and tensor-core time are of one order; this first version is limited by
its in-shared-memory expansion (see the source note).  The design expands
each compressed (bk, bn) block into a bf16 shared-memory tile and runs
bf16 WMMA fragments with f32 accumulation, one thread block per 64 x bn
output tile looping over K.  f32 activations (an engine served at f32:
its prefill chunks and wide verify panels) take a second kernel of the
same source that expands into an f32 tile and sums with f32 FMAs.

The kernels take bf16 activations with bf16 values, or f32 activations
with f32 or bf16 values; CPU tensors take the plain version, other CUDA
dtypes raise.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_format import BlockSparseWeight, unpack
from . import build

_SRC = "sparse_matmul.cu"
_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_F32_ARGS = _ARGS[:5] + [ctypes.c_int] + _ARGS[5:]


def sparse_matmul_plain(x: torch.Tensor, sw: BlockSparseWeight,
                        out_dtype=None) -> torch.Tensor:
    """Plain version (twin of ``kernels/ref.py:sparse_matmul_ref``):
    decompress, then one f32-accumulated product."""
    w = unpack(sw, trim=False)
    kp = w.shape[0]
    xp = F.pad(x, (0, max(kp - x.shape[1], 0)))[:, :kp]
    out = xp.to(torch.float32) @ w.to(torch.float32)
    n = min(sw.shape[1], w.shape[1])
    return out[:, :n].to(out_dtype or x.dtype)


def _dims(x: torch.Tensor, sw: BlockSparseWeight):
    """The launch geometry, after the checks both kernels share."""
    if sw.bitmap.dim() != 3:
        raise ValueError("sparse_matmul takes one (un-stacked) weight")
    build.require_cuda(x, sw.bitmap, sw.values)
    bk, bn = sw.block
    kb, nb, _ = sw.bitmap.shape
    m, k = x.shape
    if k > kb * bk:
        raise ValueError(f"x has K={k}, weight holds {kb * bk}")
    if bk % 16 or bn % 16 or bn > 128:
        raise ValueError(f"sparse_matmul kernel needs 16-aligned blocks with "
                         f"bn <= 128, got {sw.block}")
    return m, k, kb, nb, bk, bn


def sparse_matmul(x: torch.Tensor, sw: BlockSparseWeight,
                  out_dtype=None) -> torch.Tensor:
    """``x [M, K] @ unpack(sw)``; CPU tensors take the plain version, f32
    activations ``sparse_matmul_f32``."""
    if x.device.type == "cpu":
        return sparse_matmul_plain(x, sw, out_dtype)
    if x.dtype == torch.float32:
        return sparse_matmul_f32(x, sw, out_dtype)
    if not (x.dtype == torch.bfloat16 and sw.values.dtype == torch.bfloat16):
        raise TypeError(f"sparse_matmul kernel takes bf16 x with bf16 "
                        f"values or f32 x with f32/bf16 values, got "
                        f"{x.dtype} / {sw.values.dtype}")
    x = x.contiguous()
    m, k, kb, nb, bk, bn = _dims(x, sw)
    out = torch.empty((m, nb * bn), dtype=x.dtype, device=x.device)
    build.call(_SRC, "sparse_matmul_launch", _ARGS, build.ptr(x), m, k,
               build.ptr(sw.bitmap), build.ptr(sw.values), kb, nb, bk, bn,
               sw.capacity, build.ptr(out), build.stream())
    sparse_matmul.launches += 1
    out = out[:, : sw.shape[1]]
    return out if out_dtype in (None, x.dtype) else out.to(out_dtype)


def sparse_matmul_f32(x: torch.Tensor, sw: BlockSparseWeight,
                      out_dtype=None) -> torch.Tensor:
    """``x [M, K] @ unpack(sw)`` for f32 activations (f32 or bf16 values),
    summed with f32 FMAs; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return sparse_matmul_plain(x, sw, out_dtype)
    if not (x.dtype == torch.float32 and sw.values.dtype in build.DTYPE_CODE):
        raise TypeError(f"sparse_matmul_f32 kernel takes f32 x with f32/bf16 "
                        f"values, got {x.dtype} / {sw.values.dtype}")
    x = x.contiguous()
    m, k, kb, nb, bk, bn = _dims(x, sw)
    out = torch.empty((m, nb * bn), dtype=x.dtype, device=x.device)
    build.call(_SRC, "sparse_matmul_f32_launch", _F32_ARGS, build.ptr(x), m,
               k, build.ptr(sw.bitmap), build.ptr(sw.values),
               build.DTYPE_CODE[sw.values.dtype], kb, nb, bk, bn,
               sw.capacity, build.ptr(out), build.stream())
    sparse_matmul_f32.launches += 1
    out = out[:, : sw.shape[1]]
    return out if out_dtype in (None, x.dtype) else out.to(out_dtype)


sparse_matmul.launches = 0
sparse_matmul_f32.launches = 0
