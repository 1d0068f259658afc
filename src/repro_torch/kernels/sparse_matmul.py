"""Sparse GEMM for more than 8 rows: ``x [M, K] @ unpack(sw)``.

Replaces ``repro/kernels/sparse_matmul.py:sparse_matmul_pallas`` with the
CUDA kernel in ``csrc/sparse_matmul.cu``.  Bound on the H100: at a 256-row
prefill chunk about 240 flop per stored byte, near the bf16 ridge, so bytes
and tensor-core time are of one order; this first version is limited by
its in-shared-memory expansion (see the source note).  The design expands
each compressed (bk, bn) block into a bf16 shared-memory tile and runs
bf16 WMMA fragments with f32 accumulation, one thread block per 64 x bn
output tile looping over K.

The kernel takes bf16 activations and bf16 values; CPU tensors take the
plain version, other CUDA dtypes raise.
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


def sparse_matmul(x: torch.Tensor, sw: BlockSparseWeight,
                  out_dtype=None) -> torch.Tensor:
    """``x [M, K] @ unpack(sw)``; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return sparse_matmul_plain(x, sw, out_dtype)
    if x.dtype != torch.bfloat16 or sw.values.dtype != torch.bfloat16:
        raise TypeError(f"sparse_matmul kernel takes bf16 x and values, got "
                        f"{x.dtype} / {sw.values.dtype}")
    if sw.bitmap.dim() != 3:
        raise ValueError("sparse_matmul takes one (un-stacked) weight")
    x = x.contiguous()
    build.require_cuda(x, sw.bitmap, sw.values)
    bk, bn = sw.block
    kb, nb, _ = sw.bitmap.shape
    m, k = x.shape
    if k > kb * bk:
        raise ValueError(f"x has K={k}, weight holds {kb * bk}")
    if bk % 16 or bn % 16 or bn > 128:
        raise ValueError(f"sparse_matmul kernel needs 16-aligned blocks with "
                         f"bn <= 128, got {sw.block}")
    out = torch.empty((m, nb * bn), dtype=torch.bfloat16, device=x.device)
    build.call(_SRC, "sparse_matmul_launch", _ARGS, build.ptr(x), m, k,
               build.ptr(sw.bitmap), build.ptr(sw.values), kb, nb, bk, bn,
               sw.capacity, build.ptr(out), build.stream())
    sparse_matmul.launches += 1
    out = out[:, : sw.shape[1]]
    return out if out_dtype in (None, torch.bfloat16) else out.to(out_dtype)


sparse_matmul.launches = 0
