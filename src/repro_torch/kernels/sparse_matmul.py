"""Sparse GEMM for more than 8 rows: ``x [M, K] @ unpack(sw)``.

Replaces ``repro/kernels/sparse_matmul.py:sparse_matmul_pallas`` with the
CUDA kernels in ``csrc/sparse_matmul.cu``.  Bound on the H100: bytes at a
20-row verify panel (about 5.6 us for a Qwen3-0.6B layer), bytes and bf16
tensor-core time of one order at a 256-row prefill chunk (near the ridge),
f32 FMA operations for f32 activations at 256 rows.

Design: the reduction over K is split across thread blocks, one per
(column block, split), a split being ``ROWS_PER_SPLIT`` rows of one
compressed block, so every Qwen3-0.6B linear launches 128-384 blocks at
any M.  Each block stages its slice's bitmap words and packed values with
16-byte loads, expands the slice once (bf16: into the ``mma.sync`` B
fragments each warp keeps in registers; f32: into an f32 shared-memory
tile) and reuses it for every 16-row tile of x, whose 64-row chunks are
double-buffered with ``cp.async``.  Each block writes an f32 partial; a
second kernel sums the partials in split order and rounds once.  The plan
(:func:`launch_plan`) depends on (K, N, block) and the dtypes, never on M,
so a row's result is the same bits in a call of any M.  f32 activations
take the second kernel of the source (f32 FMAs in K order within a split,
no TF32).

The kernels take bf16 activations with bf16 values, or f32 activations
with f32 or bf16 values; CPU tensors take the plain version, other CUDA
dtypes raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_format import BlockSparseWeight, unpack_padded
from . import build

_SRC = "sparse_matmul.cu"
_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_F32_ARGS = _ARGS[:5] + [ctypes.c_int] + _ARGS[5:]

ROWS_PER_SPLIT = 64         # K rows of one compressed block per thread block
M_CHUNK = 64                # x rows staged per pass of a block's M loop


class Plan(NamedTuple):
    """One call's launch.  Every field is a function of (K, N, block) and
    the dtypes alone; M sizes only the scratch (``splits x M x N`` f32)."""
    kb: int                 # compressed block rows
    nb: int                 # compressed block columns
    rows_per_split: int
    # (block row, first row, end row) of each split, in summation order
    splits: Tuple[Tuple[int, int, int], ...]
    blocks: int             # thread blocks of the partial kernel
    smem: int               # dynamic shared memory of one of them, bytes


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def launch_plan(k: int, n: int, block, x_bytes: int = 2,
                v_bytes: int = 2) -> Plan:
    """The launch of ``x [M, k] @ W [k, n]`` stored in ``block`` blocks,
    for activations of ``x_bytes`` (2: the bf16 kernel, 4: the f32 kernel)
    and values of ``v_bytes``.  The shared-memory count mirrors ``Layout``
    in ``csrc/sparse_matmul.cu``, whose launchers refuse any other."""
    bk, bn = block
    kb, nb = -(-k // bk), -(-n // bn)
    rps = min(bk, ROWS_PER_SPLIT)
    splits = tuple((b, r, min(r + rps, bk)) for b in range(kb)
                   for r in range(0, bk, rps))
    nw = rps * bn // 32
    ldx = rps + 16 // x_bytes
    off = _align16(8 * nw + 128)
    off = _align16(off + (rps * bn + 16) * v_bytes)
    off = _align16(off + 2 * M_CHUNK * ldx * x_bytes)
    smem = off + (rps * bn * 4 if x_bytes == 4 else 0)
    return Plan(kb, nb, rps, splits, nb * len(splits), smem)


def sparse_matmul_plain(x: torch.Tensor, sw: BlockSparseWeight,
                        out_dtype=None) -> torch.Tensor:
    """Plain version (twin of ``kernels/ref.py:sparse_matmul_ref``):
    decompress, then one f32-accumulated product."""
    w = unpack_padded(sw)
    kp = w.shape[0]
    xp = F.pad(x, (0, max(kp - x.shape[1], 0)))[:, :kp]
    out = xp.to(torch.float32) @ w.to(torch.float32)
    n = min(sw.shape[1], w.shape[1])
    return out[:, :n].to(out_dtype or x.dtype)


def _launch(entry, argtypes, x, sw, out_dtype, v_code=()):
    """Check the operands, allocate the scratch and the output, launch the
    partial kernel and the sum; returns ``out`` cut to N and cast."""
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
    p = launch_plan(kb * bk, nb * bn, tuple(sw.block), x.element_size(),
                    sw.values.element_size())
    partial = torch.empty((len(p.splits), m, nb * bn), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((m, nb * bn), dtype=x.dtype, device=x.device)
    build.call(_SRC, entry, argtypes, build.ptr(x), m, k,
               build.ptr(sw.bitmap), build.ptr(sw.values), *v_code, kb, nb,
               bk, bn, sw.capacity, p.rows_per_split, p.smem,
               build.ptr(partial), build.ptr(out), build.stream())
    out = out[:, : sw.shape[1]]
    return out if out_dtype in (None, x.dtype) else out.to(out_dtype)


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
    out = _launch("sparse_matmul_launch", _ARGS, x, sw, out_dtype)
    sparse_matmul.launches += 1
    return out


def sparse_matmul_f32(x: torch.Tensor, sw: BlockSparseWeight,
                      out_dtype=None) -> torch.Tensor:
    """``x [M, K] @ unpack(sw)`` for f32 activations (f32 or bf16 values),
    summed with f32 FMAs; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return sparse_matmul_plain(x, sw, out_dtype)
    if not (x.dtype == torch.float32 and sw.values.dtype in build.DTYPE_CODE):
        raise TypeError(f"sparse_matmul_f32 kernel takes f32 x with f32/bf16 "
                        f"values, got {x.dtype} / {sw.values.dtype}")
    out = _launch("sparse_matmul_f32_launch", _F32_ARGS, x, sw, out_dtype,
                  (build.DTYPE_CODE[sw.values.dtype],))
    sparse_matmul_f32.launches += 1
    return out


sparse_matmul.launches = 0
sparse_matmul_f32.launches = 0
