"""Sparse GEMV for at most 8 rows: the decode-tick linears.

Replaces ``repro/kernels/sparse_gemv.py:sparse_gemv_pallas`` with the CUDA
kernel in ``csrc/sparse_gemv.cu``.  Bound on the H100: device-memory bytes
(bitmap + packed values + x + y over 3.35 TB/s; 5.34 us for a Qwen3-0.6B
layer), since M <= 8 rows do at most 16 flops per stored weight.

Design: the reduction over K is split across thread blocks, one per
(column block, split), a split being ``ROWS_PER_SPLIT`` rows of one
compressed block (:func:`gemv_plan`), so every Qwen3-0.6B linear launches
128-384 blocks.  Each block stages its slice's bitmap words and packed
values with 16-byte loads, expands them from shared memory against its x
columns (staged once, as f32), with the row count bucketed at compile time
(1, 2, 4 or 8), and writes an f32 partial; the last block of each column
block, told by a ticket counter it resets, sums the partials in split order
and rounds once.  One launch a linear: the partial scratch and the tickets
are allocated once per device, sized for the largest plan met so far.  The
plan depends on (K, N, block) and the dtypes, never on M, so a row's
result is the same bits in a call of any M <= 8.

Output is in the dtype of x (bf16 on the serving path, f32 in f32
configs); CPU tensors take the plain version, other CUDA dtypes raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.sparse_format import BlockSparseWeight
from . import build
from .sparse_matmul import sparse_matmul_plain

_SRC = "sparse_gemv.cu"
_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
          ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8
         + [ctypes.c_long] + [ctypes.c_void_p] * 4)
MAX_ROWS = 8
THREADS = 256
# K rows of one compressed block per thread block (csrc/sparse_gemv.cu's
# note gives the traces that chose 64 over 32)
ROWS_PER_SPLIT = 64


class GemvPlan(NamedTuple):
    """One call's launch.  Every field is a function of (K, N, block) and
    the dtypes alone; M sizes only the part of the scratch a call uses."""
    kb: int                 # compressed block rows
    nb: int                 # compressed block columns (tickets)
    rows_per_split: int
    # (block row, first row, end row) of each split, in summation order
    splits: Tuple[Tuple[int, int, int], ...]
    blocks: int             # thread blocks of the launch
    smem: int               # dynamic shared memory of one of them, bytes
    scratch: int            # f32 partials at the largest M, elements


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def gemv_plan(k: int, n: int, block, x_bytes: int = 2,
              v_bytes: int = 2) -> GemvPlan:
    """The launch of ``x [M <= 8, k] @ W [k, n]`` stored in ``block``
    blocks, for activations of ``x_bytes`` (staged as f32 whatever their
    width) and values of ``v_bytes``.  The shared-memory count mirrors
    ``Layout`` in ``csrc/sparse_gemv.cu``, whose launcher refuses any
    other."""
    if x_bytes not in (2, 4) or v_bytes not in (2, 4):
        raise ValueError(f"gemv takes 2- or 4-byte x and values, got "
                         f"{x_bytes} / {v_bytes}")
    bk, bn = block
    kb, nb = -(-k // bk), -(-n // bn)
    rps = min(bk, ROWS_PER_SPLIT)
    splits = tuple((b, r, min(r + rps, bk)) for b in range(kb)
                   for r in range(0, bk, rps))
    nw = rps * bn // 32
    off = _align16(8 * nw + 33 * 4)
    off = _align16(off + rps * bn * v_bytes + 32)
    off = _align16(off + MAX_ROWS * rps * 4)
    smem = off + THREADS * MAX_ROWS * 16
    return GemvPlan(kb, nb, rps, splits, nb * len(splits), smem,
                    len(splits) * MAX_ROWS * nb * bn)


# per device: the f32 partials and the int32 ticket counters (zero between
# launches: each launch's last block per column block resets its own);
# grown, never shrunk, and never while a CUDA graph is captured
_SCRATCH: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, n_partial: int, n_tickets: int):
    key = str(device)
    part, tickets = _SCRATCH.get(key, (None, None))
    grow_part = part is None or part.numel() < n_partial
    grow_tickets = tickets is None or tickets.numel() < n_tickets
    if grow_part or grow_tickets:
        build.refuse_growth_under_capture("the gemv's scratch")
    if grow_part:
        part = torch.empty(max(n_partial, 1 << 20), dtype=torch.float32,
                           device=device)
    if grow_tickets:
        tickets = torch.zeros(max(n_tickets, 256), dtype=torch.int32,
                              device=device)
    _SCRATCH[key] = (part, tickets)
    return part, tickets


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
    if bk % 16 or bn % 16 or bn > THREADS:
        raise ValueError(f"sparse_gemv kernel needs 16-aligned blocks with "
                         f"bn <= {THREADS}, got {sw.block}")
    p = gemv_plan(kb * bk, nb * bn, tuple(sw.block), x.element_size(),
                  sw.values.element_size())
    partial, tickets = _scratch(x.device, p.scratch, nb)
    out = torch.empty((m, nb * bn), dtype=x.dtype, device=x.device)
    build.call(_SRC, "sparse_gemv_launch", _ARGS, build.ptr(x),
               build.DTYPE_CODE[x.dtype], m, k, build.ptr(sw.bitmap),
               build.ptr(sw.values), build.DTYPE_CODE[sw.values.dtype], kb,
               nb, bk, bn, sw.capacity, p.rows_per_split, len(p.splits),
               p.smem, build.ptr(partial), build.ptr(tickets),
               build.ptr(out), build.stream())
    sparse_gemv.launches += 1
    out = out[:, : sw.shape[1]]
    return out if out_dtype in (None, x.dtype) else out.to(out_dtype)


sparse_gemv.launches = 0
