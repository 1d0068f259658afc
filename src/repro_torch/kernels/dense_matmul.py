"""Dense product against a weight stored as rows: ``x [M, K] @ w_nk.T``.

Replaces ``repro/kernels/dense_matmul.py:dense_matmul_pallas`` on the
serving path, where it is the tied unembedding (``logits = h @ tok.T``).
Bound on the H100: device-memory bytes — the table (151936 x 1024 bf16,
311 MB) read once per call, ~93 us at 3.35 TB/s, at every serving M (1,
the slots, the verify panels of 16-36 rows).

Design (``csrc/dense_matmul.cu``): one persistent block per SM streams its
128-row tiles of ``w_nk`` through a ring of shared-memory stages filled by
16-byte ``cp.async`` copies, reading ``tok`` in place through its ``[N, K]``
row layout (no ``tok.T`` copy exists anywhere), so the table is read once
per call at every M up to 64 (fewer rows a pass where a wide K's x
would not fit shared memory: :func:`launch_rows`).  bf16 runs ``mma.sync`` m16n8k16 with x
staged once per block as the A operand (M padded to 16-row m-tiles) and
the table rows as the column-major B operand as they stand; f32 runs f32
FMAs in K order (no TF32).  A row's result does not depend on M
(:func:`dense_plan` sizes only x's staging).  Output is f32; more than 64
rows take one launch per 64 (per :func:`launch_rows`).

CPU tensors take the plain version; CUDA operands the kernel does not take
(dtype, K or a row stride not a multiple of 8, a pointer not 16-byte
aligned) raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

_SRC = "dense_matmul.cu"
_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_long,
         ctypes.c_void_p, ctypes.c_void_p]
MAX_ROWS = 64               # rows of x one launch (one pass) takes
SMEM_LIMIT = 232448         # bytes of shared memory a Hopper block may use
TILE = 128                  # table rows a block streams at a time
STAGES = 5                  # ring depth of the stream
F32_BUCKETS = (1, 2, 4, 8, 16, 32, 48, 64)


class DensePlan(NamedTuple):
    """One launch (at most ``MAX_ROWS`` rows).  ``rows`` is x's staged row
    count: ``m`` padded to 16-row m-tiles (bf16) or to its bucket (f32)."""
    tiles: int              # TILE-row tiles of the table
    rows: int
    smem: int               # dynamic shared memory of a block, bytes


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def dense_plan(m: int, k: int, n: int, w_bytes: int = 2) -> DensePlan:
    """The launch of ``x [m <= 64, k] @ w [n, k].T`` for weights of
    ``w_bytes`` (2: bf16, 4: f32).  The byte count mirrors ``Layout`` in
    ``csrc/dense_matmul.cu``, whose launcher refuses any other."""
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"one launch takes 1..{MAX_ROWS} rows, got {m}")
    if w_bytes == 2:
        # x once, rows padded to m-tiles and K to 64 + 32; a stage is 64 k
        rows = -(-m // 16) * 16
        ldx = -(-k // 64) * 64 + 32
        smem = _align16(rows * ldx * 2) + STAGES * TILE * 64 * 2
    elif w_bytes == 4:
        # a stage is 32 k of the tile's rows (padded by 4) and of x's rows
        rows = next(b for b in F32_BUCKETS if b >= m)
        smem = STAGES * (TILE * 36 * 4 + rows * 32 * 4)
    else:
        raise ValueError(f"dense_matmul takes bf16 or f32, got {w_bytes} "
                         f"bytes")
    return DensePlan(-(-n // TILE), rows, smem)


@functools.lru_cache(maxsize=None)
def launch_rows(k: int, w_bytes: int = 2) -> int:
    """Rows of x one launch takes at inner dimension ``k``: ``MAX_ROWS``,
    or, where bf16 x staged whole for 64 rows would overflow a block's
    shared memory (K past 1120: a dense model's wider linears, ``wo`` and
    ``w_down``), the most 16-row m-tiles that fit; each launch is one pass
    over the weight.  A row's result is the same bits at any of these
    counts.  Raises where not even 16 rows fit."""
    rows = MAX_ROWS
    while dense_plan(rows, k, TILE, w_bytes).smem > SMEM_LIMIT:
        rows -= 16
        if rows <= 0:
            raise ValueError(f"dense_matmul kernel: x rows of K={k} do not "
                             f"fit a block's shared memory")
    return rows


def dense_matmul_plain(x: torch.Tensor, w_nk: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """Plain version (twin of ``kernels/ref.py:dense_matmul_ref`` with the
    weight given as rows): f32-accumulated ``x @ w_nk.T``."""
    out = x.to(torch.float32) @ w_nk.to(torch.float32).t()
    return out.to(out_dtype or x.dtype)


def dense_matmul(x: torch.Tensor, w_nk: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """``x [M, K] @ w_nk.T`` for ``w_nk [N, K]`` with unit column stride;
    CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return dense_matmul_plain(x, w_nk, out_dtype)
    if x.dtype != w_nk.dtype or x.dtype not in build.DTYPE_CODE:
        raise TypeError(f"dense_matmul kernel takes matching f32/bf16, got "
                        f"{x.dtype} / {w_nk.dtype}")
    if w_nk.stride(1) != 1:
        raise ValueError("dense_matmul reads the weight as [N, K] rows with "
                         "unit column stride (pass tok, not a copy of tok.T)")
    x = x.contiguous()
    build.require_cuda(x)
    if w_nk.device != x.device:
        raise ValueError(f"weight on {w_nk.device}, x on {x.device}")
    m, k = x.shape
    n, k2 = w_nk.shape
    if k != k2:
        raise ValueError(f"inner dims disagree: x has K={k}, w has K={k2}")
    if k % 8 or w_nk.stride(0) % 8 or w_nk.data_ptr() % 16 \
            or x.data_ptr() % 16:
        raise ValueError("dense_matmul kernel needs K and the weight's row "
                         "stride multiples of 8 and 16-byte aligned x and "
                         "weight (16-byte copies)")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    step = launch_rows(k, x.element_size())
    for r0 in range(0, m, step):
        rows = min(step, m - r0)
        p = dense_plan(rows, k, n, x.element_size())
        build.call(_SRC, "dense_matmul_launch", _ARGS, build.ptr(x[r0:]),
                   build.DTYPE_CODE[x.dtype], rows, k, build.ptr(w_nk), n,
                   w_nk.stride(0), p.smem, build.ptr(out[r0:]),
                   build.stream())
        dense_matmul.launches += 1
    out_dtype = out_dtype or x.dtype
    return out if out_dtype == torch.float32 else out.to(out_dtype)


dense_matmul.launches = 0
