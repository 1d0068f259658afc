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
would not fit shared memory: :func:`launch_rows`; where not even 16 rows
fit beside the ring, past K = 4672, as at Llama-4-Scout's head (5120),
Llama-3-8B's ``w_down`` (14336) or Jamba's Mamba ``w_bcdt`` (16384), x
streams with the table in 64-k panels, 64 rows a launch:
:func:`dense_plan`).  bf16 runs ``mma.sync``
m16n8k16 with x staged once per block (or a panel per stage) as the A
operand (M padded to 16-row m-tiles) and the table rows as the
column-major B operand as they stand; f32 runs f32 FMAs in K order (no
TF32).  A row's result does not depend on M (:func:`dense_plan` sizes
only x's staging, and the MMAs run in the same K order in every layout).
Output is f32; more than 64 rows take one launch per 64 (per
:func:`launch_rows`).

CPU tensors take the plain version; CUDA operands the kernel does not take
(dtype, K or a row stride not a multiple of 8, a pointer not 16-byte
aligned) raise.

Training (:class:`DenseMatmulGrad`) runs the same kernel as its forward,
launch for launch, and computes the backward's two products with
``torch.matmul``: ``dx = dy @ w_nk`` (the weight's rows as they stand) and
``dw_nk = dy.T @ x`` (``[N, K]`` rows, which is the column-major layout of
the ``[K, N]`` parameter).  That is the reference's own split: the JAX
package defines no backward kernel (no ``custom_vjp`` anywhere), and XLA
differentiates ``dense_matmul_pallas``'s caller by transposing its
``jnp.dot`` outside any Pallas kernel.
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
XS_LDX = 64 + 32            # bf16 streamed: a staged x row of one panel
F32_BUCKETS = (1, 2, 4, 8, 16, 32, 48, 64)


class DensePlan(NamedTuple):
    """One launch (at most ``MAX_ROWS`` rows).  ``rows`` is x's staged row
    count: ``m`` padded to 16-row m-tiles (bf16) or to its bucket (f32)."""
    tiles: int              # TILE-row tiles of the table
    rows: int
    smem: int               # dynamic shared memory of a block, bytes
    xstream: bool = False   # bf16: x streamed in K panels, not staged whole


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def dense_plan(m: int, k: int, n: int, w_bytes: int = 2) -> DensePlan:
    """The launch of ``x [m <= 64, k] @ w [n, k].T`` for weights of
    ``w_bytes`` (2: bf16, 4: f32).  The byte count mirrors ``Layout`` in
    ``csrc/dense_matmul.cu``, whose launcher refuses any other.  bf16: x
    staged whole beside the ring where it fits, else x streamed in 64-k
    panels with the ring (``xstream``), which fits at any K (see
    :func:`launch_rows`).  The K order, and so a row's bits, do not depend
    on the layout."""
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"one launch takes 1..{MAX_ROWS} rows, got {m}")
    if w_bytes == 2:
        rows = -(-m // 16) * 16
        # x whole: rows padded to K past a multiple of 64 plus 32, then the
        # ring of 64-k stages
        ldx = -(-k // 64) * 64 + 32
        smem = _align16(rows * ldx * 2) + STAGES * TILE * 64 * 2
        if smem <= SMEM_LIMIT:
            return DensePlan(-(-n // TILE), rows, smem)
        # streamed: a stage is the table's 64 k and x's rows of the same k
        smem = STAGES * (TILE * 64 * 2 + _align16(rows * XS_LDX * 2))
        return DensePlan(-(-n // TILE), rows, smem, True)
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
    shared memory (K past 1088: a dense model's wider linears, ``wo`` and
    ``w_down``), the most 16-row m-tiles that fit; each launch is one pass
    over the weight.  A row's result is the same bits at any of these
    counts.  Where not even 16 rows fit (K past 4672), x streams in K
    panels and a launch takes ``MAX_ROWS`` again.  Never raises for a K
    that is a multiple of 8."""
    if w_bytes != 2 or dense_plan(16, k, TILE, w_bytes).xstream:
        return MAX_ROWS
    rows = MAX_ROWS
    while rows > 16 and dense_plan(rows, k, TILE, w_bytes).xstream:
        rows -= 16
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


def _product(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``a @ b`` in the wider of the two dtypes, cast to ``dtype``: bf16
    operands take cuBLAS's bf16 product, which accumulates in f32; an f32
    operand (the head's f32 logits' gradient) takes the f32 product."""
    ct = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(ct), b.to(ct)).to(dtype)


class DenseMatmulGrad(torch.autograd.Function):
    """``kernel(x, w_nk, out_dtype)`` (the hand kernel, or whatever the ops
    layer routes ``_dense_kernel`` to) under autograd: the forward is the
    kernel's call as it stands; the backward takes ``torch.matmul`` (see
    the module docstring), each gradient in its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w_nk, out_dtype, kernel):
        ctx.save_for_backward(x, w_nk)
        return kernel(x, w_nk, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w_nk = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _product(dy, w_nk, x.dtype)                   # [M, K]
        if ctx.needs_input_grad[1]:
            dw = _product(dy.t(), x, w_nk.dtype)               # [N, K]
        return dx, dw, None, None
