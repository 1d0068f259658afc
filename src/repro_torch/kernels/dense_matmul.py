"""Dense product against a weight stored as rows: ``x [M, K] @ w_nk.T``.

Replaces ``repro/kernels/dense_matmul.py:dense_matmul_pallas`` on the
serving path, where it is the tied unembedding (``logits = h @ tok.T``).
Bound on the H100: device-memory bytes — at M = slots the table
(151936 x 1024 bf16, 311 MB) is read once per call, ~93 us at 3.35 TB/s.
The design reads ``tok`` in place through its ``[N, K]`` row layout (no
``tok.T`` copy exists anywhere: zero extra memory), one warp per output
column, f32 accumulation and f32 output.

CPU tensors take the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_SRC = "dense_matmul.cu"
_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_void_p]


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
    if k % 2 or w_nk.stride(0) % 2 or w_nk.data_ptr() % (2 * x.element_size()):
        raise ValueError("dense_matmul kernel needs an even K, an even row "
                         "stride and pair-aligned rows (paired loads)")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    build.call(_SRC, "dense_matmul_launch", _ARGS, build.ptr(x),
               build.DTYPE_CODE[x.dtype], m, k, build.ptr(w_nk), n,
               w_nk.stride(0), build.ptr(out), build.stream())
    dense_matmul.launches += 1
    out_dtype = out_dtype or x.dtype
    return out if out_dtype == torch.float32 else out.to(out_dtype)


dense_matmul.launches = 0
