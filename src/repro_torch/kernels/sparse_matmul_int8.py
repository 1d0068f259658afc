"""Sparse int8 GEMM: ``dequant(xq, sx) @ dequant(sw)`` for every row count.

Replaces ``repro/kernels/sparse_matmul_int8.py:sparse_matmul_int8_pallas``
with the CUDA kernel in ``csrc/sparse_matmul_int8.cu`` (whose other
instantiation serves the int4 weights of :mod:`.sparse_matmul_int4`).
Bound on the H100: device-memory bytes at every row count the serving
paths use (one byte per stored weight plus its bitmap bits; the int8
tensor-core ridge is ~590 op/byte): 2.99 us for the seven linears of a
Qwen3-0.6B layer at M = 4.

Design: the reduction over K is split across thread blocks, one per
(column block, split), a split being 64 rows of one compressed block, so
every Qwen3-0.6B linear launches 128-384 blocks at any M (M is a loop
inside the block).  Each block stages its slice's bitmap words and packed
bytes with 16-byte loads, expands the slice once into the ``mma.sync``
m16n8k32 s8 B fragments each warp keeps in registers, and multiplies
every 16-row tile of x on the int8 tensor cores into int32, the 64-row x
chunks double-buffered with ``cp.async``.  Each
block writes an int32 partial; a second kernel sums the partials (exact
in any order) and applies the reference's epilogue
``(float(acc) * sx[m]) * scale[n]`` in that order with one rounding, so
kernel and plain version agree bit for bit.  The plan
(:func:`int_launch_plan`) is a function of (K, N, block) and the value
width alone.

The activations arrive quantised (``core/quant.quantize_act_int8``, plain
PyTorch in ``ops``), as the TPU kernel takes them.  CPU tensors take the
plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_format import BlockSparseWeight, unpack_padded
from . import build
from .sparse_matmul import M_CHUNK, Plan, _align16, launch_plan

_SRC = "sparse_matmul_int8.cu"
_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
          ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_long]
         + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def int_launch_plan(k: int, n: int, block, int4: bool) -> Plan:
    """The launch of ``xq [M, k] @ W [k, n]`` stored in ``block`` blocks of
    int8 (``int4=False``) or nibble-packed int4 values: the K split of the
    bf16 kernel's :func:`launch_plan`, with the shared-memory count of
    ``Layout`` in ``csrc/sparse_matmul_int8.cu``, whose launcher refuses
    any other; M sizes only the scratch (``splits x M x N`` int32)."""
    p = launch_plan(k, n, block)
    rps, bn = p.rows_per_split, block[1]
    off = _align16(8 * (rps * bn // 32) + 128)
    off = _align16(off + rps * bn // (2 if int4 else 1) + 32)
    return p._replace(smem=off + 2 * M_CHUNK * (rps + 16))


def _check_int_weight(sw: BlockSparseWeight) -> None:
    if not ((sw.values.dtype == torch.int8 or sw.packed4)
            and sw.scale is not None):
        raise ValueError("int path needs int8/int4 values and a scale")


def sparse_matmul_int8_plain(xq: torch.Tensor, sx: torch.Tensor,
                             sw: BlockSparseWeight,
                             out_dtype=torch.float32) -> torch.Tensor:
    """Plain version (twin of ``kernels/ref.py:sparse_matmul_int8_ref``
    from the quantised activations on); int8 and nibble-packed int4 alike.

    The integer product must be exact.  Torch has no fast general integer
    matmul, and an f32 sum is not exact here (127 * 127 * 3072 > 2**24), so
    the sum runs in float64, exact below 2**53 in any order: the f32
    epilogue sees the exact int32 sum."""
    _check_int_weight(sw)
    w = unpack_padded(sw)                             # int8, padded
    kp = w.shape[0]
    xq = F.pad(xq, (0, max(kp - xq.shape[1], 0)))[:, :kp]
    acc = (xq.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)
    out = acc * sx.to(torch.float32)[:, None] * sw.scale[None, : w.shape[1]]
    n = min(sw.shape[1], w.shape[1])
    return out[:, :n].to(out_dtype)


def launch_int(xq: torch.Tensor, sx: torch.Tensor, sw: BlockSparseWeight,
               out_dtype, int4: bool) -> torch.Tensor:
    """Launch the int8 (``int4=False``) or int4 instantiation on CUDA
    tensors; checks every operand first."""
    _check_int_weight(sw)
    if sw.packed4 != int4:
        raise ValueError(f"{'int4' if int4 else 'int8'} kernel got a "
                         f"{'nibble-packed' if sw.packed4 else 'int8'} "
                         "weight")
    if xq.dtype != torch.int8 or sx.dtype != torch.float32 \
            or sw.scale.dtype != torch.float32:
        raise TypeError(f"int kernels take int8 xq and f32 scales, got "
                        f"{xq.dtype} / {sx.dtype} / {sw.scale.dtype}")
    if out_dtype not in build.DTYPE_CODE:
        raise TypeError(f"int kernels write f32 or bf16, not {out_dtype}")
    if sw.bitmap.dim() != 3:
        raise ValueError("int kernels take one (un-stacked) weight")
    xq, sx = xq.contiguous(), sx.contiguous()
    build.require_cuda(xq, sx, sw.bitmap, sw.values, sw.scale)
    bk, bn = sw.block
    kb, nb, _ = sw.bitmap.shape
    m, k = xq.shape
    n = sw.shape[1]
    if k > kb * bk or sx.shape != (m,):
        raise ValueError(f"xq {tuple(xq.shape)} / sx {tuple(sx.shape)} do "
                         f"not fit a weight of {kb * bk} rows")
    if bk % 32 or bn % 16 or bn > 128:
        raise ValueError(f"int kernels need bk % 32 == 0 and bn a multiple "
                         f"of 16 up to 128, got {sw.block}")
    p = int_launch_plan(kb * bk, nb * bn, tuple(sw.block), int4)
    partial = torch.empty((len(p.splits), m, nb * bn), dtype=torch.int32,
                          device=xq.device)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    build.call(_SRC, "sparse_matmul_int_launch", _ARGS, build.ptr(xq), m, k,
               build.ptr(sw.bitmap), build.ptr(sw.values), int(int4), kb,
               nb, bk, bn, sw.capacity, sw.values.shape[-1],
               p.rows_per_split, p.smem, build.ptr(sx), build.ptr(sw.scale),
               n, build.ptr(partial), build.ptr(out),
               build.DTYPE_CODE[out_dtype], build.stream())
    return out


def sparse_matmul_int8(xq: torch.Tensor, sx: torch.Tensor,
                       sw: BlockSparseWeight,
                       out_dtype=torch.float32) -> torch.Tensor:
    """``dequant(xq [M, K] int8, sx [M] f32) @ dequant(sw)`` for int8
    values; CPU tensors take the plain version."""
    if xq.device.type == "cpu":
        return sparse_matmul_int8_plain(xq, sx, sw, out_dtype)
    out = launch_int(xq, sx, sw, out_dtype, int4=False)
    sparse_matmul_int8.launches += 1
    return out


sparse_matmul_int8.launches = 0
