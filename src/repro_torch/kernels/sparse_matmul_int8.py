"""Sparse int8 GEMM: ``dequant(xq, sx) @ dequant(sw)`` for every row count.

Replaces ``repro/kernels/sparse_matmul_int8.py:sparse_matmul_int8_pallas``
with the CUDA kernel in ``csrc/sparse_matmul_int8.cu`` (whose other
instantiation serves the int4 weights of :mod:`.sparse_matmul_int4`).
Bound on the H100: device-memory bytes (one byte per stored weight plus
its bitmap bit; the int8 tensor-core ridge is ~590 op/byte).  The design
expands each compressed block into an int8 shared-memory tile, multiplies
with ``__dp4a`` into int32, adds the K blocks' partial sums with integer
atomics (exact in any order) and applies the reference's epilogue
``(float(acc) * sx[m]) * scale[n]`` in a second kernel, so kernel and
plain version agree bit for bit.

The activations arrive quantised (``core/quant.quantize_act_int8``, plain
PyTorch in ``ops``), as the TPU kernel takes them.  CPU tensors take the
plain version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_format import BlockSparseWeight, unpack
from . import build

_SRC = "sparse_matmul_int8.cu"
_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
          ctypes.c_void_p] + [ctypes.c_int] * 7
         + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def _check_int_weight(sw: BlockSparseWeight) -> None:
    if not ((sw.values.dtype == torch.int8 or sw.packed4)
            and sw.scale is not None):
        raise ValueError("int path needs int8/int4 values and a scale")


def sparse_matmul_int8_plain(xq: torch.Tensor, sx: torch.Tensor,
                             sw: BlockSparseWeight,
                             out_dtype=torch.float32) -> torch.Tensor:
    """Plain version (twin of ``kernels/ref.py:sparse_matmul_int8_ref``
    from the quantised activations on); int8 and nibble-packed int4 alike.

    The integer product must be exact.  The CPU sums in int64.  CUDA has no
    general integer matmul, and an f32 sum is not exact here (127 * 127 *
    3072 > 2**24), so on the card the sum runs in float64, exact below
    2**53; either way the f32 epilogue then sees the exact int32 sum."""
    _check_int_weight(sw)
    w = unpack(sw, trim=False)                        # int8, padded
    kp = w.shape[0]
    xq = F.pad(xq, (0, max(kp - xq.shape[1], 0)))[:, :kp]
    wide = torch.int64 if xq.device.type == "cpu" else torch.float64
    acc = (xq.to(wide) @ w.to(wide)).to(torch.float32)
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
    if bk % 8 or bn < 8 or 256 % bn:
        raise ValueError(f"int kernels need bk % 8 == 0 and bn dividing "
                         f"256, got {sw.block}")
    acc = torch.empty((m, nb * bn), dtype=torch.int32, device=xq.device)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    build.call(_SRC, "sparse_matmul_int_launch", _ARGS, build.ptr(xq), m, k,
               build.ptr(sw.bitmap), build.ptr(sw.values), int(int4), kb,
               nb, bk, bn, sw.capacity, sw.values.shape[-1], build.ptr(sx),
               build.ptr(sw.scale), n, build.ptr(acc), build.ptr(out),
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
