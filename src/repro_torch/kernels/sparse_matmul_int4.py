"""Sparse int4 GEMM: ``dequant(xq, sx) @ dequant4(sw)`` for every row count.

Replaces ``repro/kernels/sparse_matmul_int4.py:sparse_matmul_int4_pallas``
with the int4 instantiation of ``csrc/sparse_matmul_int8.cu``: the kernel
of :mod:`.sparse_matmul_int8` (a K-split grid of 128-384 thread blocks,
each slice staged with 16-byte loads and expanded once into ``mma.sync``
m16n8k32 s8 B fragments, int32 partials summed by the epilogue kernel),
whose expansion reads the value at rank ``r`` from byte ``r >> 1`` (low
nibble when ``r`` is even, whatever the parity of the slice's first rank)
and sign-extends it by ``(x ^ 8) - 8`` — the paper's "dequantise int4 to
int8 before computation".  Bound on the H100: device-memory bytes, half a
byte per stored weight plus its bitmap bits: 1.82 us for the seven
linears of a Qwen3-0.6B layer at M = 4.  The plan is
``int_launch_plan(..., int4=True)``.

CPU tensors take the plain version (the int8 one: ``unpack`` already
expands the nibbles).
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_format import BlockSparseWeight
from .sparse_matmul_int8 import launch_int, sparse_matmul_int8_plain


def sparse_matmul_int4_plain(xq: torch.Tensor, sx: torch.Tensor,
                             sw: BlockSparseWeight,
                             out_dtype=torch.float32) -> torch.Tensor:
    """Plain version (twin of ``kernels/ref.py:sparse_matmul_int8_ref`` on
    nibble-packed values, from the quantised activations on)."""
    if not sw.packed4:
        raise ValueError("int4 path needs nibble-packed values")
    return sparse_matmul_int8_plain(xq, sx, sw, out_dtype)


def sparse_matmul_int4(xq: torch.Tensor, sx: torch.Tensor,
                       sw: BlockSparseWeight,
                       out_dtype=torch.float32) -> torch.Tensor:
    """``dequant(xq [M, K] int8, sx [M] f32) @ dequant4(sw)``; CPU tensors
    take the plain version."""
    if xq.device.type == "cpu":
        return sparse_matmul_int4_plain(xq, sx, sw, out_dtype)
    out = launch_int(xq, sx, sw, out_dtype, int4=True)
    sparse_matmul_int4.launches += 1
    return out


sparse_matmul_int4.launches = 0
