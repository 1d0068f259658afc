"""Hand-written Hopper kernels and their plain PyTorch versions.

| wrapper | CUDA source | replaces (TPU kernel) |
| --- | --- | --- |
| ``sparse_gemv.sparse_gemv`` | ``csrc/sparse_gemv.cu`` | ``repro/kernels/sparse_gemv.py:sparse_gemv_pallas`` |
| ``sparse_attention.sparse_decode_attention_fused`` | ``csrc/sparse_attention.cu`` | ``repro/kernels/sparse_attention.py:sparse_decode_attention_fused_pallas`` (flat) |
| ``sparse_matmul.sparse_matmul`` | ``csrc/sparse_matmul.cu`` | ``repro/kernels/sparse_matmul.py:sparse_matmul_pallas`` |
| ``sparse_matmul.sparse_matmul_f32`` | ``csrc/sparse_matmul.cu`` | ``repro/kernels/sparse_matmul.py:sparse_matmul_pallas`` (f32 activations) |
| ``dense_matmul.dense_matmul`` | ``csrc/dense_matmul.cu`` | ``repro/kernels/dense_matmul.py:dense_matmul_pallas`` |
| ``sparse_attention.sparse_decode_attention_fused_paged`` | ``csrc/sparse_attention.cu`` | ``repro/kernels/sparse_attention.py:sparse_decode_attention_fused_pallas`` (paged) |
| ``sparse_matmul_int8.sparse_matmul_int8`` | ``csrc/sparse_matmul_int8.cu`` | ``repro/kernels/sparse_matmul_int8.py:sparse_matmul_int8_pallas`` |
| ``sparse_matmul_int4.sparse_matmul_int4`` | ``csrc/sparse_matmul_int8.cu`` | ``repro/kernels/sparse_matmul_int4.py:sparse_matmul_int4_pallas`` |
| ``sparse_attention.sparse_decode_attention_partial`` | ``csrc/sparse_attention.cu`` | ``repro/kernels/sparse_attention.py:sparse_decode_attention_pallas`` (prefix-only partial) |

Each wrapper counts its launches in a plain integer attribute
(``wrapper.launches``) incremented only where it launches its kernel.  A
CUDA graph that holds launches adds them to the same counters on every
replay (``serving/engine.py::CapturedEntry``), so :func:`launch_counts` reads
eager launches and replayed ones alike.
"""
from __future__ import annotations

from typing import Dict

# the submodules stay the package's attributes (several share a name with
# their wrapper), so the registry reaches the wrappers through them
from . import (dense_matmul as _dense, sparse_attention as _attention,
               sparse_gemv as _gemv, sparse_matmul as _matmul,
               sparse_matmul_int4 as _int4, sparse_matmul_int8 as _int8)

KERNELS = {"sparse_gemv": _gemv.sparse_gemv,
           "sparse_decode_attention_fused":
               _attention.sparse_decode_attention_fused,
           "sparse_matmul": _matmul.sparse_matmul,
           "dense_matmul": _dense.dense_matmul,
           "sparse_decode_attention_fused_paged":
               _attention.sparse_decode_attention_fused_paged,
           "sparse_matmul_int8": _int8.sparse_matmul_int8,
           "sparse_matmul_int4": _int4.sparse_matmul_int4,
           "sparse_decode_attention_partial":
               _attention.sparse_decode_attention_partial,
           "sparse_matmul_f32": _matmul.sparse_matmul_f32}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def set_launch_counts(counts: Dict[str, int]) -> None:
    for name, n in counts.items():
        KERNELS[name].launches = n


def reset_launch_counts() -> None:
    set_launch_counts(dict.fromkeys(KERNELS, 0))
