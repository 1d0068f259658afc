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
(``wrapper.launches``) incremented only where it launches its kernel.
"""
