// Shared device helpers for the sparse kernels: the paper's Algorithm 2
// (bitmap -> popcount -> exclusive prefix sum -> expand) written for one
// CUDA thread block.  Counterpart of repro/kernels/common.py
// (unpack_bits_block + decompress_block).
//
// Layout of one compressed block: `n_words` 32-bit bitmap words (bit b of
// word j is flat row-major position 32*j + b) and `cap` packed values in the
// same order.  The host side stores the words as int32 bit-views; here they
// are read as uint32, so `>>` is a logical shift.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes shared with the Python wrappers
enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Stage the first `n_words` words of one block in shared memory and compute
// each word's exclusive prefix popcount (the offset of its first set bit in
// the packed values).  Every thread of the block must call this; blockDim.x
// must be a multiple of 32.  `s_scratch` needs 32 ints.  Ends with a
// __syncthreads(), so the outputs are visible to the whole block.
__device__ __forceinline__ void stage_word_offsets(
    const uint32_t* __restrict__ words, int n_words, uint32_t* s_words,
    int* s_off, int* s_scratch) {
  const int nt = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = nt >> 5;
  const int per = (n_words + nt - 1) / nt;
  const int w0 = t * per;
  int local = 0;
  for (int i = 0; i < per; ++i) {
    const int j = w0 + i;
    if (j < n_words) {
      const uint32_t w = words[j];
      s_words[j] = w;
      local += __popc(w);
    }
  }
  // block-wide exclusive scan of the per-thread popcount totals
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < nwarps ? s_scratch[lane] : 0;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    if (lane < nwarps) s_scratch[lane] = inc - v;
  }
  __syncthreads();
  int run = s_scratch[warp] + incl - local;
  for (int i = 0; i < per; ++i) {
    const int j = w0 + i;
    if (j < n_words) {
      s_off[j] = run;
      run += __popc(s_words[j]);
    }
  }
  __syncthreads();
}

// Stage the words [w_lo, w_hi) of one block's bitmap (a slice of its rows)
// in shared memory, s_words[j - w_lo], with each word's exclusive prefix
// popcount over the whole block, s_off[j - w_lo]: the absolute rank of its
// first set bit.  Words [0, w_lo) are read only to count their bits.  Each
// thread owns a run of whole uint4s and reads them with 16-byte loads:
// `words` must be 16-byte aligned and w_hi a multiple of 4.  Every thread
// of the block must call this; blockDim.x must be a multiple of 32;
// `s_scratch` needs 32 ints.  Ends with a __syncthreads().
__device__ __forceinline__ void stage_slice_offsets(
    const uint32_t* __restrict__ words, int w_lo, int w_hi,
    uint32_t* s_words, int* s_off, int* s_scratch) {
  const int nt = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = nt >> 5;
  const int per = (w_hi + 4 * nt - 1) / (4 * nt) * 4;
  const int w0 = t * per, w1 = min(w0 + per, w_hi);
  int local = 0, before = 0;           // bits owned; those before w_lo
  for (int j = w0; j < w1; j += 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(words + j);
    const uint32_t v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = __popc(v[i]);
      local += c;
      if (j + i < w_lo) before += c;
      else s_words[j + i - w_lo] = v[i];
    }
  }
  // block-wide exclusive scan of the per-thread popcount totals
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < nwarps ? s_scratch[lane] : 0;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    if (lane < nwarps) s_scratch[lane] = inc - v;
  }
  __syncthreads();
  int run = s_scratch[warp] + incl - local + before;
  for (int j = max(w0, w_lo); j < w1; ++j) {
    s_off[j - w_lo] = run;
    run += __popc(s_words[j - w_lo]);
  }
  __syncthreads();
}

// Rank of flat position `p` of a staged block among the block's set bits,
// i.e. the index of its packed value (clamped to cap - 1, as the reference
// clamps its gather), or -1 where the bit is clear.  Independent of the
// value type: a bf16 block reads values[rank], an int8 block the byte at
// rank, a nibble-packed int4 block the nibble at rank.
__device__ __forceinline__ int packed_rank(int p, const uint32_t* s_words,
                                           const int* s_off, int cap) {
  const uint32_t w = s_words[p >> 5];
  const int b = p & 31;
  if (!((w >> b) & 1u)) return -1;
  return min(s_off[p >> 5] + __popc(w & ((1u << b) - 1u)), cap - 1);
}

// Dense value of flat position `p` of a staged block of f32/bf16 values: 0
// where the bit is clear, else the packed value at the bit's rank.
template <typename TV>
__device__ __forceinline__ float expand_at(int p, const uint32_t* s_words,
                                           const int* s_off,
                                           const TV* __restrict__ values,
                                           int cap) {
  const int idx = packed_rank(p, s_words, s_off, cap);
  return idx < 0 ? 0.f : to_f32(values[idx]);
}

// Every kernel source is built into its own shared library and includes
// this header once, so each library exports its own copy.
REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
