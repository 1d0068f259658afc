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

// Stage the slice of rows [r0, r1) of one compressed block (`words` its
// bitmap, `bn` its width): the slice's words and their ranks, then the
// packed values those ranks reach, ranks clamped to cap - 1 as packed_rank
// clamps them.  Values are `vbits` bits each (4: two per byte, low nibble
// first; 8, 16 or 32) and the block's `n_bytes` bytes start at `vals`.
// The bytes are copied into `s_v` from a 16-byte aligned start, with
// 16-byte loads where n_bytes and the pointer allow, so `s_v` needs room
// for the slice's own bytes plus 32.  Returns the byte offset, within the
// block's values, that s_v[0] holds.  Every thread of the block must call
// this.  Ends with a __syncthreads().
__device__ __forceinline__ int stage_slice(
    const uint32_t* __restrict__ words, int bn, int r0, int r1,
    const uint8_t* __restrict__ vals, int n_bytes, int cap, int vbits,
    uint32_t* s_words, int* s_off, int* s_scr, uint8_t* s_v) {
  const int w_lo = r0 * bn / 32, w_hi = r1 * bn / 32;
  stage_slice_offsets(words, w_lo, w_hi, s_words, s_off, s_scr);
  const int nw = w_hi - w_lo;
  const int first = s_off[0];
  const int last = s_off[nw - 1] + __popc(s_words[nw - 1]);
  const int lo = min(first, cap - 1), hi = min(last, cap);
  // bytes [b_lo, b_hi) hold ranks [lo, hi)
  const int b_lo = lo * vbits / 8, b_hi = (hi * vbits + 7) / 8;
  const int b_a = b_lo & ~15;
  if (n_bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(vals) & 15) == 0) {
    const int n16 = (b_hi + 15) / 16 - b_a / 16;
    const uint4* src = reinterpret_cast<const uint4*>(vals + b_a);
    uint4* dst = reinterpret_cast<uint4*>(s_v);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = src[i];
  } else {
    for (int i = b_lo + threadIdx.x; i < b_hi; i += blockDim.x)
      s_v[i - b_a] = vals[i];
  }
  __syncthreads();
  return b_a;
}

// The split of a K-split kernel: `rps` rows of one compressed block of
// `bk` rows, split s covering block row `kb`, slice rows [r0, r0 + rows)
// of it, x columns from kx0.
struct Split {
  int kb, r0, rows, kx0;
  __device__ Split(int bk, int rps, int split) {
    const int spb = (bk + rps - 1) / rps;
    kb = split / spb;
    r0 = (split % spb) * rps;
    rows = min(rps, bk - r0);
    kx0 = kb * bk + r0;
  }
};

// 16 bytes from device to shared memory, asynchronously; `fill` false
// zero-fills them instead (and reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = fill ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Wait until at most N of this thread's committed cp.async groups are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four f32 values to four consecutive outputs, rounded once (bf16: one
// 8-byte store; `o` must be aligned to four elements).
template <typename TO>
__device__ __forceinline__ void store4(TO* o, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* o, float4 v) {
  *reinterpret_cast<float4*>(o) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* o,
                                                      float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(o) = u;
}

// Stage x rows [c0, c0 + mc) x columns [kx0, kx0 + cols) of a row-major
// x [M, K] into `dst` (row stride ldx elements): cp.async of 16 bytes
// where `vec` (K a multiple of 16 bytes' worth, x 16-byte aligned; cols
// too), else plain loads.  Zeros past K, and in rows at or past M up to
// the next multiple of 16; rows past that are never read.
template <typename TX>
__device__ __forceinline__ void stage_x(TX* dst, int ldx,
                                        const TX* __restrict__ x, int M,
                                        int K, int c0, int mc, int kx0,
                                        int cols, bool vec) {
  constexpr int E = 16 / sizeof(TX);
  const int rows = min(mc, (M - c0 + 15) / 16 * 16);
  if (vec) {
    const int per_row = cols / E;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row, q = i % per_row;
      const int gr = c0 + r, gk = kx0 + q * E;
      const bool ok = gr < M && gk < K;
      cp_async16(dst + r * ldx + q * E,
                 ok ? x + static_cast<size_t>(gr) * K + gk : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, kk = i % cols;
      const int gr = c0 + r, gk = kx0 + kk;
      dst[r * ldx + kk] =
          (gr < M && gk < K) ? x[static_cast<size_t>(gr) * K + gk] : TX{};
    }
  }
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
