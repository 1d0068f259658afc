// Sparse int8 / int4 GEMM: y[M, N] = dequant(xq, sx) @ dequant(W), for
// every M (decode ticks and prefill chunks alike).  One template, two
// instantiations:
//   INT4 = false replaces repro/kernels/sparse_matmul_int8.py:
//                sparse_matmul_int8_pallas (int8 packed values);
//   INT4 = true  replaces repro/kernels/sparse_matmul_int4.py:
//                sparse_matmul_int4_pallas (two int4 values per byte, low
//                nibble first, sign-extended by (x ^ 8) - 8).
//
// Bound on the H100: device-memory bytes.  At a decode tick (M <= 8) a
// stored weight costs 1 byte (int8) or half a byte (int4) plus its bitmap
// bit, against 2*M integer operations; even a 256-row prefill chunk stays
// under the int8 tensor-core ridge (~590 op/byte).
//
// Design (load-as-sparse, compute-as-dense): one thread block per
// (column block, row tile, K block).  It stages the block's bitmap words and
// their prefix popcounts with the shared helper and the block's packed value
// bytes with 16-byte loads, expands the compressed (bk, bn) block from
// shared memory into an int8 tile stored column-major (so four consecutive
// k of one column are one 32-bit word), stages the int8 activation tile
// beside it, and multiplies with __dp4a into int32.  The
// TPU kernel's sequential K axis becomes a grid axis: each block adds its
// int32 partial sums into a zeroed int32 accumulator with atomicAdd.
// Integer addition is associative, so the sum is exact and independent of
// the order the blocks run in.  A second small kernel applies the
// reference's epilogue in its order, (float(acc) * sx[m]) * scale[n], and
// rounds once to the output type, so the result equals the plain version
// bit for bit.
#include "decompress.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAXR = 32;               // output rows one thread accumulates
constexpr int TM_MAX = 64;             // rows per thread block

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

struct Layout {
  int W, ldk;                          // words per block; bytes per column
  size_t off_off, off_scr, off_x, off_w, off_v, bytes;
  __host__ __device__ Layout(int bk, int bn, int tm, int vstride) {
    W = bk * bn / 32;
    ldk = bk + 4;                      // bk % 8 == 0: an odd word stride
    off_off = static_cast<size_t>(W) * 4;
    off_scr = off_off + static_cast<size_t>(W) * 4;
    off_x = align16(off_scr + 32 * 4);
    off_w = align16(off_x + static_cast<size_t>(tm) * bk);
    off_v = align16(off_w + static_cast<size_t>(bn) * ldk);
    bytes = off_v + align16(vstride);
  }
};

// The int8 weight at packed rank r of one block's value bytes.
template <bool INT4>
__device__ __forceinline__ int8_t value_at(const uint8_t* __restrict__ vals,
                                           int r) {
  if (INT4) {
    const int byte = vals[r >> 1];
    const int x = (r & 1) ? (byte >> 4) : (byte & 0xF);
    return static_cast<int8_t>((x ^ 8) - 8);
  }
  return static_cast<int8_t>(vals[r]);
}

template <bool INT4>
__global__ void __launch_bounds__(NT) sparse_matmul_int(
    const int8_t* __restrict__ xq, int M, int K,
    const uint32_t* __restrict__ bitmap, const uint8_t* __restrict__ values,
    int Nb, int bk, int bn, int cap, int vstride, int tm,
    int* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(bk, bn, tm, vstride);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  int* s_off = reinterpret_cast<int*>(smem + L.off_off);
  int* s_scr = reinterpret_cast<int*>(smem + L.off_scr);
  int8_t* s_x = reinterpret_cast<int8_t*>(smem + L.off_x);     // [tm][bk]
  int8_t* s_w = reinterpret_cast<int8_t*>(smem + L.off_w);     // [bn][ldk]
  uint8_t* s_v = smem + L.off_v;                               // [vstride]

  const int nb = blockIdx.x, row0 = blockIdx.y * tm, kb = blockIdx.z;
  const int t = threadIdx.x;
  const size_t blk = static_cast<size_t>(kb) * Nb + nb;

  // the block's packed values, coalesced, so the expansion below gathers
  // from shared memory instead of waiting on one device load per weight
  const uint8_t* vals = values + blk * vstride;
  if ((vstride & 15) == 0 && (reinterpret_cast<uintptr_t>(vals) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(vals);
    uint4* dst = reinterpret_cast<uint4*>(s_v);
    for (int i = t; i < vstride / 16; i += NT) dst[i] = src[i];
  } else {
    for (int i = t; i < vstride; i += NT) s_v[i] = vals[i];
  }
  stage_word_offsets(bitmap + blk * L.W, L.W, s_words, s_off, s_scr);

  // thread t owns column c and rows rg, rg + nrg, ... (NT % bn == 0)
  const int nrg = NT / bn;
  const int c = t % bn, rg = t / bn;
  for (int r = rg; r < bk; r += nrg) {
    const int rank = packed_rank(r * bn + c, s_words, s_off, cap);
    s_w[c * L.ldk + r] = rank < 0 ? int8_t(0) : value_at<INT4>(s_v, rank);
  }
  const int rows = min(tm, M - row0);
  for (int i = t; i < tm * bk; i += NT) {
    const int r = i / bk, kk = i % bk;
    const int gk = kb * bk + kk;
    s_x[i] = (r < rows && gk < K)
                 ? xq[static_cast<size_t>(row0 + r) * K + gk]
                 : int8_t(0);
  }
  __syncthreads();

  // the same thread owns the tile's output rows rg, rg + nrg, ... of c
  int sum[MAXR];
#pragma unroll
  for (int i = 0; i < MAXR; ++i) sum[i] = 0;
  const int* wcol = reinterpret_cast<const int*>(s_w + c * L.ldk);
  const int* xrow = reinterpret_cast<const int*>(s_x);
  const int kw = bk / 4;
  for (int k4 = 0; k4 < kw; ++k4) {
    const int w4 = wcol[k4];
#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      const int r = rg + i * nrg;
      if (r < rows) sum[i] = __dp4a(xrow[r * kw + k4], w4, sum[i]);
    }
  }
  const size_t np = static_cast<size_t>(Nb) * bn;
#pragma unroll
  for (int i = 0; i < MAXR; ++i) {
    const int r = rg + i * nrg;
    if (r < rows)
      atomicAdd(acc + static_cast<size_t>(row0 + r) * np +
                    static_cast<size_t>(nb) * bn + c,
                sum[i]);
  }
}

// out[m, n] = (float(acc[m, n]) * sx[m]) * scale[n], the reference's order.
template <typename TO>
__global__ void int_epilogue(const int* __restrict__ acc, int M, int N,
                             int np, const float* __restrict__ sx,
                             const float* __restrict__ scale,
                             TO* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(M) * N) return;
  const int m = static_cast<int>(i / N), n = static_cast<int>(i % N);
  const float a = __int2float_rn(acc[static_cast<size_t>(m) * np + n]);
  out[i] = from_f32<TO>(__fmul_rn(__fmul_rn(a, sx[m]), scale[n]));
}

template <bool INT4>
cudaError_t run(const void* xq, int M, int K, const void* bitmap,
                const void* values, int Kb, int Nb, int bk, int bn, int cap,
                int vstride, void* acc, cudaStream_t stream) {
  const int nrg = NT / bn;
  int tm = MAXR * nrg < TM_MAX ? MAXR * nrg : TM_MAX;
  const int m_up = (M + nrg - 1) / nrg * nrg;    // small M: a short tile
  if (m_up < tm) tm = m_up;
  const Layout L(bk, bn, tm, vstride);
  auto kern = sparse_matmul_int<INT4>;
  cudaError_t e = allow_smem(kern, L.bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(Nb, (M + tm - 1) / tm, Kb);
  kern<<<grid, NT, L.bytes, stream>>>(
      static_cast<const int8_t*>(xq), M, K,
      static_cast<const uint32_t*>(bitmap),
      static_cast<const uint8_t*>(values), Nb, bk, bn, cap, vstride, tm,
      static_cast<int*>(acc));
  return cudaGetLastError();
}

}  // namespace

// xq int8 [M, K] contiguous; sx f32 [M]; bitmap [Kb, Nb, bk*bn/32] words;
// values [Kb, Nb, vstride] bytes (int8, or uint8 nibble pairs when int4);
// cap = packed values per block (2 * vstride when int4); scale f32
// [>= N]; acc int32 scratch [M, Nb*bn] (zeroed here); out [M, N] in
// out_dtype.  bk % 8 == 0, bn divides 256 with bn >= 8.  Returns
// cudaGetLastError().
REPRO_EXPORT int sparse_matmul_int_launch(
    const void* xq, int M, int K, const void* bitmap, const void* values,
    int int4, int Kb, int Nb, int bk, int bn, int cap, int vstride,
    const void* sx, const void* scale, int N, void* acc, void* out,
    int out_dtype, void* stream) {
  if (bk % 8 != 0 || bn < 8 || NT % bn != 0 || M < 1 || N > Nb * bn ||
      K > Kb * bk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t np = static_cast<size_t>(Nb) * bn;
  cudaError_t e = cudaMemsetAsync(acc, 0, static_cast<size_t>(M) * np * 4, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = int4 ? run<true>(xq, M, K, bitmap, values, Kb, Nb, bk, bn, cap,
                       vstride, acc, s)
           : run<false>(xq, M, K, bitmap, values, Kb, Nb, bk, bn, cap,
                        vstride, acc, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t total = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>((total + NT - 1) / NT);
  const int* a = static_cast<const int*>(acc);
  const float* fsx = static_cast<const float*>(sx);
  const float* fsc = static_cast<const float*>(scale);
  if (out_dtype == REPRO_BF16)
    int_epilogue<__nv_bfloat16><<<blocks, NT, 0, s>>>(
        a, M, N, static_cast<int>(np), fsx, fsc,
        static_cast<__nv_bfloat16*>(out));
  else if (out_dtype == REPRO_F32)
    int_epilogue<float><<<blocks, NT, 0, s>>>(
        a, M, N, static_cast<int>(np), fsx, fsc, static_cast<float*>(out));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
