// Sparse GEMV: y[M<=8, N] = x[M, K] @ unpack(W) for the decode-tick linears.
// Replaces repro/kernels/sparse_gemv.py:sparse_gemv_pallas.
//
// Bound on the H100: device-memory bytes.  At M <= 8 the product does
// 2*M flops per stored weight, far below the ~295 flop/byte ridge, so the
// time floor is (bitmap + packed values + x + y) / 3.35 TB/s.
//
// Design: the TPU kernel carries an f32 accumulator across a sequential K
// grid axis.  Here nothing carries between thread blocks.  Each block owns
// one (bn)-column block and a slice of `rows_per_cta` rows of one K block
// (so an N of 8-24 column blocks still puts a few hundred blocks on 132
// SMs), expands its bits in place with the shared prefix-sum helper,
// multiplies against the x sliver staged in shared memory, and writes an
// f32 partial.  A second, tiny kernel sums the partials over the K splits
// and casts to the output dtype.  The partial sums are deterministic.
#include "decompress.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAXM = 8;

template <typename TX, typename TV>
__global__ void __launch_bounds__(NT) gemv_partial(
    const TX* __restrict__ x, int M, int K,
    const uint32_t* __restrict__ bitmap, const TV* __restrict__ values,
    int Nb, int bk, int bn, int cap, int rows_per_cta,
    float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = bk * bn / 32;
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  int* s_off = reinterpret_cast<int*>(s_words + W);
  int* s_scr = s_off + W;
  float* s_x = reinterpret_cast<float*>(s_scr + 32);     // [MAXM][rpc]
  float* s_red = s_x + MAXM * rows_per_cta;              // [NT/bn][MAXM][bn]

  const int nb = blockIdx.x, kb = blockIdx.y, rs = blockIdx.z;
  const int n_split = gridDim.z;
  const size_t blk = static_cast<size_t>(kb) * Nb + nb;
  const int r0 = rs * rows_per_cta;
  const int r1 = min(r0 + rows_per_cta, bk);
  // offsets are needed only up to this slice's last row
  stage_word_offsets(bitmap + blk * W, (r1 * bn + 31) / 32, s_words, s_off,
                     s_scr);

  for (int i = threadIdx.x; i < MAXM * rows_per_cta; i += NT) {
    const int m = i / rows_per_cta, r = i % rows_per_cta;
    const int k = kb * bk + r0 + r;
    s_x[i] = (m < M && r0 + r < r1 && k < K)
                 ? to_f32(x[static_cast<size_t>(m) * K + k]) : 0.f;
  }
  __syncthreads();

  const int n_rg = NT / bn;
  const int c = threadIdx.x % bn, rg = threadIdx.x / bn;
  float acc[MAXM];
#pragma unroll
  for (int m = 0; m < MAXM; ++m) acc[m] = 0.f;
  const TV* vals = values + blk * cap;
  if (rg < n_rg) {
    for (int r = r0 + rg; r < r1; r += n_rg) {
      const float w = expand_at(r * bn + c, s_words, s_off, vals, cap);
      const float* xr = s_x + (r - r0);
#pragma unroll
      for (int m = 0; m < MAXM; ++m) acc[m] += xr[m * rows_per_cta] * w;
    }
#pragma unroll
    for (int m = 0; m < MAXM; ++m) s_red[(rg * MAXM + m) * bn + c] = acc[m];
  }
  __syncthreads();
  const int np = Nb * bn;
  for (int i = threadIdx.x; i < M * bn; i += NT) {
    const int m = i / bn, cc = i % bn;
    float s = 0.f;
    for (int g = 0; g < n_rg; ++g) s += s_red[(g * MAXM + m) * bn + cc];
    const size_t split = static_cast<size_t>(kb) * n_split + rs;
    partial[(split * M + m) * np + static_cast<size_t>(nb) * bn + cc] = s;
  }
}

template <typename TO>
__global__ void sum_partials(const float* __restrict__ partial, int n_split,
                             int count, TO* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < n_split; ++k)
    s += partial[static_cast<size_t>(k) * count + i];
  out[i] = from_f32<TO>(s);
}

template <typename TX, typename TV>
cudaError_t run(const void* x, int M, int K, const void* bitmap,
                const void* values, int Kb, int Nb, int bk, int bn, int cap,
                int rows_per_cta, void* partial, void* out,
                cudaStream_t stream) {
  const int n_rs = (bk + rows_per_cta - 1) / rows_per_cta;
  const size_t smem = static_cast<size_t>(bk * bn / 32) * 8 + 32 * 4 +
                      static_cast<size_t>(MAXM) * rows_per_cta * 4 +
                      static_cast<size_t>(NT / bn) * MAXM * bn * 4;
  auto kern = gemv_partial<TX, TV>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(Nb, Kb, n_rs);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const TX*>(x), M, K, static_cast<const uint32_t*>(bitmap),
      static_cast<const TV*>(values), Nb, bk, bn, cap, rows_per_cta,
      static_cast<float*>(partial));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int count = M * Nb * bn;
  sum_partials<TX><<<(count + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), Kb * n_rs, count,
      static_cast<TX*>(out));
  return cudaGetLastError();
}

}  // namespace

// x [M, K] (dtype x_dtype, contiguous); bitmap [Kb, Nb, bk*bn/32] words;
// values [Kb, Nb, cap] (dtype v_dtype); partial f32 [Kb*ceil(bk/rpc), M,
// Nb*bn] scratch; out [M, Nb*bn] in x's dtype.  Returns cudaGetLastError().
REPRO_EXPORT int sparse_gemv_launch(const void* x, int x_dtype, int M, int K,
                                    const void* bitmap, const void* values,
                                    int v_dtype, int Kb, int Nb, int bk,
                                    int bn, int cap, int rows_per_cta,
                                    void* partial, void* out, void* stream) {
  if (M < 1 || M > MAXM || bn > NT || (bk * bn) % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_dtype == REPRO_BF16 && v_dtype == REPRO_BF16)
    e = run<__nv_bfloat16, __nv_bfloat16>(x, M, K, bitmap, values, Kb, Nb,
                                          bk, bn, cap, rows_per_cta,
                                          partial, out, s);
  else if (x_dtype == REPRO_F32 && v_dtype == REPRO_BF16)
    e = run<float, __nv_bfloat16>(x, M, K, bitmap, values, Kb, Nb, bk, bn,
                                  cap, rows_per_cta, partial, out, s);
  else if (x_dtype == REPRO_F32 && v_dtype == REPRO_F32)
    e = run<float, float>(x, M, K, bitmap, values, Kb, Nb, bk, bn, cap,
                          rows_per_cta, partial, out, s);
  else if (x_dtype == REPRO_BF16 && v_dtype == REPRO_F32)
    e = run<__nv_bfloat16, float>(x, M, K, bitmap, values, Kb, Nb, bk, bn,
                                  cap, rows_per_cta, partial, out, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
