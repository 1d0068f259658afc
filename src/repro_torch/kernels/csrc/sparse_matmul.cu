// Sparse GEMM: y[M, N] = x[M, K] @ unpack(W) for M > 8 rows (prefill chunks,
// and decode above 8 slots).  Replaces
// repro/kernels/sparse_matmul.py:sparse_matmul_pallas.
//
// Bound on the H100: at a 256-row prefill chunk the product does 2*256
// flops per expanded weight against ~2.1 stored bytes per weight, i.e. about
// 240 flop/byte, just under the bf16 ridge (~295): device-memory bytes and
// tensor-core time are of the same order, and at these sizes neither is
// what limits this first version, whose cost is the expansion.
//
// Design (load-as-sparse, compute-as-dense): each thread block owns a
// TM x bn output tile and loops over the K blocks itself (the TPU kernel's
// sequential K grid axis becomes this loop; nothing carries between
// blocks).  Per K block it expands the compressed (bk, bn) tile into a bf16
// shared-memory tile with the shared prefix-sum helper, stages the x tile
// beside it, and runs bf16 WMMA (mma.sync) fragments with f32
// accumulators.  A (256, 128) bf16 tile is 64 KB, so the kernel opts into
// dynamic shared memory above 48 KB.
//
// f32 activations (an engine served at f32, whose prefill chunks and wide
// verify panels reach this kernel) take a second kernel with the same
// tiling: the block expands into an f32 shared-memory tile and each thread
// accumulates TM * bn / NT outputs with f32 FMAs (no tensor cores: TF32
// would round the activations), in K order within each block.
#include <mma.h>

#include "decompress.cuh"

using namespace nvcuda;

namespace {

constexpr int NT = 256;
constexpr int TM = 64;                 // output rows per thread block
constexpr int NWARP = NT / 32;
constexpr int MAXF = 4;                // accumulator fragments per warp

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) & ~static_cast<size_t>(127);
}

struct Layout {
  int W, ldx, ldw, ldo;
  size_t off_off, off_scr, off_x, off_w, bytes;
  __host__ __device__ Layout(int bk, int bn) {
    W = bk * bn / 32;
    ldx = bk + 8;
    ldw = bn + 8;
    ldo = bn + 4;
    off_off = static_cast<size_t>(W) * 4;
    off_scr = off_off + static_cast<size_t>(W) * 4;
    off_x = align128(off_scr + 32 * 4);
    off_w = align128(off_x + static_cast<size_t>(TM) * ldx * 2);
    const size_t w_bytes = static_cast<size_t>(bk) * ldw * 2;
    const size_t o_bytes = static_cast<size_t>(TM) * ldo * 4;  // epilogue
    bytes = off_w + (w_bytes > o_bytes ? w_bytes : o_bytes);
  }
};

__global__ void __launch_bounds__(NT) sparse_matmul_bf16(
    const __nv_bfloat16* __restrict__ x, int M, int K,
    const uint32_t* __restrict__ bitmap,
    const __nv_bfloat16* __restrict__ values, int Kb, int Nb, int bk, int bn,
    int cap, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(bk, bn);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  int* s_off = reinterpret_cast<int*>(smem + L.off_off);
  int* s_scr = reinterpret_cast<int*>(smem + L.off_scr);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + L.off_x);
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + L.off_w);
  float* s_o = reinterpret_cast<float*>(smem + L.off_w);

  const int nb = blockIdx.x;
  const int row0 = blockIdx.y * TM;
  const int warp = threadIdx.x / 32;
  const int ncf = bn / 16;                      // column fragments
  const int nfrag = (TM / 16) * ncf;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXF];
#pragma unroll
  for (int i = 0; i < MAXF; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int kb = 0; kb < Kb; ++kb) {
    const size_t blk = static_cast<size_t>(kb) * Nb + nb;
    stage_word_offsets(bitmap + blk * L.W, L.W, s_words, s_off, s_scr);
    const __nv_bfloat16* vals = values + blk * cap;
    for (int p = threadIdx.x; p < bk * bn; p += NT) {
      const int r = p / bn, c = p % bn;
      s_w[r * L.ldw + c] =
          __float2bfloat16(expand_at(p, s_words, s_off, vals, cap));
    }
    for (int i = threadIdx.x; i < TM * bk; i += NT) {
      const int r = i / bk, kk = i % bk;
      const int gr = row0 + r, gk = kb * bk + kk;
      s_x[r * L.ldx + kk] = (gr < M && gk < K)
                                ? x[static_cast<size_t>(gr) * K + gk]
                                : __float2bfloat16(0.f);
    }
    __syncthreads();
    for (int kk = 0; kk < bk; kk += 16) {
#pragma unroll
      for (int i = 0; i < MAXF; ++i) {
        const int f = warp + i * NWARP;
        if (f < nfrag) {
          const int rf = f / ncf, cf = f % ncf;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b;
          wmma::load_matrix_sync(a, s_x + rf * 16 * L.ldx + kk, L.ldx);
          wmma::load_matrix_sync(b, s_w + kk * L.ldw + cf * 16, L.ldw);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
    __syncthreads();                   // before the next block overwrites
  }

#pragma unroll
  for (int i = 0; i < MAXF; ++i) {
    const int f = warp + i * NWARP;
    if (f < nfrag) {
      const int rf = f / ncf, cf = f % ncf;
      wmma::store_matrix_sync(s_o + rf * 16 * L.ldo + cf * 16, acc[i], L.ldo,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  const size_t np = static_cast<size_t>(Nb) * bn;
  for (int i = threadIdx.x; i < TM * bn; i += NT) {
    const int r = i / bn, c = i % bn;
    const int gr = row0 + r;
    if (gr < M)
      out[gr * np + static_cast<size_t>(nb) * bn + c] =
          __float2bfloat16(s_o[r * L.ldo + c]);
  }
}

// f32 x: one TM x bn output tile per thread block, as above; thread t owns
// column t % bn and TM / (NT / bn) consecutive rows.
constexpr int TMF = 32;                // f32 output rows per thread block

template <typename TV>
__global__ void __launch_bounds__(NT) sparse_matmul_f32(
    const float* __restrict__ x, int M, int K,
    const uint32_t* __restrict__ bitmap, const TV* __restrict__ values,
    int Kb, int Nb, int bk, int bn, int cap, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = bk * bn / 32;
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  int* s_off = reinterpret_cast<int*>(s_words + W);
  int* s_scr = s_off + W;
  float* s_x = reinterpret_cast<float*>(s_scr + 32);     // [TMF][bk]
  float* s_w = s_x + TMF * bk;                           // [bk][bn]

  const int nb = blockIdx.x;
  const int row0 = blockIdx.y * TMF;
  const int c = threadIdx.x % bn, rg = threadIdx.x / bn;
  const int n_rg = NT / bn, rows = TMF / n_rg;
  float acc[TMF];
#pragma unroll
  for (int i = 0; i < TMF; ++i) acc[i] = 0.f;

  for (int kb = 0; kb < Kb; ++kb) {
    const size_t blk = static_cast<size_t>(kb) * Nb + nb;
    stage_word_offsets(bitmap + blk * W, W, s_words, s_off, s_scr);
    const TV* vals = values + blk * cap;
    for (int p = threadIdx.x; p < bk * bn; p += NT)
      s_w[p] = expand_at(p, s_words, s_off, vals, cap);
    for (int i = threadIdx.x; i < TMF * bk; i += NT) {
      const int r = i / bk, kk = i % bk;
      const int gr = row0 + r, gk = kb * bk + kk;
      s_x[i] = (gr < M && gk < K) ? x[static_cast<size_t>(gr) * K + gk]
                                  : 0.f;
    }
    __syncthreads();
    if (rg < n_rg) {
      const float* xr = s_x + rg * rows * bk;
      for (int kk = 0; kk < bk; ++kk) {
        const float w = s_w[kk * bn + c];
#pragma unroll
        for (int i = 0; i < TMF; ++i)
          if (i < rows) acc[i] = fmaf(xr[i * bk + kk], w, acc[i]);
      }
    }
    __syncthreads();                   // before the next block overwrites
  }
  if (rg < n_rg) {
    const size_t np = static_cast<size_t>(Nb) * bn;
#pragma unroll
    for (int i = 0; i < TMF; ++i) {
      const int gr = row0 + rg * rows + i;
      if (i < rows && gr < M)
        out[gr * np + static_cast<size_t>(nb) * bn + c] = acc[i];
    }
  }
}

template <typename TV>
cudaError_t run_f32(const void* x, int M, int K, const void* bitmap,
                    const void* values, int Kb, int Nb, int bk, int bn,
                    int cap, void* out, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(bk * bn / 32) * 8 + 32 * 4 +
                       static_cast<size_t>(TMF) * bk * 4 +
                       static_cast<size_t>(bk) * bn * 4;
  auto kern = sparse_matmul_f32<TV>;
  cudaError_t e = allow_smem(kern, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(Nb, (M + TMF - 1) / TMF);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(x), M, K,
      static_cast<const uint32_t*>(bitmap), static_cast<const TV*>(values),
      Kb, Nb, bk, bn, cap, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16 contiguous; bitmap [Kb, Nb, bk*bn/32] words; values
// [Kb, Nb, cap] bf16; out [M, Nb*bn] bf16.  bk and bn must be multiples of
// 16 and bn <= 128.  Returns cudaGetLastError().
REPRO_EXPORT int sparse_matmul_launch(const void* x, int M, int K,
                                      const void* bitmap, const void* values,
                                      int Kb, int Nb, int bk, int bn, int cap,
                                      void* out, void* stream) {
  if (bk % 16 != 0 || bn % 16 != 0 || bn > 128 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(bk, bn);
  cudaError_t e = allow_smem(sparse_matmul_bf16, L.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(Nb, (M + TM - 1) / TM);
  sparse_matmul_bf16<<<grid, NT, L.bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), M, K,
      static_cast<const uint32_t*>(bitmap),
      static_cast<const __nv_bfloat16*>(values), Kb, Nb, bk, bn, cap,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x [M, K] f32 contiguous; bitmap as above; values [Kb, Nb, cap] f32 or bf16
// (v_dtype); out [M, Nb*bn] f32.  bn must divide NT (256) and NT / bn must
// divide 32.  Returns cudaGetLastError().
REPRO_EXPORT int sparse_matmul_f32_launch(const void* x, int M, int K,
                                          const void* bitmap,
                                          const void* values, int v_dtype,
                                          int Kb, int Nb, int bk, int bn,
                                          int cap, void* out, void* stream) {
  if (bn < 1 || bn > NT || NT % bn != 0 || TMF % (NT / bn) != 0 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (v_dtype == REPRO_BF16)
    e = run_f32<__nv_bfloat16>(x, M, K, bitmap, values, Kb, Nb, bk, bn, cap,
                               out, s);
  else if (v_dtype == REPRO_F32)
    e = run_f32<float>(x, M, K, bitmap, values, Kb, Nb, bk, bn, cap, out, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
