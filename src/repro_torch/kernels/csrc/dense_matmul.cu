// Dense product y[M, N] = x[M, K] @ W^T with W stored as rows [N, K] and
// f32 output: the tied unembedding (logits = h @ tok.T).  Replaces
// repro/kernels/dense_matmul.py:dense_matmul_pallas on the serving path.
//
// Bound on the H100: device-memory bytes.  Serving calls it with M = the
// number of slots (decode) or 1 (the last prefill token), so it does 2*M
// flops per 2-byte weight against a ~295 flop/byte ridge; the floor is the
// embedding table read once (151936 x 1024 bf16 = 311 MB -> ~93 us).
//
// Design: the table is read in place through its [N, K] row layout (the
// wrapper hands over tok itself, never a materialised tok.T), one warp per
// output column walks the contiguous row with paired loads, and every row
// of x (staged in f32 shared memory, up to 8 rows per pass) is dotted
// against it, so the table is streamed once per 8 rows.  Accumulation is
// f32 (the TPU kernel's f32 VMEM accumulator).
#include "decompress.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int MC = 8;                  // x rows per pass
constexpr int COLS = 64;               // output columns per thread block

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void __launch_bounds__(NT) rowdot(const T* __restrict__ x, int M,
                                             int K, const T* __restrict__ w,
                                             int N, long long ldw,
                                             float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_x = reinterpret_cast<float*>(smem);          // [MC][K]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * COLS;
  for (int m0 = 0; m0 < M; m0 += MC) {
    const int mc = min(MC, M - m0);
    for (int i = threadIdx.x; i < MC * K; i += NT) {
      const int m = i / K;
      s_x[i] = m < mc ? to_f32(x[static_cast<size_t>(m0) * K + i]) : 0.f;
    }
    __syncthreads();
    for (int c = warp; c < COLS; c += NWARP) {
      const int n = n0 + c;
      if (n >= N) break;
      const T* wr = w + static_cast<size_t>(n) * ldw;
      float acc[MC];
#pragma unroll
      for (int m = 0; m < MC; ++m) acc[m] = 0.f;
#pragma unroll 4
      for (int k = 2 * lane; k < K; k += 64) {
        const float2 wv = load2(wr + k);
#pragma unroll
        for (int m = 0; m < MC; ++m)
          acc[m] += s_x[m * K + k] * wv.x + s_x[m * K + k + 1] * wv.y;
      }
#pragma unroll
      for (int m = 0; m < MC; ++m) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
      }
      if (lane == 0) {
        for (int m = 0; m < mc; ++m)
          out[static_cast<size_t>(m0 + m) * N + n] = acc[m];
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t run(const void* x, int M, int K, const void* w, int N,
                long long ldw, void* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(MC) * K * 4;
  auto kern = rowdot<T>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<(N + COLS - 1) / COLS, NT, smem, stream>>>(
      static_cast<const T*>(x), M, K, static_cast<const T*>(w), N, ldw,
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// x [M, K] contiguous; w rows [N, K] with row stride ldw (elements), unit
// column stride; out f32 [M, N].  K and ldw must be even (paired loads) and
// 8*K*4 bytes of x must fit in shared memory.  Returns cudaGetLastError().
REPRO_EXPORT int dense_matmul_launch(const void* x, int dtype, int M, int K,
                                     const void* w, int N, long long ldw,
                                     void* out, void* stream) {
  if (K % 2 != 0 || ldw % 2 != 0 || static_cast<size_t>(MC) * K * 4 >
                                        227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == REPRO_BF16)
    e = run<__nv_bfloat16>(x, M, K, w, N, ldw, out, s);
  else if (dtype == REPRO_F32)
    e = run<float>(x, M, K, w, N, ldw, out, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
