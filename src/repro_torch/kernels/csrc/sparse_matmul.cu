// Sparse GEMM: y[M, N] = x[M, K] @ unpack(W) for M > 8 rows (prefill chunks
// and speculative verify panels).  Replaces
// repro/kernels/sparse_matmul.py:sparse_matmul_pallas.
//
// Bound on the H100.  At a 20-row verify panel the product does 40 flops
// per stored weight against about 2.1 stored bytes (bitmap bit + packed
// bf16 value at 50 % density): device-memory bytes bind, ~5.6 us for the
// seven linears of a Qwen3-0.6B layer.  At a 256-row prefill chunk it is
// about 240 flop/byte, just under the bf16 ridge (~295): bytes and
// tensor-core time are of one order.  With f32 activations the f32 FMA
// rate (67 TFLOP/s, no tensor cores) binds at 256 rows.
//
// Design.  The TPU kernel carries an f32 accumulator across a sequential
// K grid axis.  Here the reduction over K is split across thread blocks:
// one block per (column block, split), a split being `rps` (64) rows of
// one compressed (bk, bn) block, so the seven linears launch 128 to 384
// blocks on the 132 SMs whatever M is.  A block
//   1. starts the first x chunk (its `rps` columns of 64 rows) on its way
//      with cp.async;
//   2. stages its slice's bitmap words with 16-byte loads and ranks them
//      (absolute prefix popcounts over the block), then copies the packed
//      values those ranks reach into shared memory with 16-byte loads;
//   3. expands the slice once: the bf16 kernel straight into the mma.sync
//      B fragments each warp keeps in registers (16 columns a warp), the
//      f32 kernel into an f32 shared-memory tile;
//   4. loops over M in chunks of 64 rows, double-buffered (chunk c + 1
//      loads while chunk c is multiplied): bf16 by mma.sync m16n8k16 with
//      f32 accumulators over 16-row tiles (M is padded to 16, not 64),
//      f32 by f32 FMAs in K order, each thread 8 rows x 4 columns;
//   5. writes its f32 partial [M, bn] to scratch.
// A second small kernel sums the partials over the splits in split order
// and rounds once to the output type.  Split count, split boundaries and
// summation order depend on (K, N, block) alone, never on M, and every
// product of a row sees only that row, so a row's result is the same bits
// in a call of any M.  No float atomics: the sums are deterministic.
//
// Cost that remains: the f32 partials, splits x M x N x 4 bytes written
// and read again (about 250 MB a layer at M = 256, L2-resident at M = 20).
#include "decompress.cuh"

namespace {

constexpr int NT = 256;                // threads per block, 8 warps
constexpr int MC = 64;                 // x rows staged per chunk

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared memory of one block, in this order: the slice's bitmap words,
// their ranks, the scan scratch, the staged packed values (an aligned
// start and end: up to 14 more than the slice's rps * bn), two x chunks of
// MC rows (a row padded by 16 bytes against bank conflicts) and, for the
// f32 kernel, the expanded slice.  kernels/sparse_matmul.py:launch_plan
// computes the same byte count; the launchers refuse any other.
struct Layout {
  int ldx;
  size_t off_off, off_scr, off_v, off_x, off_w, bytes;
  __host__ __device__ Layout(int rps, int bn, int x_bytes, int v_bytes) {
    const size_t nw = static_cast<size_t>(rps) * bn / 32;
    ldx = rps + 16 / x_bytes;
    off_off = nw * 4;
    off_scr = off_off + nw * 4;
    off_v = align16(off_scr + 32 * 4);
    off_x = align16(off_v + (static_cast<size_t>(rps) * bn + 16) * v_bytes);
    off_w = align16(off_x + static_cast<size_t>(2) * MC * ldx * x_bytes);
    // the f32 kernel (4-byte x) expands into an f32 tile
    bytes = off_w + (x_bytes == 4 ? static_cast<size_t>(rps) * bn * 4 : 0);
  }
};

struct Args {
  const void* x;
  const uint32_t* bitmap;
  const void* values;
  float* partial;                      // [splits, M, Nb * bn]
  int M, K, Nb, bk, bn, cap, rps;
};

// Stage this block's slice (stage_slice: words, ranks, then the packed
// values); returns the index of the value s_v[0] holds.
template <typename TV>
__device__ int stage_values(const Args& a, size_t blk, const Split& sp,
                            uint32_t* s_words, int* s_off, int* s_scr,
                            TV* s_v) {
  constexpr int VB = sizeof(TV);
  const uint8_t* vals =
      static_cast<const uint8_t*>(a.values) + blk * a.cap * VB;
  return stage_slice(a.bitmap + blk * (a.bk * a.bn / 32), a.bn, sp.r0,
                     sp.r0 + sp.rows, vals, a.cap * VB, a.cap, 8 * VB,
                     s_words, s_off, s_scr,
                     reinterpret_cast<uint8_t*>(s_v)) / VB;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bf16 bits of slice position p: 0 where the bit is clear.
__device__ __forceinline__ uint32_t bits_at(int p, const uint32_t* s_words,
                                            const int* s_off, int cap,
                                            const uint16_t* s_v, int lo_a) {
  const int r = packed_rank(p, s_words, s_off, cap);
  return r < 0 ? 0u : s_v[r - lo_a];
}

__global__ void __launch_bounds__(NT) sparse_matmul_bf16(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(a.rps, a.bn, 2, 2);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  int* s_off = reinterpret_cast<int*>(smem + L.off_off);
  int* s_scr = reinterpret_cast<int*>(smem + L.off_scr);
  uint16_t* s_v = reinterpret_cast<uint16_t*>(smem + L.off_v);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + L.off_x);
  const int chunk = MC * L.ldx;

  const int nb = blockIdx.x, split = blockIdx.y;
  const Split sp(a.bk, a.rps, split);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const bool xvec =
      a.K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  stage_x(s_x, L.ldx, x, a.M, a.K, 0, MC, sp.kx0, a.rps, xvec);
  cp_async_commit();

  const size_t blk = static_cast<size_t>(sp.kb) * a.Nb + nb;
  const int lo_a = stage_values(a, blk, sp, s_words, s_off, s_scr,
                                s_v);

  // Expand once, into the B fragments of m16n8k16 (k = 2t, 2t+1 and
  // 2t+8, 2t+9 of column g): warp w owns columns 16w .. 16w + 15, two n8
  // tiles, over the slice's (at most four) k16 steps.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = warp * 16;
  const bool active = n0 < a.bn;
  const int nks = sp.rows / 16;
  uint32_t bw[4][2][2];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v = 0;
        if (active && s < nks) {
          const int p = (s * 16 + h * 8 + 2 * tq) * a.bn + n0 + j * 8 + g;
          v = bits_at(p, s_words, s_off, a.cap, s_v, lo_a) |
              bits_at(p + a.bn, s_words, s_off, a.cap, s_v, lo_a) << 16;
        }
        bw[s][j][h] = v;
      }

  const size_t np = static_cast<size_t>(a.Nb) * a.bn;
  float* part = a.partial + static_cast<size_t>(split) * a.M * np +
                static_cast<size_t>(nb) * a.bn + n0 + 2 * tq;
  const int n_chunks = (a.M + MC - 1) / MC;
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks)
      stage_x(s_x + ((ch + 1) & 1) * chunk, L.ldx, x, a.M, a.K,
              (ch + 1) * MC, MC, sp.kx0, a.rps, xvec);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const __nv_bfloat16* xs = s_x + (ch & 1) * chunk;
    const int c0 = ch * MC;
    const int tiles = (min(MC, a.M - c0) + 15) / 16;
    if (active) {
      for (int mt = 0; mt < tiles; ++mt) {
        float acc[2][4] = {};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (s < nks) {
            const __nv_bfloat16* ap =
                xs + (mt * 16 + g) * L.ldx + s * 16 + 2 * tq;
            const uint32_t a0 = ld32(ap), a1 = ld32(ap + 8 * L.ldx);
            const uint32_t a2 = ld32(ap + 8), a3 = ld32(ap + 8 * L.ldx + 8);
            mma_bf16(acc[0], a0, a1, a2, a3, bw[s][0][0], bw[s][0][1]);
            mma_bf16(acc[1], a0, a1, a2, a3, bw[s][1][0], bw[s][1][1]);
          }
        }
        const int row = c0 + mt * 16 + g;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (row < a.M)
            *reinterpret_cast<float2*>(part + row * np + j * 8) =
                make_float2(acc[j][0], acc[j][1]);
          if (row + 8 < a.M)
            *reinterpret_cast<float2*>(part + (row + 8) * np + j * 8) =
                make_float2(acc[j][2], acc[j][3]);
        }
      }
    }
    __syncthreads();                   // before this buffer is refilled
  }
}

// f32 x: the same split and staging; the slice expands into an f32 tile
// [rps][bn] and thread (lane, warp) sums columns 4 lane .. 4 lane + 3 of
// rows 8 warp .. 8 warp + 7 of each chunk with f32 FMAs in K order.
template <typename TV>
__global__ void __launch_bounds__(NT) sparse_matmul_f32(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(a.rps, a.bn, 4, sizeof(TV));
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  int* s_off = reinterpret_cast<int*>(smem + L.off_off);
  int* s_scr = reinterpret_cast<int*>(smem + L.off_scr);
  TV* s_v = reinterpret_cast<TV*>(smem + L.off_v);
  float* s_x = reinterpret_cast<float*>(smem + L.off_x);
  float* s_w = reinterpret_cast<float*>(smem + L.off_w);
  const int chunk = MC * L.ldx;

  const int nb = blockIdx.x, split = blockIdx.y;
  const Split sp(a.bk, a.rps, split);
  const float* x = static_cast<const float*>(a.x);
  const bool xvec =
      a.K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  stage_x(s_x, L.ldx, x, a.M, a.K, 0, MC, sp.kx0, a.rps, xvec);
  cp_async_commit();

  const size_t blk = static_cast<size_t>(sp.kb) * a.Nb + nb;
  const int lo_a = stage_values(a, blk, sp, s_words, s_off, s_scr,
                                s_v);
  const int live = sp.rows * a.bn;
  for (int p = threadIdx.x; p < a.rps * a.bn; p += NT) {
    float v = 0.f;
    if (p < live) {
      const int r = packed_rank(p, s_words, s_off, a.cap);
      if (r >= 0) v = to_f32(s_v[r - lo_a]);
    }
    s_w[p] = v;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = 4 * lane, rb = 8 * warp;
  const bool active = c < a.bn;
  const size_t np = static_cast<size_t>(a.Nb) * a.bn;
  float* part = a.partial + static_cast<size_t>(split) * a.M * np +
                static_cast<size_t>(nb) * a.bn + c;
  const int n_chunks = (a.M + MC - 1) / MC;
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks)
      stage_x(s_x + ((ch + 1) & 1) * chunk, L.ldx, x, a.M, a.K,
              (ch + 1) * MC, MC, sp.kx0, a.rps, xvec);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();                   // also publishes s_w on the first
    const float* xr = s_x + (ch & 1) * chunk + rb * L.ldx;
    const int row0 = ch * MC + rb;
    if (active && row0 < a.M) {
      float acc[8][4] = {};
      for (int k = 0; k < sp.rows; k += 4) {
        float xv[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(xr + i * L.ldx + k);
          xv[i][0] = v.x; xv[i][1] = v.y; xv[i][2] = v.z; xv[i][3] = v.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 w =
              *reinterpret_cast<const float4*>(s_w + (k + kk) * a.bn + c);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][0] = fmaf(xv[i][kk], w.x, acc[i][0]);
            acc[i][1] = fmaf(xv[i][kk], w.y, acc[i][1]);
            acc[i][2] = fmaf(xv[i][kk], w.z, acc[i][2]);
            acc[i][3] = fmaf(xv[i][kk], w.w, acc[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (row0 + i < a.M)
          *reinterpret_cast<float4*>(part + (row0 + i) * np) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();                   // before this buffer is refilled
  }
}

// out = sum of the partials over the splits, in split order, rounded once.
template <typename TO>
__global__ void sum_partials(const float4* __restrict__ partial, int splits,
                             int count4, TO* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count4) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int k = 0; k < splits; ++k) {
    const float4 v = partial[static_cast<size_t>(k) * count4 + i];
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  store4(out + static_cast<size_t>(i) * 4, s);
}

template <typename TO, typename Kern>
cudaError_t run(Kern kern, const Layout& L, long smem, const Args& a, int Kb,
                void* out, cudaStream_t stream) {
  if (static_cast<size_t>(smem) != L.bytes) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(kern, L.bytes);
  if (e != cudaSuccess) return e;
  const int splits = Kb * ((a.bk + a.rps - 1) / a.rps);
  kern<<<dim3(a.Nb, splits), NT, L.bytes, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int count4 = a.M * a.Nb * a.bn / 4;
  sum_partials<TO><<<(count4 + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(a.partial), splits, count4,
      static_cast<TO*>(out));
  return cudaGetLastError();
}

// Also refuses a bitmap that is not 16-byte aligned: its words are read
// as uint4s.
bool bad_geometry(int M, int bk, int bn, int rps, const void* bitmap) {
  return M < 1 || bk % 16 != 0 || bn % 16 != 0 || bn > 128 || rps < 16 ||
         rps > 64 || rps % 16 != 0 || rps > bk ||
         reinterpret_cast<uintptr_t>(bitmap) % 16 != 0;
}

Args make_args(const void* x, int M, int K, const void* bitmap,
               const void* values, int Nb, int bk, int bn, int cap, int rps,
               void* partial) {
  Args a;
  a.x = x;
  a.bitmap = static_cast<const uint32_t*>(bitmap);
  a.values = values;
  a.partial = static_cast<float*>(partial);
  a.M = M; a.K = K; a.Nb = Nb; a.bk = bk; a.bn = bn; a.cap = cap;
  a.rps = rps;
  return a;
}

}  // namespace

// x [M, K] bf16 contiguous; bitmap [Kb, Nb, bk*bn/32] words; values
// [Kb, Nb, cap] bf16; partial f32 [Kb * ceil(bk/rps), M, Nb*bn] scratch;
// out [M, Nb*bn] bf16.  bk and bn multiples of 16, bn <= 128, rps a
// multiple of 16 in [16, min(64, bk)], the bitmap 16-byte aligned; smem
// the Layout's byte count.
// Returns cudaGetLastError().
REPRO_EXPORT int sparse_matmul_launch(const void* x, int M, int K,
                                      const void* bitmap, const void* values,
                                      int Kb, int Nb, int bk, int bn, int cap,
                                      int rps, long smem, void* partial,
                                      void* out, void* stream) {
  if (bad_geometry(M, bk, bn, rps, bitmap))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(x, M, K, bitmap, values, Nb, bk, bn, cap, rps,
                           partial);
  return static_cast<int>(run<__nv_bfloat16>(
      sparse_matmul_bf16, Layout(rps, bn, 2, 2), smem, a, Kb, out,
      static_cast<cudaStream_t>(stream)));
}

// x [M, K] f32 contiguous; values [Kb, Nb, cap] f32 or bf16 (v_dtype); out
// [M, Nb*bn] f32; the rest as above.  Returns cudaGetLastError().
REPRO_EXPORT int sparse_matmul_f32_launch(const void* x, int M, int K,
                                          const void* bitmap,
                                          const void* values, int v_dtype,
                                          int Kb, int Nb, int bk, int bn,
                                          int cap, int rps, long smem,
                                          void* partial, void* out,
                                          void* stream) {
  if (bad_geometry(M, bk, bn, rps, bitmap))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(x, M, K, bitmap, values, Nb, bk, bn, cap, rps,
                           partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (v_dtype == REPRO_BF16)
    e = run<float>(sparse_matmul_f32<__nv_bfloat16>,
                   Layout(rps, bn, 4, 2), smem, a, Kb, out, s);
  else if (v_dtype == REPRO_F32)
    e = run<float>(sparse_matmul_f32<float>, Layout(rps, bn, 4, 4), smem,
                   a, Kb, out, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
