// Dense product y[M, N] = x[M, K] @ W^T with W stored as rows [N, K] and
// f32 output: the tied unembedding (logits = h @ tok.T).  Replaces
// repro/kernels/dense_matmul.py:dense_matmul_pallas on the serving path.
//
// Bound on the H100: device-memory bytes.  Serving calls it with M = 1
// (the last prefill token), the slots (decode), slots x (k + 1) (verify:
// 16, 20, 36), so it does 2*M flops per weight against a ~295 flop/byte
// ridge; the floor is the table read once (151936 x 1024 bf16 = 311 MB ->
// ~93 us; f32 622 MB -> ~186 us).
//
// Design: one pass over the table at every M <= 64.  The grid is one
// persistent block per SM; block b takes the 128-row tiles of the table
// b, b + grid, ... and streams them, K in stages, through a ring of
// NSTAGE shared-memory buffers filled by 16-byte cp.async copies
// (NSTAGE - 1 stages in flight), read in place through tok's [N, K] row
// layout (no tok.T copy exists anywhere).  Where not even 16 bf16 rows of
// x fit beside the ring (K > 4672: Llama-4-Scout's head at 5120,
// Llama-3-8B's w_down at 14336, Jamba's Mamba w_bcdt at 16384) x streams
// with the table, in K panels of one stage (the XS template argument), up
// to 64 rows a launch.  The K order, the MMAs and their operands, and so
// the result, are the same in both.
//   * bf16: x is staged once per block as the mma.sync A operand, M padded
//     to 16-row m-tiles (MT = 1..4, a template argument), rows padded by 64
//     bytes against bank conflicts; or, streamed, each stage carries x's
//     64-k panel beside the table's (rows padded the same way) and the
//     accumulators carry across the panels in registers.  Each warp owns
//     16 table rows (two n8 tiles) of a tile and runs mma.sync m16n8k16
//     with f32 accumulators: a table row's [N, K] layout is the
//     column-major B operand as it stands.  A lane's 16-byte read of 8
//     consecutive k (table and x alike) feeds two MMAs, k permuted within
//     each 32-k step the same way for A and B; the stage's 16-byte chunks
//     are XOR-swizzled by row parity so those reads are conflict-free.
//   * f32: f32 FMAs, not TF32.  A stage holds 32 k of the tile's rows
//     (padded by 16 bytes) and of x's MB rows (MB the bucket of M); thread
//     (n, h) sums table row n against half of x's rows or, from 8 rows up,
//     rows n and n + 64 against a quarter (each shared-memory read of x
//     then serves two table rows), in K order.
// A row of x lands in the same m-tile position (bf16) or the same FMA
// chain (f32) at every M, and the K order never changes, so a row's
// result is the same bits in a call of any M.  The wrapper launches once
// per 64 rows.
#include "decompress.cuh"

namespace {

constexpr int NT = 256;                // threads per block, 8 warps
constexpr int BN = 128;                // table rows (output columns) a tile
constexpr int NSTAGE = 5;              // ring buffers
constexpr int MAXM = 64;               // rows of x a launch takes
constexpr int KC16 = 64;               // bf16: K of a stage (128 bytes)
constexpr int KC32 = 32;               // f32: K of a stage (128 bytes)
constexpr int LDW32 = KC32 + 4;        // f32: a staged row, padded

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared memory: bf16, x as [rows][ldx] (rows = 16 * MT; ldx the padded K,
// 32 elements past a multiple of 64) then the ring, a stage being BN rows
// of 128 bytes; bf16 streamed, the ring alone, a stage being BN rows of 128
// bytes and then x's rows of one 64-k panel (ldx = 64 + 32, the same
// padding); f32, the ring alone, a stage being BN rows of LDW32 f32 and
// then x's rows (rows = MB) of KC32 f32.  kernels/dense_matmul.py:
// dense_plan computes the same byte count; the launcher refuses any other.
constexpr int LDXS = KC16 + 32;        // bf16 streamed: a staged x row
struct Layout {
  int ldx;
  size_t off_ring, stage, bytes;
  __host__ __device__ Layout(int w_bytes, int rows, int K, bool xs = false) {
    if (w_bytes == 2 && xs) {
      ldx = LDXS;
      off_ring = 0;
      stage = static_cast<size_t>(BN) * KC16 * 2 +
              align16(static_cast<size_t>(rows) * LDXS * 2);
    } else if (w_bytes == 2) {
      ldx = (K + KC16 - 1) / KC16 * KC16 + 32;
      off_ring = align16(static_cast<size_t>(rows) * ldx * 2);
      stage = static_cast<size_t>(BN) * KC16 * 2;
    } else {
      ldx = 0;
      off_ring = 0;
      stage = static_cast<size_t>(BN) * LDW32 * 4 +
              static_cast<size_t>(rows) * KC32 * 4;
    }
    bytes = off_ring + NSTAGE * stage;
  }
};

template <typename T>
struct Args {
  const T* x;                          // [M, K]
  const T* w;                          // rows [N, K], row stride ldw
  float* out;                          // [M, N]
  int M, K, N;
  long long ldw;
};

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

// The tiles of this block: b, b + grid, ...; `total` stages of K in all.
struct Walk {
  int nkc, total;
  __device__ Walk(int K, int N, int kc) {
    const int tiles = (N + BN - 1) / BN;
    nkc = (K + kc - 1) / kc;
    total = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) /
            gridDim.x * nkc;
  }
  __device__ int tile(int s) const { return blockIdx.x + s / nkc * gridDim.x; }
};

template <int MT, bool XS>
__global__ void __launch_bounds__(NT, 1)
unembed_bf16(const Args<__nv_bfloat16> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int WSTAGE = BN * KC16 * 2;
  const Layout L(2, 16 * MT, a.K, XS);
  const int STAGE = static_cast<int>(L.stage);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + L.off_ring;
  const Walk wk(a.K, a.N, KC16);
  const int t = threadIdx.x;

  // stage s: tile rows x 64 k, chunk c of row r at (r, c ^ 4 (r & 1));
  // streamed, then x's rows of the same 64 k, zeros past M and K
  auto load = [&](int s) {
    const int n0 = wk.tile(s) * BN, k0 = s % wk.nkc * KC16;
    unsigned char* buf = ring + s % NSTAGE * STAGE;
    for (int i = t; i < BN * 8; i += NT) {
      const int r = i >> 3, c = i & 7;
      const int n = n0 + r, k = k0 + c * 8;
      const bool ok = n < a.N && k < a.K;
      cp_async16(buf + (r * 8 + (c ^ ((r & 1) << 2))) * 16,
                 ok ? a.w + n * a.ldw + k : a.w, ok);
    }
    if (XS) {
      __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(buf + WSTAGE);
      for (int i = t; i < 16 * MT * 8; i += NT) {
        const int r = i >> 3, k = k0 + (i & 7) * 8;
        const bool ok = r < a.M && k < a.K;
        cp_async16(xb + r * LDXS + (i & 7) * 8,
                   ok ? a.x + static_cast<size_t>(r) * a.K + k : a.x, ok);
      }
    }
  };
  // whole: x once, zeros past M and K (up to the last stage's K)
  const int xch = XS ? 0 : wk.nkc * (KC16 / 8);
  for (int i = t; i < 16 * MT * xch; i += NT) {
    const int r = i / xch, k = i % xch * 8;
    const bool ok = r < a.M && k < a.K;
    cp_async16(s_x + r * L.ldx + k,
               ok ? a.x + static_cast<size_t>(r) * a.K + k : a.x, ok);
  }
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < wk.total) load(s);
    cp_async_commit();
  }

  const int warp = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
  float acc[MT][2][4];
  for (int s = 0; s < wk.total; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();                   // stage s landed; s - 1's buffer free
    if (s + NSTAGE - 1 < wk.total) load(s + NSTAGE - 1);
    cp_async_commit();
    const int kc = s % wk.nkc;
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    }
    const unsigned char* buf = ring + s % NSTAGE * STAGE;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // this 32-k step: lane (g, tq) holds k = 8 tq .. 8 tq + 7 of its
      // rows; words 0, 1 are the MMA's k slots 2 tq and 2 tq + 8 of the
      // first MMA, words 2, 3 of the second
      uint4 b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = warp * 16 + j * 8 + g;
        b[j] = *reinterpret_cast<const uint4*>(
            buf + (r * 8 + ((4 * h + tq) ^ ((r & 1) << 2))) * 16);
      }
      // x: the block's copy at k, or (streamed) this stage's panel
      const __nv_bfloat16* xs =
          XS ? reinterpret_cast<const __nv_bfloat16*>(buf + WSTAGE) : s_x;
      const int kx = (XS ? 0 : kc * KC16) + h * 32 + 8 * tq;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            xs + (mt * 16 + g) * L.ldx + kx);
        const uint4 v = *reinterpret_cast<const uint4*>(
            xs + (mt * 16 + g + 8) * L.ldx + kx);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[mt][j], u.x, v.x, u.y, v.y, b[j].x, b[j].y);
          mma_bf16(acc[mt][j], u.z, v.z, u.w, v.w, b[j].z, b[j].w);
        }
      }
    }
    if (kc == wk.nkc - 1) {
      const int n0 = wk.tile(s) * BN + warp * 16 + 2 * tq;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = mt * 16 + g + (e >> 1) * 8;
            const int n = n0 + j * 8 + (e & 1);
            if (row < a.M && n < a.N)
              a.out[static_cast<size_t>(row) * a.N + n] = acc[mt][j][e];
          }
    }
  }
  cp_async_wait0();
}

template <int MB>
__global__ void __launch_bounds__(NT, 1) unembed_f32(const Args<float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int WB = BN * LDW32 * 4;
  constexpr int STAGE = WB + MB * KC32 * 4;
  // table rows a thread sums: two from 8 x rows up, where x's reads
  // dominate, one below, where the table's do
  constexpr int NR = MB >= 8 ? 2 : 1;
  constexpr int NG = NT / (BN / NR);             // groups of x rows
  constexpr int MH = MB >= NG ? MB / NG : 1;     // x rows a thread sums
  const Walk wk(a.K, a.N, KC32);
  const int t = threadIdx.x;

  auto load = [&](int s) {
    const int n0 = wk.tile(s) * BN, k0 = s % wk.nkc * KC32;
    unsigned char* buf = smem + s % NSTAGE * STAGE;
    for (int i = t; i < BN * 8; i += NT) {
      const int r = i >> 3, k = k0 + (i & 7) * 4;
      const int n = n0 + r;
      const bool ok = n < a.N && k < a.K;
      cp_async16(buf + r * LDW32 * 4 + (i & 7) * 16,
                 ok ? a.w + n * a.ldw + k : a.w, ok);
    }
    for (int i = t; i < MB * 8; i += NT) {
      const int r = i >> 3, k = k0 + (i & 7) * 4;
      const bool ok = r < a.M && k < a.K;
      cp_async16(buf + WB + (r * KC32 + (i & 7) * 4) * 4,
                 ok ? a.x + static_cast<size_t>(r) * a.K + k : a.x, ok);
    }
  };
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < wk.total) load(s);
    cp_async_commit();
  }

  // thread (n, h) sums table rows n (and n + BN / 2) against x's rows
  // h * MH .. h * MH + MH - 1
  const int n = t % (BN / NR), h = t / (BN / NR);
  const bool active = h * MH < MB;
  float acc[NR][MH];
  for (int s = 0; s < wk.total; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    if (s + NSTAGE - 1 < wk.total) load(s + NSTAGE - 1);
    cp_async_commit();
    const int kc = s % wk.nkc;
    if (kc == 0) {
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int i = 0; i < MH; ++i) acc[r][i] = 0.f;
    }
    const unsigned char* buf = smem + s % NSTAGE * STAGE;
    if (active) {
      const float* ws = reinterpret_cast<const float*>(buf) + n * LDW32;
      const float* xs = reinterpret_cast<const float*>(buf + WB) +
                        h * MH * KC32;
#pragma unroll
      for (int kk = 0; kk < KC32; kk += 4) {
        float4 wv[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r)
          wv[r] = *reinterpret_cast<const float4*>(
              ws + r * (BN / NR) * LDW32 + kk);
#pragma unroll
        for (int i = 0; i < MH; ++i) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + i * KC32 + kk);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            acc[r][i] = fmaf(xv.x, wv[r].x, acc[r][i]);
            acc[r][i] = fmaf(xv.y, wv[r].y, acc[r][i]);
            acc[r][i] = fmaf(xv.z, wv[r].z, acc[r][i]);
            acc[r][i] = fmaf(xv.w, wv[r].w, acc[r][i]);
          }
        }
      }
    }
    if (kc == wk.nkc - 1 && active) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int col = wk.tile(s) * BN + r * (BN / NR) + n;
#pragma unroll
        for (int i = 0; i < MH; ++i) {
          const int row = h * MH + i;
          if (row < a.M && col < a.N)
            a.out[static_cast<size_t>(row) * a.N + col] = acc[r][i];
        }
      }
    }
  }
  cp_async_wait0();
}

// One block per SM (the kernels ask for the whole ring), at most a tile
// each.
template <typename Kern, typename A>
cudaError_t launch(Kern kern, const A& a, size_t smem, cudaStream_t stream) {
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tiles = (a.N + BN - 1) / BN;
  kern<<<tiles < sms ? tiles : sms, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t run_bf16(const Args<__nv_bfloat16>& a, long smem,
                     cudaStream_t s) {
  const int mt = (a.M + 15) / 16;
  const size_t bytes = static_cast<size_t>(smem);
  // x whole
  if (bytes == Layout(2, 16 * mt, a.K).bytes) switch (mt) {
      case 1: return launch(unembed_bf16<1, false>, a, bytes, s);
      case 2: return launch(unembed_bf16<2, false>, a, bytes, s);
      case 3: return launch(unembed_bf16<3, false>, a, bytes, s);
      default: return launch(unembed_bf16<4, false>, a, bytes, s);
    }
  // x streamed in K panels (kernels/dense_matmul.py:dense_plan takes it
  // only where x whole does not fit, so the byte counts never name two
  // layouts)
  if (bytes == Layout(2, 16 * mt, a.K, true).bytes) switch (mt) {
      case 1: return launch(unembed_bf16<1, true>, a, bytes, s);
      case 2: return launch(unembed_bf16<2, true>, a, bytes, s);
      case 3: return launch(unembed_bf16<3, true>, a, bytes, s);
      default: return launch(unembed_bf16<4, true>, a, bytes, s);
    }
  return cudaErrorInvalidValue;
}

cudaError_t run_f32(const Args<float>& a, long smem, cudaStream_t s) {
  // the row buckets; kernels/dense_matmul.py:F32_BUCKETS
  const int mb = a.M <= 1 ? 1 : a.M <= 2 ? 2 : a.M <= 4 ? 4 : a.M <= 8 ? 8
               : a.M <= 16 ? 16 : a.M <= 32 ? 32 : a.M <= 48 ? 48 : 64;
  const Layout L(4, mb, a.K);
  if (static_cast<size_t>(smem) != L.bytes) return cudaErrorInvalidValue;
  switch (mb) {
    case 1: return launch(unembed_f32<1>, a, L.bytes, s);
    case 2: return launch(unembed_f32<2>, a, L.bytes, s);
    case 4: return launch(unembed_f32<4>, a, L.bytes, s);
    case 8: return launch(unembed_f32<8>, a, L.bytes, s);
    case 16: return launch(unembed_f32<16>, a, L.bytes, s);
    case 32: return launch(unembed_f32<32>, a, L.bytes, s);
    case 48: return launch(unembed_f32<48>, a, L.bytes, s);
    default: return launch(unembed_f32<64>, a, L.bytes, s);
  }
}

}  // namespace

// x [M, K] contiguous; w rows [N, K] with row stride ldw (elements), unit
// column stride; out f32 [M, N].  M in [1, 64]; K and ldw multiples of 8;
// x and w 16-byte aligned (16-byte copies); smem the Layout's byte count.
// Returns cudaGetLastError().
REPRO_EXPORT int dense_matmul_launch(const void* x, int dtype, int M, int K,
                                     const void* w, int N, long long ldw,
                                     long smem, void* out, void* stream) {
  if (M < 1 || M > MAXM || K < 1 || N < 1 || K % 8 != 0 || ldw % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == REPRO_BF16)
    e = run_bf16({static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(w),
                  static_cast<float*>(out), M, K, N, ldw},
                 smem, s);
  else if (dtype == REPRO_F32)
    e = run_f32({static_cast<const float*>(x), static_cast<const float*>(w),
                 static_cast<float*>(out), M, K, N, ldw},
                smem, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
