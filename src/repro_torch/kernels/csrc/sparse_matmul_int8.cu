// Sparse int8 / int4 GEMM: y[M, N] = dequant(xq, sx) @ dequant(W), for
// every M (decode ticks, verify panels and prefill chunks alike).  One
// template, two instantiations:
//   INT4 = false replaces repro/kernels/sparse_matmul_int8.py:
//                sparse_matmul_int8_pallas (int8 packed values);
//   INT4 = true  replaces repro/kernels/sparse_matmul_int4.py:
//                sparse_matmul_int4_pallas (two int4 values per byte, low
//                nibble first, sign-extended by (x ^ 8) - 8).
//
// Bound on the H100: device-memory bytes at every M the serving paths use.
// A stored weight costs 1 byte (int8) or half a byte (int4) plus two bitmap
// bits (50 % density) against 2*M integer operations, so even a 256-row
// prefill chunk (about 400 op/byte for int8) stays under the int8
// tensor-core ridge (~590 op/byte).  For the seven linears of a Qwen3-0.6B
// layer at M = 4 the bound is 2.99 us (int8) and 1.82 us (int4): what a
// kernel can do about it is read each stored byte once, with as many SMs
// as possible pulling at once.
//
// Design.  The TPU kernel carries an int32 accumulator across a sequential
// K grid axis.  Here the reduction over K is split across thread blocks,
// as in sparse_matmul.cu: one block per (column block, split), a split
// being `rps` (64) rows of one compressed (bk, bn) block, so the seven
// linears launch 128 to 384 blocks on the 132 SMs whatever M is; M is a
// loop inside the block.  A block
//   1. starts the first x chunk (its rps int8 columns of 64 rows) on its
//      way with cp.async;
//   2. stages its slice's bitmap words and their ranks with 16-byte loads,
//      then the packed bytes those ranks reach (stage_slice);
//   3. expands the slice once, straight into the B fragments of
//      mma.sync m16n8k32 (s8) that each warp keeps in registers, 16
//      columns a warp: int8 bytes as stored; int4 rank r from byte r >> 1,
//      the low nibble when r is even, sign-extended (a slice's first rank
//      may be odd: the nibble is picked by the rank, not by the staged
//      start, and ranks clamp to cap - 1 as packed_rank clamps them);
//   4. loops over M in 64-row chunks, double-buffered (chunk c + 1 loads
//      while chunk c is multiplied), over 16-row tiles (M is padded to 16,
//      not 64), on the int8 tensor cores with int32 accumulators (the
//      largest |sum| is 127 * 127 * 3072, about 4.96e7, under 2^31);
//   5. writes its int32 partial [M, bn] to scratch.
// A second small kernel sums the partials over the splits and applies the
// reference's epilogue in its order, (float(acc) * sx[m]) * scale[n],
// rounding once to the output type.  Integer sums are exact in any order,
// so the result equals the plain version bit for bit and a row's result is
// the same bits in a call of any M.  No float arithmetic before the
// epilogue, and no atomics.
//
// Partials, not integer atomics into a zeroed accumulator, from the traces
// of tools/int_reduction_probe.py at M = 4, 16 and 256 (PERF.md).  The
// atomic design needs the same epilogue plus a memset: per layer of seven
// linears on the H100 (int8) it took 56 us of device time against 49 at
// M = 4 (the memsets alone 7.6 us, and seven more host enqueues), and
// about 333 against 206 at M = 256, where its 63M int32 atomics through L2
// cost the matmul kernel about 306 us against 122 for writing partials.  The partials
// are splits x M x N x 4 bytes (up to 50 MB a linear at M = 256), under a
// prefill chunk whose wall time is the host's.  Longer splits at large M
// would cut that traffic (exact sums allow a plan that depends on M), but
// while prefill is host-bound the plan stays one function of
// (K, N, block).
#include "decompress.cuh"

namespace {

constexpr int NT = 256;                // threads per block, 8 warps
constexpr int MC = 64;                 // x rows staged per chunk
constexpr int MAX_KS = 2;              // k32 steps of a slice (64 rows)

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared memory of one block, in this order: the slice's bitmap words,
// their ranks, the scan scratch, the staged packed bytes (an aligned start
// and end: up to 32 more than the slice's own) and two int8 x chunks of MC
// rows (a row padded by 16 bytes against bank conflicts).
// kernels/sparse_matmul_int8.py:int_launch_plan computes the same byte
// count; the launcher refuses any other.
struct Layout {
  int ldx;
  size_t off_off, off_scr, off_v, off_x, bytes;
  __host__ __device__ Layout(int rps, int bn, bool nibbles) {
    const size_t nw = static_cast<size_t>(rps) * bn / 32;
    ldx = rps + 16;
    off_off = nw * 4;
    off_scr = off_off + nw * 4;
    off_v = align16(off_scr + 32 * 4);
    const size_t v_bytes = static_cast<size_t>(rps) * bn / (nibbles ? 2 : 1);
    off_x = align16(off_v + v_bytes + 32);
    bytes = off_x + static_cast<size_t>(2) * MC * ldx;
  }
};

struct Args {
  const int8_t* xq;
  const uint32_t* bitmap;
  const uint8_t* values;
  int* partial;                        // [splits, M, Nb * bn]
  int M, K, Nb, bk, bn, cap, vstride, rps;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The int8 weight at bit b of the staged slice word w (whose first set bit
// has rank `off`), as a byte: 0 where the bit is clear.  Branch-free: the
// byte is read whether or not the bit is set (a clear bit's rank is that
// of the next set bit, at most one past the staged values, which the
// layout's slack covers), so the loads of a thread's lookups overlap.
// s_v[0] holds the block's value byte b_a.
template <bool INT4>
__device__ __forceinline__ uint32_t weight_at(uint32_t w, int b, int off,
                                              int cap, const uint8_t* s_v,
                                              int b_a) {
  const int r = min(off + __popc(w & ((1u << b) - 1u)), cap - 1);
  uint32_t v;
  if (INT4) {
    const int x = (s_v[(r >> 1) - b_a] >> ((r & 1) * 4)) & 0xF;
    v = static_cast<uint32_t>(((x ^ 8) - 8) & 0xFF);
  } else {
    v = s_v[r - b_a];
  }
  return ((w >> b) & 1u) ? v : 0u;
}

// Two adjacent int32 results of one row into the block's partial.
__device__ __forceinline__ void store_pair(int* p, int v0, int v1) {
  *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
}

template <bool INT4>
__global__ void __launch_bounds__(NT) sparse_matmul_int(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(a.rps, a.bn, INT4);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  int* s_off = reinterpret_cast<int*>(smem + L.off_off);
  int* s_scr = reinterpret_cast<int*>(smem + L.off_scr);
  uint8_t* s_v = smem + L.off_v;
  int8_t* s_x = reinterpret_cast<int8_t*>(smem + L.off_x);
  const int chunk = MC * L.ldx;

  const int nb = blockIdx.x, split = blockIdx.y;
  const Split sp(a.bk, a.rps, split);
  const bool xvec =
      a.K % 16 == 0 && (reinterpret_cast<uintptr_t>(a.xq) & 15) == 0;
  stage_x(s_x, L.ldx, a.xq, a.M, a.K, 0, MC, sp.kx0, a.rps, xvec);
  cp_async_commit();

  const size_t blk = static_cast<size_t>(sp.kb) * a.Nb + nb;
  const int b_a = stage_slice(
      a.bitmap + blk * (a.bk * a.bn / 32), a.bn, sp.r0, sp.r0 + sp.rows,
      a.values + blk * a.vstride, a.vstride, a.cap, INT4 ? 4 : 8, s_words,
      s_off, s_scr, s_v);

  // Expand once, into the B fragments of m16n8k32: register h of n8 tile j
  // at k32 step s holds k = 32s + 16h + 4tq .. + 3 of column n0 + 8j + g,
  // the lowest k in the lowest byte.  Warp w owns columns 16w .. 16w + 15,
  // which lie in one bitmap word of each row: a thread reads the word and
  // its rank once for both of its columns.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = warp * 16;
  const bool active = n0 < a.bn;
  const int nks = sp.rows / 32;
  uint32_t bw[MAX_KS][2][2] = {};
#pragma unroll
  for (int s = 0; s < MAX_KS; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (active && s < nks) {
          const int p = (s * 32 + h * 16 + 4 * tq + i) * a.bn + n0;
          const uint32_t w = s_words[p >> 5];
          const int off = s_off[p >> 5];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            bw[s][j][h] |= weight_at<INT4>(w, (p & 31) + j * 8 + g, off,
                                           a.cap, s_v, b_a) << (8 * i);
        }
      }

  const size_t np = static_cast<size_t>(a.Nb) * a.bn;
  int* part = a.partial + static_cast<size_t>(split) * a.M * np +
              static_cast<size_t>(nb) * a.bn + n0 + 2 * tq;
  const int n_chunks = (a.M + MC - 1) / MC;
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks)
      stage_x(s_x + ((ch + 1) & 1) * chunk, L.ldx, a.xq, a.M, a.K,
              (ch + 1) * MC, MC, sp.kx0, a.rps, xvec);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int8_t* xs = s_x + (ch & 1) * chunk;
    const int c0 = ch * MC;
    const int tiles = (min(MC, a.M - c0) + 15) / 16;
    if (active) {
      for (int mt = 0; mt < tiles; ++mt) {
        int acc[2][4] = {};
#pragma unroll
        for (int s = 0; s < MAX_KS; ++s) {
          if (s < nks) {
            const int8_t* ap = xs + (mt * 16 + g) * L.ldx + s * 32 + 4 * tq;
            const uint32_t a0 = ld32(ap), a1 = ld32(ap + 8 * L.ldx);
            const uint32_t a2 = ld32(ap + 16);
            const uint32_t a3 = ld32(ap + 8 * L.ldx + 16);
            mma_s8(acc[0], a0, a1, a2, a3, bw[s][0][0], bw[s][0][1]);
            mma_s8(acc[1], a0, a1, a2, a3, bw[s][1][0], bw[s][1][1]);
          }
        }
        const int row = c0 + mt * 16 + g;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (row < a.M)
            store_pair(part + row * np + j * 8, acc[j][0], acc[j][1]);
          if (row + 8 < a.M)
            store_pair(part + (row + 8) * np + j * 8, acc[j][2], acc[j][3]);
        }
      }
    }
    __syncthreads();                   // before this buffer is refilled
  }
}

// out[m, n] = (float(sum over the splits of partial[s, m, n]) * sx[m]) *
// scale[n], the reference's order, rounded once.  A block owns ET / ES
// column quads (four columns of one row each) of the flattened
// [M, np / 4]; ES lanes per quad sum every ES-th split and lane 0 adds the
// lanes' sums (integer sums: exact in any order) and writes.  A warp is 32
// adjacent quads of one lane, so its loads are coalesced either way.
constexpr int ET = 256;                // epilogue threads per block
// Up to this many quads (the card's 132 x 2048 resident threads at 8
// lanes a quad) 8 lanes share a quad's 16-48 splits, above it one thread
// walks them all.  tools/int_reduction_probe.py traced both on the H100
// (PERF.md): per layer of seven linears, 8 lanes take 13 us against 26 at
// M = 4, one lane 84 us against 104 at M = 256.
constexpr int FEW_QUADS = 132 * 2048 / 8;

template <typename TO, int ES>
__global__ void __launch_bounds__(ET) int_epilogue(
    const int4* __restrict__ partial, int splits, int M, int np4, int N,
    const float* __restrict__ sx, const float* __restrict__ scale,
    TO* __restrict__ out) {
  constexpr int EQ = ET / ES;
  __shared__ int4 s_sum[ES][EQ];
  const int q = threadIdx.x % EQ, lane = threadIdx.x / EQ;
  const int i = blockIdx.x * EQ + q;
  const int count4 = M * np4;
  int4 s = make_int4(0, 0, 0, 0);
  if (i < count4) {
#pragma unroll 4
    for (int k = lane; k < splits; k += ES) {
      const int4 v = partial[static_cast<size_t>(k) * count4 + i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
  }
  if (ES > 1) {
    s_sum[lane][q] = s;
    __syncthreads();
    if (lane != 0) return;
#pragma unroll
    for (int l = 1; l < ES; ++l) {
      const int4 v = s_sum[l][q];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
  }
  if (i >= count4) return;
  const int m = i / np4, n0 = (i % np4) * 4;
  const float f = sx[m];
  const int v[4] = {s.x, s.y, s.z, s.w};
  TO* o = out + static_cast<size_t>(m) * N;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = n0 + c;
    if (n < N)
      o[n] = from_f32<TO>(
          __fmul_rn(__fmul_rn(__int2float_rn(v[c]), f), scale[n]));
  }
}

template <bool INT4, typename TO>
cudaError_t run(const Args& a, long smem, int splits, const float* sx,
                const float* scale, int N, TO* out, cudaStream_t stream) {
  const Layout L(a.rps, a.bn, INT4);
  if (static_cast<size_t>(smem) != L.bytes) return cudaErrorInvalidValue;
  auto kern = sparse_matmul_int<INT4>;
  cudaError_t e = allow_smem(kern, L.bytes);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.Nb, splits), NT, L.bytes, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int np4 = a.Nb * a.bn / 4;
  const int count4 = a.M * np4;
  const int4* p4 = reinterpret_cast<const int4*>(a.partial);
  if (count4 <= FEW_QUADS)
    int_epilogue<TO, 8><<<(count4 + ET / 8 - 1) / (ET / 8), ET, 0, stream>>>(
        p4, splits, a.M, np4, N, sx, scale, out);
  else
    int_epilogue<TO, 1><<<(count4 + ET - 1) / ET, ET, 0, stream>>>(
        p4, splits, a.M, np4, N, sx, scale, out);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t run_either(bool nibbles, const Args& a, long smem, int splits,
                       const void* sx, const void* scale, int N, void* out,
                       cudaStream_t stream) {
  const float* fsx = static_cast<const float*>(sx);
  const float* fsc = static_cast<const float*>(scale);
  TO* o = static_cast<TO*>(out);
  return nibbles ? run<true>(a, smem, splits, fsx, fsc, N, o, stream)
                 : run<false>(a, smem, splits, fsx, fsc, N, o, stream);
}

}  // namespace

// xq int8 [M, K] contiguous; sx f32 [M]; bitmap [Kb, Nb, bk*bn/32] words,
// 16-byte aligned; values [Kb, Nb, vstride] bytes (int8, or nibble pairs
// when `nibbles`); cap = packed values per block (2 * vstride for
// nibbles); scale f32 [>= N]; partial int32 [Kb * ceil(bk/rps), M, Nb*bn]
// scratch; out [M, N] in out_dtype.  bk a multiple of 32, bn a multiple of
// 16 up to 128, rps a multiple of 32 in [32, min(32 * MAX_KS, bk)], smem
// the Layout's byte count.  Returns cudaGetLastError().
REPRO_EXPORT int sparse_matmul_int_launch(
    const void* xq, int M, int K, const void* bitmap, const void* values,
    int nibbles, int Kb, int Nb, int bk, int bn, int cap, int vstride,
    int rps, long smem, const void* sx, const void* scale, int N,
    void* partial, void* out, int out_dtype, void* stream) {
  if (M < 1 || bk % 32 != 0 || bn % 16 != 0 || bn > 128 || rps % 32 != 0 ||
      rps < 32 || rps > 32 * MAX_KS || rps > bk || N > Nb * bn ||
      K > Kb * bk || cap > vstride * (nibbles ? 2 : 1) ||
      reinterpret_cast<uintptr_t>(bitmap) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.xq = static_cast<const int8_t*>(xq);
  a.bitmap = static_cast<const uint32_t*>(bitmap);
  a.values = static_cast<const uint8_t*>(values);
  a.partial = static_cast<int*>(partial);
  a.M = M; a.K = K; a.Nb = Nb; a.bk = bk; a.bn = bn; a.cap = cap;
  a.vstride = vstride; a.rps = rps;
  const int splits = Kb * ((bk + rps - 1) / rps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (out_dtype == REPRO_BF16)
    e = run_either<__nv_bfloat16>(nibbles != 0, a, smem, splits, sx, scale,
                                  N, out, s);
  else if (out_dtype == REPRO_F32)
    e = run_either<float>(nibbles != 0, a, smem, splits, sx, scale, N, out,
                          s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
