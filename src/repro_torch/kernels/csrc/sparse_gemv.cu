// Sparse GEMV: y[M<=8, N] = x[M, K] @ unpack(W) for the decode-tick linears.
// Replaces repro/kernels/sparse_gemv.py:sparse_gemv_pallas.
//
// Bound on the H100: device-memory bytes.  At M <= 8 the product does
// 2*M flops per stored weight, far below the ~295 flop/byte ridge, so the
// time floor is (bitmap + packed values + x + y) / 3.35 TB/s: 5.34 us for
// the seven linears of a Qwen3-0.6B layer.  Each linear moves 1-3.5 MB, so
// what a launch can reach is a few dependent device-memory round trips.
//
// Design.  The TPU kernel carries an f32 accumulator across a sequential K
// grid axis.  Here the reduction over K is split across thread blocks:
// one block per (column block, split), a split being `rps` rows of one
// compressed (bk, bn) block (kernels/sparse_gemv.py:gemv_plan), so the
// seven linears launch 128-384 blocks.  `rps` is 64: traced per layer at
// M = 4 on an H100 (NVIDIA H100 80GB HBM3, 700 W; tools/gemv_probe.py),
// 64 took 71 us against 98 us at 32 (256-768 blocks, twice the partials
// to merge) and 74 us at 32 for the k / v projections alone.  A block
//   1. loads its slice's x columns into registers (M rows, f32), so their
//      round trip overlaps the next step's;
//   2. stages the slice (stage_slice): its bitmap words with 16-byte loads
//      and their absolute ranks, then the packed values those ranks reach,
//      16-byte loads again.  Nothing is gathered from device memory;
//   3. expands each position from shared memory and multiplies it into
//      MB row accumulators (MB = 1, 2, 4 or 8, the bucket of M, a
//      template argument: a 4-row tick does 4 rows of FMAs, not 8); thread
//      (cq, g) owns four adjacent columns and a run of rows g of the
//      slice, in row order, so each shared-memory read of a bitmap word,
//      its rank and an x value serves four positions (the expansion is
//      bound by shared-memory wavefronts, not by FMAs);
//   4. sums its row groups in group order and writes its f32 partial;
//   5. takes a ticket for its column block after a __threadfence(): the
//      last of the column block's splits to arrive sums their partials in
//      split order, rounds once to the output type and resets the ticket.
// One launch per linear: no second kernel, and the partial scratch and the
// tickets are allocated once per device by the wrapper.  What remains is
// a chain of round trips, not bytes: the probe's variants put a layer's
// 71 us at M = 4 into about 7 of launches, 29 of staging (x and the bitmap,
// then the values their ranks reach), 13 of expansion and 22 of the
// fence, ticket and merge, against a 5.34 us bound.  Split count,
// boundaries and summation order depend on (K, N, block) alone, and each
// row's products are explicit fmaf in slice-row order, so a row's result
// is the same bits in a call of any M <= 8.  No float atomics.
#include "decompress.cuh"

namespace {

constexpr int NT = 256;                // threads per block
constexpr int MAXM = 8;                // rows of x the gemv takes
constexpr int MAX_RPS = 64;            // rows of one split, at most
constexpr int MERGE_DEPTH = 16;        // partials the merge loads at once

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared memory of one block, in this order: the slice's bitmap words,
// their ranks, the scan scratch and the ticket flag, the staged packed
// values (an aligned start and end: up to 32 bytes more than the slice's
// rps * bn values), x's slice columns as f32 [MAXM][rps], and the row
// groups' sums [NT / (bn / 4)][MAXM][bn].  kernels/sparse_gemv.py:gemv_plan
// computes the same byte count; the launcher refuses any other.
struct Layout {
  size_t off_off, off_scr, off_v, off_x, off_red, bytes;
  __host__ __device__ Layout(int rps, int bn, int v_bytes) {
    const size_t nw = static_cast<size_t>(rps) * bn / 32;
    off_off = nw * 4;
    off_scr = off_off + nw * 4;
    off_v = align16(off_scr + 33 * 4);
    off_x = align16(off_v + static_cast<size_t>(rps) * bn * v_bytes + 32);
    off_red = align16(off_x + static_cast<size_t>(MAXM) * rps * 4);
    bytes = off_red + static_cast<size_t>(NT) * MAXM * 16;
  }
};

struct Args {
  const void* x;
  const uint32_t* bitmap;
  const void* values;
  float* partial;                      // [splits, M, Nb * bn]
  int* tickets;                        // [Nb], zero between launches
  void* out;                           // [M, Nb * bn], x's dtype
  int M, K, Nb, bk, bn, cap, rps, splits;
};

template <typename TX, typename TV, int MB>
__global__ void __launch_bounds__(NT) sparse_gemv(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(a.rps, a.bn, sizeof(TV));
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  int* s_off = reinterpret_cast<int*>(smem + L.off_off);
  int* s_scr = reinterpret_cast<int*>(smem + L.off_scr);
  int* s_flag = s_scr + 32;
  const TV* s_v = reinterpret_cast<const TV*>(smem + L.off_v);
  float* s_x = reinterpret_cast<float*>(smem + L.off_x);
  float* s_red = reinterpret_cast<float*>(smem + L.off_red);

  const int t = threadIdx.x;
  const int nb = blockIdx.x, split = blockIdx.y;
  const Split sp(a.bk, a.rps, split);
  const TX* x = static_cast<const TX*>(a.x);

  // 1. x[m, kx0 + r] for m < MB, r < rps, as f32 (zeros past M, the
  // slice and K), held in registers across the staging below
  constexpr int XPT = (MB * MAX_RPS + NT - 1) / NT;
  float xv[XPT];
#pragma unroll
  for (int j = 0; j < XPT; ++j) {
    const int i = t + j * NT, m = i / a.rps, r = i % a.rps;
    const int k = sp.kx0 + r;
    xv[j] = (m < a.M && m < MB && r < sp.rows && k < a.K)
                ? to_f32(x[static_cast<size_t>(m) * a.K + k]) : 0.f;
  }

  // 2. the slice's words, ranks and packed values
  const size_t blk = static_cast<size_t>(sp.kb) * a.Nb + nb;
  constexpr int VB = sizeof(TV);
  const int lo_a = stage_slice(
      a.bitmap + blk * (a.bk * a.bn / 32), a.bn, sp.r0, sp.r0 + sp.rows,
      static_cast<const uint8_t*>(a.values) + blk * a.cap * VB, a.cap * VB,
      a.cap, 8 * VB, s_words, s_off, s_scr,
      reinterpret_cast<uint8_t*>(smem + L.off_v)) / VB;
#pragma unroll
  for (int j = 0; j < XPT; ++j) {
    const int i = t + j * NT;
    if (i < MB * a.rps) s_x[i] = xv[j];
  }
  __syncthreads();

  // 3. expand from shared memory, MB rows of FMAs per weight; thread
  // (cq, g) owns the four columns 4 cq .. 4 cq + 3 (one bitmap word's
  // bits, so a word, its rank and x's column are read once for four
  // positions) and a run of rows g; a clear bit multiplies a zero, as the
  // dense product does
  const int nq = a.bn / 4, ng = NT / nq;
  const int cq = t % nq, g = t / nq, c0 = 4 * cq;
  float acc[4][MB];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int m = 0; m < MB; ++m) acc[j][m] = 0.f;
  if (g < ng) {
    const int per = (sp.rows + ng - 1) / ng;
    const int q1 = min((g + 1) * per, sp.rows);
    const int b0 = c0 & 31, wpr = a.bn / 32;
    for (int q = g * per; q < q1; ++q) {
      const int wi = q * wpr + (c0 >> 5);
      const uint32_t w = s_words[wi];
      int r = s_off[wi] + __popc(w & ((1u << b0) - 1u));
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool set = (w >> (b0 + j)) & 1u;
        v[j] = set ? to_f32(s_v[min(r, a.cap - 1) - lo_a]) : 0.f;
        r += set;
      }
      const float* xq = s_x + q;
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const float xm = xq[m * a.rps];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j][m] = fmaf(xm, v[j], acc[j][m]);
      }
    }
#pragma unroll
    for (int m = 0; m < MB; ++m)
      *reinterpret_cast<float4*>(s_red + (g * MAXM + m) * a.bn + c0) =
          make_float4(acc[0][m], acc[1][m], acc[2][m], acc[3][m]);
  }
  __syncthreads();

  // 4. this split's partial, the row groups summed in group order
  const size_t np = static_cast<size_t>(a.Nb) * a.bn;
  const size_t col0 = static_cast<size_t>(nb) * a.bn;
  float* part = a.partial + static_cast<size_t>(split) * a.M * np + col0;
  for (int i = t; i < a.M * a.bn; i += NT) {
    const int m = i / a.bn, cc = i % a.bn;
    float s = s_red[m * a.bn + cc];
    for (int gg = 1; gg < ng; ++gg) s += s_red[(gg * MAXM + m) * a.bn + cc];
    part[m * np + cc] = s;
  }

  // 5. the ticket: the last of the column block's splits merges them
  __threadfence();
  __syncthreads();
  if (t == 0) s_flag[0] = atomicAdd(a.tickets + nb, 1) == a.splits - 1;
  __syncthreads();
  if (!s_flag[0]) return;
  __threadfence();
  const size_t stride = static_cast<size_t>(a.M) * np;
  const int c4n = a.bn / 4;
  TX* out = static_cast<TX*>(a.out);
  for (int i = t; i < a.M * c4n; i += NT) {
    const int m = i / c4n, cc = (i % c4n) * 4;
    const float* p = a.partial + m * np + col0 + cc;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < a.splits; k0 += MERGE_DEPTH) {
      float4 v[MERGE_DEPTH];
#pragma unroll
      for (int j = 0; j < MERGE_DEPTH; ++j)
        if (k0 + j < a.splits)
          v[j] = __ldcg(reinterpret_cast<const float4*>(p + (k0 + j) * stride));
#pragma unroll
      for (int j = 0; j < MERGE_DEPTH; ++j)
        if (k0 + j < a.splits) {
          s.x += v[j].x; s.y += v[j].y; s.z += v[j].z; s.w += v[j].w;
        }
    }
    store4(out + m * np + col0 + cc, s);
  }
  if (t == 0) a.tickets[nb] = 0;
}

template <typename TX, typename TV>
cudaError_t run(const Args& a, long smem, cudaStream_t stream) {
  const Layout L(a.rps, a.bn, sizeof(TV));
  if (static_cast<size_t>(smem) != L.bytes) return cudaErrorInvalidValue;
  void (*kern)(const Args);
  if (a.M <= 1) kern = sparse_gemv<TX, TV, 1>;
  else if (a.M <= 2) kern = sparse_gemv<TX, TV, 2>;
  else if (a.M <= 4) kern = sparse_gemv<TX, TV, 4>;
  else kern = sparse_gemv<TX, TV, 8>;
  cudaError_t e = allow_smem(kern, L.bytes);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.Nb, a.splits), NT, L.bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] (x_dtype, contiguous); bitmap [Kb, Nb, bk*bn/32] words, 16-byte
// aligned; values [Kb, Nb, cap] (v_dtype); partial f32 scratch of at least
// splits * M * Nb*bn; tickets int32 [Nb], zero, left zero; out [M, Nb*bn]
// in x's dtype.  M in [1, 8]; bk and bn multiples of 16, bn <= 256; rps a
// multiple of 16 in [16, min(64, bk)]; splits = Kb * ceil(bk / rps); smem
// the Layout's byte count.  Returns cudaGetLastError().
REPRO_EXPORT int sparse_gemv_launch(const void* x, int x_dtype, int M, int K,
                                    const void* bitmap, const void* values,
                                    int v_dtype, int Kb, int Nb, int bk,
                                    int bn, int cap, int rps, int splits,
                                    long smem, void* partial, void* tickets,
                                    void* out, void* stream) {
  if (M < 1 || M > MAXM || bk % 16 != 0 || bn % 16 != 0 || bn > NT ||
      rps < 16 || rps > MAX_RPS || rps % 16 != 0 || rps > bk ||
      splits != Kb * ((bk + rps - 1) / rps) ||
      reinterpret_cast<uintptr_t>(bitmap) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.bitmap = static_cast<const uint32_t*>(bitmap);
  a.values = values;
  a.partial = static_cast<float*>(partial);
  a.tickets = static_cast<int*>(tickets);
  a.out = out;
  a.M = M; a.K = K; a.Nb = Nb; a.bk = bk; a.bn = bn; a.cap = cap;
  a.rps = rps; a.splits = splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_dtype == REPRO_BF16 && v_dtype == REPRO_BF16)
    e = run<__nv_bfloat16, __nv_bfloat16>(a, smem, s);
  else if (x_dtype == REPRO_F32 && v_dtype == REPRO_BF16)
    e = run<float, __nv_bfloat16>(a, smem, s);
  else if (x_dtype == REPRO_F32 && v_dtype == REPRO_F32)
    e = run<float, float>(a, smem, s);
  else if (x_dtype == REPRO_BF16 && v_dtype == REPRO_F32)
    e = run<__nv_bfloat16, float>(a, smem, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
