// Fused prefix + tail flash-decode over the pooled sparse KV cache.
// Replaces repro/kernels/sparse_attention.py:
// sparse_decode_attention_fused_pallas, both branches: the flat pool
// (_fused_kernel) and the paged pool (_fused_kernel_paged); and
// sparse_decode_attention_pallas (_kernel), the prefix-only partial that
// returns (o, lse) for an lse merge.  All three are instantiations of the
// split kernel below: PAGED picks the arena, PARTIAL drops the tail splits
// (Tp = 0, no tail pointer or length is read) and has the merge also write
// lse = m + log(max(l, 1e-30)), the TPU kernel's epilogue.
//
// What both compute: one softmax per query row over each slot's valid
// compressed prefix blocks (bitmap + packed values per (bs, D) block,
// skipped past n_blocks[b]) and then the dense tail ring, masked per row
// as tok < tail_len[b] + row / G (row // G is the panel query; Q == 1 is
// the plain decode tick).  NEG_INF = -1e30 and l_safe = max(l, 1e-30) as
// in the reference, so a row with nothing valid returns 0, not NaN.
//
// Paged: the compressed prefix lives once in a pool-global arena
// [n_phys, Hkv, X] and slot b reaches its logical block i through
// phys = table[b * Sb + i]; the block is then addressed as (phys * Hkv + h)
// where the flat pool addresses (b * Hkv + h) * Sb + i.  The TPU kernel
// gets the table by scalar prefetch; here each thread block loads its own
// entry, and only for i < n_blocks[b]: entries past it are dead (in range,
// but pointing at pages another request may be rewriting) and neither they
// nor the pages they name are ever read.
//
// Bound on the H100: device-memory bytes (the compressed blocks and tail
// tokens each slot must read once); a decode query panel does ~4*QG*D
// flops per token, far below the ridge.  So the design is about latency:
// enough blocks in flight, one round trip to device memory per block.
//
// Design of the split kernel.  The TPU grid's sequential sequence axis
// becomes a grid axis: one thread block per (kv head, slot, split, row
// tile), a split being one prefix block or one bs-token tail panel, so
// Sb + Tp / bs splits whatever B, QG or the lengths (256 blocks at the
// serving decode tick).  A split past n_blocks[b], or a tail panel that
// no row of the tile can see, computes nothing.  A live block
//   1. stages its split with cp.async, 16 bytes at a time: the K and V
//      bitmap words and packed values together (the whole capacity: one
//      round trip, no wait for the counts), or the K and V tail rows;
//   2. computes the words' prefix popcounts in shared memory;
//   3. scores its rows straight from the staged block (each thread walks
//      one token row, 32 positions a word, rank by rank), in f32;
//   4. takes each row's split max m, weights p = exp(s - m) (f32) and sum
//      l, one warp per row;
//   5. sums p * V per (row, column) over the split's tokens in order,
//      from V's dense rows (a prefix block expands V once after the scan);
//   6. writes (acc, m, l) to the f32 scratch the wrapper allocates.
// Every block then takes a ticket from a per-(slot, head, row tile)
// counter after a __threadfence(); the last to arrive merges the live
// splits in split order, o = acc / max(l, 1e-30), and resets the counter
// to 0 for the next launch.  The merge follows merge_attn's arithmetic on
// (acc, m, l); it does not depend on which block arrived last.  A block
// holds at most row_tile query rows (16 at bs = D = 128); a wider panel
// takes more row tiles, each staging its split again, so a verify panel
// has no width limit.  A row's arithmetic (its dot products in D order,
// its warp reductions, its PV sum in token order, its merge in split
// order) never depends on the other rows, the panel width or B: row r of
// a Q-row panel at tail length L is bit-equal to a one-row panel of the
// same query at tail length L + r // G.  Scores and PV stay in f32 on
// CUDA cores; tensor cores are later work.
//
// The partial runs the same blocks with Sb splits, no tail panel (224
// blocks at the serving shape, where the first design's one block per
// (kv head, slot) walked the slot's blocks as a chain of round trips), so
// its (acc, m, l) for a prefix block are the fused kernel's bits.  The
// merge writes o as above and lse once per row.  A slot with n_blocks = 0
// has no live split: the merge runs over nothing, o = 0 and lse = -1e30 +
// log(1e-30), which rounds to -1e30 in f32.  The query panel has no width
// limit here either.
#include "decompress.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// The split kernel (flat and paged fused attention, the prefix-only partial)
// ---------------------------------------------------------------------------

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Query rows one block holds: up to 16, and at most 8 per thread in the
// scoring (threads per token row) and the PV sum (threads per column).
__host__ __device__ inline int split_row_tile(int bs, int D) {
  return imin(16, 8 * imin(imax(1, NT / bs), imax(1, NT / D)));
}

// Shared memory of one block (mirrored by attention_plan in
// kernels/sparse_attention.py): the tile's f32 query rows and scores, the
// scan scratch and the ticket flag, the split's V as dense rows of bs
// tokens, then either a tail panel's K rows or a prefix block's staging
// (K and V bitmap words, their prefix popcounts, the packed values up to
// capacity).  Dense rows are padded by 16 bytes, so that 16-byte row reads
// across a warp's tokens do not conflict.
struct SplitLayout {
  size_t q, p, scr, flag, vt, kt, kw, ko, vw, vo, kv, vv, bytes;
  int ld;                               // dense row stride, elements
  __host__ __device__ SplitLayout(int D, int bs, int rt, int ck, int cv,
                                  int cb) {
    const size_t W = static_cast<size_t>(bs) * D / 32;
    q = 0;
    p = q + static_cast<size_t>(rt) * D * 4;
    scr = p + static_cast<size_t>(rt) * bs * 4;
    flag = scr + 64 * 4;
    ld = D + 16 / cb;
    vt = align16(flag + 16);
    kt = vt + static_cast<size_t>(bs) * ld * cb;
    const size_t tail = kt + static_cast<size_t>(bs) * ld * cb;
    kw = kt;
    ko = align16(kw + W * 4);
    vw = align16(ko + W * 4);
    vo = align16(vw + W * 4);
    kv = align16(vo + W * 4);
    vv = align16(kv + static_cast<size_t>(ck) * cb);
    const size_t pre = align16(vv + static_cast<size_t>(cv) * cb);
    bytes = pre > tail ? pre : tail;
  }
};

template <typename TQ, typename TC>
struct SplitArgs {
  const TQ* q;
  const uint32_t* kbm;
  const TC* kval;
  const uint32_t* vbm;
  const TC* vval;
  const TC* ktail;
  const TC* vtail;
  const int* n_blocks;
  const int* tail_len;
  const int* table;
  int n_phys, H, QG, G, D, Sb, bs, ck, cv, Tp, NS, rt;
  float sm_scale;
  float* scratch;     // acc [B, H, NS, QG, D], then (m, l) [B, H, NS, QG, 2]
  int* tickets;       // [B, H, row tiles], zero between launches
  float* out;         // [B, H, QG, D]
  float* lse;         // [B, H, QG], the partial only
};

// Tail panels some row of a tile sees, the tile's last panel query being
// qlast: panel j holds tokens [j * bs, (j + 1) * bs) of the ring and is
// seen while j * bs < tl + qlast.  The live splits of the tile are the
// prefix blocks [0, nb) and the tail panels [Sb, Sb + this).
__device__ __forceinline__ int live_tail_panels(int tl, int qlast, int bs,
                                                int n_panels) {
  const int seen = tl + qlast;
  return seen <= 0 ? 0 : min(n_panels, (seen + bs - 1) / bs);
}

// n elements from device to shared memory: cp.async 16 bytes at a time
// where the source and the size allow, else element by element.  The
// caller waits (cp_async_wait0) and synchronises.
template <typename T>
__device__ __forceinline__ void stage_async(T* dst, const T* __restrict__ src,
                                            int n) {
  const int nbytes = n * static_cast<int>(sizeof(T));
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && nbytes % 16 == 0) {
    const char* s = reinterpret_cast<const char*>(src);
    char* d = reinterpret_cast<char*>(dst);
    for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x)
      cp_async16(d + 16 * i, s + 16 * i, true);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// `rows` rows of `cols` elements (contiguous in device memory) into shared
// rows of stride `ld`, as stage_async.
template <typename T>
__device__ __forceinline__ void stage_rows_async(T* dst, int ld,
                                                 const T* __restrict__ src,
                                                 int rows, int cols) {
  const int rb = cols * static_cast<int>(sizeof(T));
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && rb % 16 == 0) {
    const int per = rb / 16;
    for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
      const int r = i / per, c = i % per;
      cp_async16(reinterpret_cast<char*>(dst + static_cast<size_t>(r) * ld) +
                     16 * c,
                 reinterpret_cast<const char*>(src +
                                               static_cast<size_t>(r) * cols) +
                     16 * c,
                 true);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
      dst[static_cast<size_t>(i / cols) * ld + i % cols] = src[i];
  }
}

// Exclusive prefix popcounts of two staged bitmaps of n words each, o1 and
// o2 (the rank of each word's first set bit).  Every thread calls it;
// s_scr needs 64 ints.  Ends with a __syncthreads().
__device__ __forceinline__ void word_offsets2(const uint32_t* w1,
                                              const uint32_t* w2, int n,
                                              int* o1, int* o2, int* s_scr) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (n + NT - 1) / NT;
  const int j0 = t * per, j1 = min(j0 + per, n);
  int c1 = 0, c2 = 0;
  for (int j = j0; j < j1; ++j) {
    c1 += __popc(w1[j]);
    c2 += __popc(w2[j]);
  }
  int i1 = c1, i2 = c2;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u1 = __shfl_up_sync(0xffffffffu, i1, o);
    const int u2 = __shfl_up_sync(0xffffffffu, i2, o);
    if (lane >= o) {
      i1 += u1;
      i2 += u2;
    }
  }
  if (lane == 31) {
    s_scr[warp] = i1;
    s_scr[32 + warp] = i2;
  }
  __syncthreads();
  if (warp == 0) {
    const int v1 = lane < NWARP ? s_scr[lane] : 0;
    const int v2 = lane < NWARP ? s_scr[32 + lane] : 0;
    int e1 = v1, e2 = v2;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u1 = __shfl_up_sync(0xffffffffu, e1, o);
      const int u2 = __shfl_up_sync(0xffffffffu, e2, o);
      if (lane >= o) {
        e1 += u1;
        e2 += u2;
      }
    }
    if (lane < NWARP) {
      s_scr[lane] = e1 - v1;
      s_scr[32 + lane] = e2 - v2;
    }
  }
  __syncthreads();
  int r1 = s_scr[warp] + i1 - c1, r2 = s_scr[32 + warp] + i2 - c2;
  for (int j = j0; j < j1; ++j) {
    o1[j] = r1;
    o2[j] = r2;
    r1 += __popc(w1[j]);
    r2 += __popc(w2[j]);
  }
  __syncthreads();
}

// 32 dense values of one bitmap word from its packed values: position i is
// values[rank] where bit i is set (rank clamped to cap - 1, as the
// reference clamps its gather), else 0.
template <typename TC>
__device__ __forceinline__ void word_values(uint32_t w, int rank,
                                            const TC* vals, int cap,
                                            float* v) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const uint32_t on = (w >> i) & 1u;
    const float x = to_f32(vals[min(rank, cap - 1)]);
    v[i] = on ? x : 0.f;
    rank += static_cast<int>(on);
  }
}

// 32 consecutive values of a dense shared row (16-byte aligned).
__device__ __forceinline__ void row_values(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[c];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[c * 8 + 2 * k] = __uint_as_float(w[k] << 16);
      v[c * 8 + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}
__device__ __forceinline__ void row_values(const float* p, float* v) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 u = reinterpret_cast<const float4*>(p)[c];
    v[4 * c] = u.x;
    v[4 * c + 1] = u.y;
    v[4 * c + 2] = u.z;
    v[4 * c + 3] = u.w;
  }
}

// Scores of the tile's R rows against the split's bs tokens into s_p
// [R][bs]: one thread per (token, row group) walks the token's D values 32
// at a time (values32(tok, j, v) fills positions 32j..32j+31) and keeps one
// f32 dot product per row it owns, summed in D order with fmaf.  Tail
// tokens a row cannot see score NEG_INF.
template <int RPT, typename Values32>
__device__ __forceinline__ void score_rows(const float* s_q, float* s_p,
                                           int R, int D, int bs,
                                           float sm_scale, bool tail,
                                           int base, int vis0, int row0,
                                           int G, Values32 values32) {
  const int nrg = max(1, NT / bs);
  for (int it = threadIdx.x; it < bs * nrg; it += NT) {
    const int tok = it % bs, rg = it / bs;
    if (rg >= R) continue;
    const float* qr[RPT];
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qr[i] = s_q + min(rg + i * nrg, R - 1) * D;   // rows past R: discarded
      acc[i] = 0.f;
    }
    for (int j = 0; j < D / 32; ++j) {
      float v[32];
      values32(tok, j, v);
#pragma unroll
      for (int c = 0; c < 32; ++c) {
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          acc[i] = fmaf(qr[i][j * 32 + c], v[c], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + i * nrg;
      if (r < R) {
        float s = acc[i] * sm_scale;
        if (tail && !(base + tok < vis0 + (row0 + r) / G)) s = NEG_INF;
        s_p[r * bs + tok] = s;
      }
    }
  }
}

// sum_tok p[r][tok] * V[tok][d] for the tile's R rows into out [R][D]:
// one thread per (column, row group), tokens in order, fmaf.
template <int RPT, typename ValueAt>
__device__ __forceinline__ void pv_rows(const float* s_p, float* out, int R,
                                        int D, int bs, ValueAt value_at) {
  const int nrg = max(1, NT / D);
  for (int it = threadIdx.x; it < D * nrg; it += NT) {
    const int d = it % D, rg = it / D;
    if (rg >= R) continue;
    const float* pr[RPT];
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      pr[i] = s_p + min(rg + i * nrg, R - 1) * bs;
      acc[i] = 0.f;
    }
    for (int tok = 0; tok < bs; ++tok) {
      const float v = value_at(tok, d);
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(pr[i][tok], v, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + i * nrg;
      if (r < R) out[static_cast<size_t>(r) * D + d] = acc[i];
    }
  }
}

template <typename TQ, typename TC, bool PAGED, bool PARTIAL, int RPT>
__global__ void __launch_bounds__(NT, 2) split_decode_attention(
    const SplitArgs<TQ, TC> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, bs = a.bs, QG = a.QG, NS = a.NS;
  const SplitLayout L(D, bs, a.rt, a.ck, a.cv, sizeof(TC));
  float* s_q = reinterpret_cast<float*>(smem + L.q);
  float* s_p = reinterpret_cast<float*>(smem + L.p);
  int* s_scr = reinterpret_cast<int*>(smem + L.scr);
  int* s_flag = reinterpret_cast<int*>(smem + L.flag);

  const int h = blockIdx.x, b = blockIdx.y;
  const int split = blockIdx.z % NS, tile = blockIdx.z / NS;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const int row0 = tile * a.rt, R = min(a.rt, QG - row0);
  const int qlast = (row0 + R - 1) / a.G;
  const int nb = min(max(a.n_blocks[b], 0), a.Sb);
  // the partial has no tail and reads no tail length
  const int tl = PARTIAL ? 0 : a.tail_len[b];
  const int nt = PARTIAL ? 0 : live_tail_panels(tl, qlast, bs, a.Tp / bs);
  float* part = a.scratch;
  float* ml = a.scratch + static_cast<size_t>(gridDim.y) * a.H * NS * QG * D;

  if (split < a.Sb ? split < nb : split - a.Sb < nt) {
    const bool prefix = PARTIAL || split < a.Sb;
    const int base = prefix ? 0 : (split - a.Sb) * bs;
    const size_t prow = (bh * NS + split) * QG + row0;   // first partial row
    const int ld = L.ld;
    TC* s_vt = reinterpret_cast<TC*>(smem + L.vt);        // V rows [bs][ld]
    for (int i = t; i < R * D; i += NT)
      s_q[i] = to_f32(a.q[(bh * QG + row0) * D + i]);
    if (prefix) {
      const int W = bs * D / 32;
      // split < nb here: a live table entry (clamped into the arena)
      const size_t blk =
          PAGED ? static_cast<size_t>(min(max(a.table[static_cast<size_t>(b) *
                                                          a.Sb + split], 0),
                                          a.n_phys - 1)) * a.H + h
                : bh * a.Sb + split;
      uint32_t* s_kw = reinterpret_cast<uint32_t*>(smem + L.kw);
      int* s_ko = reinterpret_cast<int*>(smem + L.ko);
      uint32_t* s_vw = reinterpret_cast<uint32_t*>(smem + L.vw);
      int* s_vo = reinterpret_cast<int*>(smem + L.vo);
      TC* s_kv = reinterpret_cast<TC*>(smem + L.kv);
      TC* s_vv = reinterpret_cast<TC*>(smem + L.vv);
      stage_async(s_kw, a.kbm + blk * W, W);
      stage_async(s_vw, a.vbm + blk * W, W);
      stage_async(s_kv, a.kval + blk * a.ck, a.ck);
      stage_async(s_vv, a.vval + blk * a.cv, a.cv);
      cp_async_commit();
      cp_async_wait0();
      __syncthreads();
      word_offsets2(s_kw, s_vw, W, s_ko, s_vo, s_scr);
      // V once into dense rows (the tail panel's layout); K is scored
      // straight from its words
      for (int j = t; j < W; j += NT) {
        float v[32];
        word_values(s_vw[j], s_vo[j], s_vv, a.cv, v);
        TC* dst = s_vt + static_cast<size_t>(j * 32 / D) * ld + j * 32 % D;
#pragma unroll
        for (int i = 0; i < 32; ++i) dst[i] = from_f32<TC>(v[i]);
      }
      const int nwd = D / 32, ck = a.ck;
      score_rows<RPT>(s_q, s_p, R, D, bs, a.sm_scale, false, 0, 0, row0,
                      a.G, [&](int tok, int j, float* v) {
                        const int wi = tok * nwd + j;
                        word_values(s_kw[wi], s_ko[wi], s_kv, ck, v);
                      });
    } else {
      TC* s_kt = reinterpret_cast<TC*>(smem + L.kt);
      const size_t off = (bh * a.Tp + base) * D;
      stage_rows_async(s_kt, ld, a.ktail + off, bs, D);
      stage_rows_async(s_vt, ld, a.vtail + off, bs, D);
      cp_async_commit();
      cp_async_wait0();
      __syncthreads();
      score_rows<RPT>(s_q, s_p, R, D, bs, a.sm_scale, true, base, tl, row0,
                      a.G, [&](int tok, int j, float* v) {
                        row_values(s_kt + static_cast<size_t>(tok) * ld +
                                       j * 32, v);
                      });
    }
    __syncthreads();
    for (int r = warp; r < R; r += NWARP) {
      float* pr = s_p + r * bs;
      // split tokens row r sees: a whole prefix block, or the tail's first
      // tail_len + (its panel query) tokens
      const int vis = prefix ? bs : tl + (row0 + r) / a.G;
      float mx = NEG_INF;
      for (int j = lane; j < bs; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int j = lane; j < bs; j += 32) {
        const float pj = base + j < vis ? expf(pr[j] - mx) : 0.f;
        pr[j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        ml[2 * (prow + r)] = mx;
        ml[2 * (prow + r) + 1] = sum;
      }
    }
    __syncthreads();
    pv_rows<RPT>(s_p, part + prow * D, R, D, bs, [&](int tok, int d) {
      return to_f32(s_vt[static_cast<size_t>(tok) * ld + d]);
    });
  }

  // the ticket: the last of the tile's NS blocks merges them
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + bh * (gridDim.z / NS) + tile;
  if (t == 0) s_flag[0] = atomicAdd(ticket, 1) == NS - 1;
  __syncthreads();
  if (!s_flag[0]) return;
  __threadfence();
  for (int it = t; it < R * D; it += NT) {
    const int r = it / D, d = it % D, row = row0 + r;
    float m = NEG_INF, l = 0.f, acc = 0.f;
    // the live splits in order: prefix blocks [0, nb), tail panels
    // [Sb, Sb + nt)
    for (int k = 0; k < nb + nt; ++k) {
      const size_t o = (bh * NS + (k < nb ? k : a.Sb + k - nb)) * QG + row;
      const float ms = __ldcg(ml + 2 * o), ls = __ldcg(ml + 2 * o + 1);
      const float as = __ldcg(part + o * D + d);
      const float mn = fmaxf(m, ms);
      const float wa = expf(m - mn), wb = expf(ms - mn);
      acc = fmaf(as, wb, acc * wa);
      l = fmaf(ls, wb, l * wa);
      m = mn;
    }
    const float l_safe = fmaxf(l, 1e-30f);
    a.out[(bh * QG + row) * D + d] = acc / l_safe;
    if (PARTIAL && d == 0) a.lse[bh * QG + row] = m + logf(l_safe);
  }
  if (t == 0) *ticket = 0;
}

template <typename TQ, typename TC, bool PAGED, bool PARTIAL>
cudaError_t run_split(const SplitArgs<TQ, TC>& a, int B, int tiles,
                      long smem, cudaStream_t stream) {
  const SplitLayout L(a.D, a.bs, a.rt, a.ck, a.cv, sizeof(TC));
  if (static_cast<size_t>(smem) != L.bytes || smem > 232448)
    return cudaErrorInvalidValue;
  const int rmax = imin(a.QG, a.rt);
  const int nrg_s = imax(1, NT / a.bs), nrg_v = imax(1, NT / a.D);
  const int need =
      imax((rmax + nrg_s - 1) / nrg_s, (rmax + nrg_v - 1) / nrg_v);
  void (*kern)(const SplitArgs<TQ, TC>);
  if (need <= 1) kern = split_decode_attention<TQ, TC, PAGED, PARTIAL, 1>;
  else if (need <= 2) kern = split_decode_attention<TQ, TC, PAGED, PARTIAL, 2>;
  else if (need <= 4) kern = split_decode_attention<TQ, TC, PAGED, PARTIAL, 4>;
  else if (need <= 8) kern = split_decode_attention<TQ, TC, PAGED, PARTIAL, 8>;
  else return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(kern, L.bytes);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.H, B, a.NS * tiles), NT, L.bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool PAGED, bool PARTIAL>
int dispatch_split(const void* q, int q_dtype, const void* kbm,
                   const void* kval, const void* vbm, const void* vval,
                   const void* ktail, const void* vtail, int c_dtype,
                   const void* n_blocks, const void* tail_len,
                   const void* table, int n_phys, int B, int H, int QG, int G,
                   int D, int Sb, int bs, int ck, int cv, int Tp,
                   float sm_scale, int splits, int rt, int tiles, long smem,
                   void* scratch, void* tickets, void* out, void* lse,
                   void* stream) {
  if (G < 1 || QG < 1 || QG % G != 0 || bs < 1 || D < 32 || D % 32 != 0 ||
      ck < 1 || cv < 1 || rt != split_row_tile(bs, D) ||
      tiles != (QG + rt - 1) / rt || (PAGED && n_phys < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // the splits: the partial's are its prefix blocks alone; the fused
  // kernels' are the prefix blocks and at least one tail panel
  const bool split_ok =
      PARTIAL ? Tp == 0 && Sb >= 1 && splits == Sb && lse != nullptr
              : Tp >= bs && Tp % bs == 0 && Sb >= 0 &&
                    splits == Sb + Tp / bs;
  if (!split_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define REPRO_SPLIT_ARGS(TQ, TC)                                            \
  SplitArgs<TQ, TC>{static_cast<const TQ*>(q),                              \
                    static_cast<const uint32_t*>(kbm),                      \
                    static_cast<const TC*>(kval),                           \
                    static_cast<const uint32_t*>(vbm),                      \
                    static_cast<const TC*>(vval),                           \
                    static_cast<const TC*>(ktail),                          \
                    static_cast<const TC*>(vtail),                          \
                    static_cast<const int*>(n_blocks),                      \
                    static_cast<const int*>(tail_len),                      \
                    static_cast<const int*>(table),                         \
                    n_phys, H, QG, G, D, Sb, bs, ck, cv, Tp, splits, rt,    \
                    sm_scale, static_cast<float*>(scratch),                 \
                    static_cast<int*>(tickets), static_cast<float*>(out),   \
                    static_cast<float*>(lse)}
  if (q_dtype == REPRO_BF16 && c_dtype == REPRO_BF16)
    e = run_split<__nv_bfloat16, __nv_bfloat16, PAGED, PARTIAL>(
        REPRO_SPLIT_ARGS(__nv_bfloat16, __nv_bfloat16), B, tiles, smem, s);
  else if (q_dtype == REPRO_F32 && c_dtype == REPRO_F32)
    e = run_split<float, float, PAGED, PARTIAL>(
        REPRO_SPLIT_ARGS(float, float), B, tiles, smem, s);
  else
    e = cudaErrorInvalidValue;
#undef REPRO_SPLIT_ARGS
  return static_cast<int>(e);
}

}  // namespace

// q [B, H, QG, D] (q_dtype); kbm/vbm [B, H, Sb, bs*D/32] words; kval/vval
// [B, H, Sb, ck|cv] and ktail/vtail [B, H, Tp, D] (c_dtype); n_blocks,
// tail_len int32 [B]; out f32 [B, H, QG, D].  The launch plan (splits =
// Sb + Tp / bs, the row tile, tiles = ceil(QG / row tile), the shared
// memory) must be attention_plan's; scratch f32 [B, H, splits, QG, D + 2];
// tickets int32 [B, H, tiles], zero, left zero.  Tp % bs == 0, QG % G == 0,
// D % 32 == 0.  Returns cudaGetLastError().
REPRO_EXPORT int fused_attention_launch(
    const void* q, int q_dtype, const void* kbm, const void* kval,
    const void* vbm, const void* vval, const void* ktail, const void* vtail,
    int c_dtype, const void* n_blocks, const void* tail_len, int B, int H,
    int QG, int G, int D, int Sb, int bs, int ck, int cv, int Tp,
    float sm_scale, int splits, int row_tile, int tiles, long smem,
    void* scratch, void* tickets, void* out, void* stream) {
  return dispatch_split<false, false>(
      q, q_dtype, kbm, kval, vbm, vval, ktail, vtail, c_dtype, n_blocks,
      tail_len, nullptr, 0, B, H, QG, G, D, Sb, bs, ck, cv, Tp, sm_scale,
      splits, row_tile, tiles, smem, scratch, tickets, out, nullptr, stream);
}

// The paged pool: kbm/vbm [n_phys, H, bs*D/32] words and kval/vval
// [n_phys, H, ck|cv] are the shared arena; table int32 [B, Sb] holds each
// slot's physical block ids (entries at or past n_blocks[b] are never
// read).  Everything else as fused_attention_launch.
REPRO_EXPORT int fused_attention_paged_launch(
    const void* q, int q_dtype, const void* kbm, const void* kval,
    const void* vbm, const void* vval, const void* ktail, const void* vtail,
    int c_dtype, const void* n_blocks, const void* tail_len,
    const void* table, int n_phys, int B, int H, int QG, int G, int D, int Sb,
    int bs, int ck, int cv, int Tp, float sm_scale, int splits, int row_tile,
    int tiles, long smem, void* scratch, void* tickets, void* out,
    void* stream) {
  return dispatch_split<true, false>(
      q, q_dtype, kbm, kval, vbm, vval, ktail, vtail, c_dtype, n_blocks,
      tail_len, table, n_phys, B, H, QG, G, D, Sb, bs, ck, cv, Tp, sm_scale,
      splits, row_tile, tiles, smem, scratch, tickets, out, nullptr, stream);
}

// The prefix-only partial over the flat layout: q [B, H, QG, D], the
// compressed prefix and n_blocks as fused_attention_launch; no tail.  The
// plan must be attention_plan(Sb, 0, ...)'s (splits = Sb >= 1); scratch
// f32 [B, H, Sb, QG, D + 2] and tickets as fused_attention_launch.  out
// f32 [B, H, QG, D] (normalised) and lse f32 [B, H, QG].  Any QG.
REPRO_EXPORT int partial_attention_launch(
    const void* q, int q_dtype, const void* kbm, const void* kval,
    const void* vbm, const void* vval, int c_dtype, const void* n_blocks,
    int B, int H, int QG, int D, int Sb, int bs, int ck, int cv,
    float sm_scale, int splits, int row_tile, int tiles, long smem,
    void* scratch, void* tickets, void* out, void* lse, void* stream) {
  return dispatch_split<false, true>(
      q, q_dtype, kbm, kval, vbm, vval, nullptr, nullptr, c_dtype, n_blocks,
      nullptr, nullptr, 0, B, H, QG, QG, D, Sb, bs, ck, cv, 0, sm_scale,
      splits, row_tile, tiles, smem, scratch, tickets, out, lse, stream);
}
