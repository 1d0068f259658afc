// Fused prefix + tail flash-decode over the pooled sparse KV cache.
// Replaces repro/kernels/sparse_attention.py:
// sparse_decode_attention_fused_pallas, both branches: the flat pool
// (_fused_kernel) and the paged pool (_fused_kernel_paged), and
// sparse_decode_attention_pallas (_kernel), the prefix-only partial, as
// three instantiations of one template.
//
// Partial (PARTIAL = true): the same online softmax over the valid
// compressed prefix blocks of the flat pool, with no tail loop; it writes
// the normalised output and lse = m + log(l_safe) beside it, in the TPU
// kernel's order (l_safe = max(l, 1e-30), o = acc / l_safe).  A slot with
// n_blocks = 0 reads nothing and returns o = 0, lse = -1e30 + log(1e-30),
// which rounds to -1e30 in f32.  Its callers merge it with other partials
// through the lse (the two-pass decode, the context-parallel shards).
//
// Paged: the compressed prefix lives once in a pool-global arena
// [n_phys, Hkv, X] and slot b reaches its logical block i through
// phys = table[b * Sb + i]; the block is then addressed as (phys * Hkv + h)
// where the flat pool addresses (b * Hkv + h) * Sb + i.  The TPU kernel
// gets the table by scalar prefetch; here each thread block loads its own
// entries, and only for i < n_blocks[b]: entries past it are dead (in range,
// but pointing at pages another request may be rewriting) and neither they
// nor the pages they name are ever read.
//
// One online softmax runs over each slot's valid compressed prefix blocks
// (bitmap + packed values per (bs, D) block, skipped past n_blocks[b]) and
// then over the dense tail ring in bs-token panels, masked per query row as
// tok < tail_len[b] + row / G (row // G is the panel query; Q == 1 is the
// plain decode tick).  NEG_INF = -1e30 and l_safe = max(l, 1e-30) as in
// the reference, so a slot with nothing valid returns 0, not NaN.
//
// Bound on the H100: device-memory bytes (the compressed blocks and tail
// tokens each slot must read once); a decode query panel does ~4*QG*D
// flops per token, far below the ridge.
//
// Design: the TPU grid's sequential sequence axis becomes a loop inside one
// thread block per (kv head, slot); nothing carries between blocks.  Each
// step expands one K and one V block into f32 shared memory with the shared
// prefix-sum helper (or loads one tail panel), scores the QG query rows,
// updates the per-row running max / normaliser, and rescales the f32
// accumulators held in registers.  This first version puts B*Hkv blocks on
// the card (32 at the serving shape), so it does not fill 132 SMs; a split
// over sequence blocks with a merge pass is the obvious next step.
#include "decompress.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int MAXACC = 8;              // QG * D <= NT * MAXACC
constexpr float NEG_INF = -1e30f;

struct Layout {
  size_t q, k, v, p, m, l, a, kw, ko, vw, vo, scr, bytes;
  __host__ __device__ Layout(int QG, int D, int bs) {
    const int W = bs * D / 32;
    q = 0;
    k = q + static_cast<size_t>(QG) * D * 4;
    v = k + static_cast<size_t>(bs) * (D + 1) * 4;
    p = v + static_cast<size_t>(bs) * D * 4;
    m = p + static_cast<size_t>(QG) * bs * 4;
    l = m + QG * 4;
    a = l + QG * 4;
    kw = a + QG * 4;
    ko = kw + static_cast<size_t>(W) * 4;
    vw = ko + static_cast<size_t>(W) * 4;
    vo = vw + static_cast<size_t>(W) * 4;
    scr = vo + static_cast<size_t>(W) * 4;
    bytes = scr + 32 * 4;
  }
};

template <typename TQ, typename TC, bool PAGED, bool PARTIAL>
__global__ void __launch_bounds__(NT) fused_decode_attention(
    const TQ* __restrict__ q, const uint32_t* __restrict__ kbm,
    const TC* __restrict__ kval, const uint32_t* __restrict__ vbm,
    const TC* __restrict__ vval, const TC* __restrict__ ktail,
    const TC* __restrict__ vtail, const int* __restrict__ n_blocks,
    const int* __restrict__ tail_len, const int* __restrict__ table,
    int n_phys, int H, int QG, int G, int D, int Sb, int bs, int ck, int cv,
    int Tp, float sm_scale, float* __restrict__ out,
    float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(QG, D, bs);
  float* s_q = reinterpret_cast<float*>(smem + L.q);
  float* s_k = reinterpret_cast<float*>(smem + L.k);     // [bs][D+1]
  float* s_v = reinterpret_cast<float*>(smem + L.v);     // [bs][D]
  float* s_p = reinterpret_cast<float*>(smem + L.p);     // [QG][bs]
  float* s_m = reinterpret_cast<float*>(smem + L.m);
  float* s_l = reinterpret_cast<float*>(smem + L.l);
  float* s_a = reinterpret_cast<float*>(smem + L.a);
  uint32_t* s_kw = reinterpret_cast<uint32_t*>(smem + L.kw);
  int* s_ko = reinterpret_cast<int*>(smem + L.ko);
  uint32_t* s_vw = reinterpret_cast<uint32_t*>(smem + L.vw);
  int* s_vo = reinterpret_cast<int*>(smem + L.vo);
  int* s_scr = reinterpret_cast<int*>(smem + L.scr);

  const int h = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int W = bs * D / 32;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int nb = min(n_blocks[b], Sb);
  const int tl = PARTIAL ? 0 : tail_len[b];
  const int qn = QG / G;
  // the partial has no tail: its loop ends at the last valid block
  const int n_steps = PARTIAL ? nb : Sb + Tp / bs;

  for (int i = t; i < QG * D; i += NT)
    s_q[i] = to_f32(q[bh * QG * D + i]);
  for (int r = t; r < QG; r += NT) {
    s_m[r] = NEG_INF;
    s_l[r] = 0.f;
  }
  float acc[MAXACC];
#pragma unroll
  for (int i = 0; i < MAXACC; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    const bool prefix = PARTIAL || step < Sb;
    const int base = prefix ? 0 : (step - Sb) * bs;
    // block-uniform skips: prefix blocks past n_blocks, tail panels that no
    // panel row can see
    if (prefix && step >= nb) continue;
    if (!prefix && !(base < tl + qn - 1)) continue;
    if (prefix) {
      // step < nb here: a live table entry (clamped into the arena)
      const size_t blk =
          PAGED ? static_cast<size_t>(min(max(table[static_cast<size_t>(b) *
                                                        Sb + step], 0),
                                          n_phys - 1)) * H + h
                : bh * Sb + step;
      stage_word_offsets(kbm + blk * W, W, s_kw, s_ko, s_scr);
      stage_word_offsets(vbm + blk * W, W, s_vw, s_vo, s_scr);
      const TC* kv = kval + blk * ck;
      const TC* vv = vval + blk * cv;
      for (int p = t; p < bs * D; p += NT) {
        const int tok = p / D, d = p % D;
        s_k[tok * (D + 1) + d] = expand_at(p, s_kw, s_ko, kv, ck);
        s_v[tok * D + d] = expand_at(p, s_vw, s_vo, vv, cv);
      }
    } else {
      const size_t off = (bh * Tp + base) * D;
      for (int p = t; p < bs * D; p += NT) {
        const int tok = p / D, d = p % D;
        s_k[tok * (D + 1) + d] = to_f32(ktail[off + p]);
        s_v[tok * D + d] = to_f32(vtail[off + p]);
      }
    }
    __syncthreads();

    for (int i = t; i < QG * bs; i += NT) {
      const int row = i / bs, tok = i % bs;
      const float* qr = s_q + row * D;
      const float* kr = s_k + tok * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
      s *= sm_scale;
      if (!prefix && !(base + tok < tl + row / G)) s = NEG_INF;
      s_p[i] = s;
    }
    __syncthreads();

    for (int row = warp; row < QG; row += NWARP) {
      float* pr = s_p + row * bs;
      float mx = NEG_INF;
      for (int j = lane; j < bs; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = s_m[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < bs; j += 32) {
        float pj = expf(pr[j] - m_new);
        if (!prefix && !(base + j < tl + row / G)) pj = 0.f;
        pr[j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_a[row] = alpha;
        s_l[row] = s_l[row] * alpha + sum;
        s_m[row] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAXACC; ++i) {
      const int idx = t + i * NT;
      if (idx < QG * D) {
        const int row = idx / D, d = idx % D;
        const float* pr = s_p + row * bs;
        float a = acc[i] * s_a[row];
        for (int j = 0; j < bs; ++j) a += pr[j] * s_v[j * D + d];
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MAXACC; ++i) {
    const int idx = t + i * NT;
    if (idx < QG * D) {
      const int row = idx / D;
      out[bh * QG * D + idx] = acc[i] / fmaxf(s_l[row], 1e-30f);
    }
  }
  if (PARTIAL)
    for (int r = t; r < QG; r += NT)
      lse[bh * QG + r] = s_m[r] + logf(fmaxf(s_l[r], 1e-30f));
}

template <typename TQ, typename TC, bool PAGED, bool PARTIAL>
cudaError_t run(const void* q, const void* kbm, const void* kval,
                const void* vbm, const void* vval, const void* ktail,
                const void* vtail, const void* n_blocks, const void* tail_len,
                const void* table, int n_phys, int B, int H, int QG, int G,
                int D, int Sb, int bs, int ck, int cv, int Tp, float sm_scale,
                void* out, void* lse, cudaStream_t stream) {
  const Layout L(QG, D, bs);
  auto kern = fused_decode_attention<TQ, TC, PAGED, PARTIAL>;
  cudaError_t e = allow_smem(kern, L.bytes);
  if (e != cudaSuccess) return e;
  kern<<<dim3(H, B), NT, L.bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const uint32_t*>(kbm),
      static_cast<const TC*>(kval), static_cast<const uint32_t*>(vbm),
      static_cast<const TC*>(vval), static_cast<const TC*>(ktail),
      static_cast<const TC*>(vtail), static_cast<const int*>(n_blocks),
      static_cast<const int*>(tail_len), static_cast<const int*>(table),
      n_phys, H, QG, G, D, Sb, bs, ck, cv, Tp, sm_scale,
      static_cast<float*>(out), static_cast<float*>(lse));
  return cudaGetLastError();
}

template <bool PAGED, bool PARTIAL>
int dispatch(const void* q, int q_dtype, const void* kbm, const void* kval,
             const void* vbm, const void* vval, const void* ktail,
             const void* vtail, int c_dtype, const void* n_blocks,
             const void* tail_len, const void* table, int n_phys, int B,
             int H, int QG, int G, int D, int Sb, int bs, int ck, int cv,
             int Tp, float sm_scale, void* out, void* lse, void* stream) {
  if (QG * D > NT * MAXACC || G < 1 || QG % G != 0 || Tp % bs != 0 ||
      (bs * D) % 32 != 0 || (PAGED && n_phys < 1) ||
      (PARTIAL && (Tp != 0 || lse == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == REPRO_BF16 && c_dtype == REPRO_BF16)
    e = run<__nv_bfloat16, __nv_bfloat16, PAGED, PARTIAL>(
        q, kbm, kval, vbm, vval, ktail, vtail, n_blocks, tail_len, table,
        n_phys, B, H, QG, G, D, Sb, bs, ck, cv, Tp, sm_scale, out, lse, s);
  else if (q_dtype == REPRO_F32 && c_dtype == REPRO_F32)
    e = run<float, float, PAGED, PARTIAL>(
        q, kbm, kval, vbm, vval, ktail, vtail, n_blocks, tail_len, table,
        n_phys, B, H, QG, G, D, Sb, bs, ck, cv, Tp, sm_scale, out, lse, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // namespace

// q [B, H, QG, D] (q_dtype); kbm/vbm [B, H, Sb, bs*D/32] words; kval/vval
// [B, H, Sb, ck|cv] and ktail/vtail [B, H, Tp, D] (c_dtype); n_blocks,
// tail_len int32 [B]; out f32 [B, H, QG, D].  Tp % bs == 0, QG % G == 0,
// QG * D <= 2048.  Returns cudaGetLastError().
REPRO_EXPORT int fused_attention_launch(
    const void* q, int q_dtype, const void* kbm, const void* kval,
    const void* vbm, const void* vval, const void* ktail, const void* vtail,
    int c_dtype, const void* n_blocks, const void* tail_len, int B, int H,
    int QG, int G, int D, int Sb, int bs, int ck, int cv, int Tp,
    float sm_scale, void* out, void* stream) {
  return dispatch<false, false>(q, q_dtype, kbm, kval, vbm, vval, ktail,
                                vtail, c_dtype, n_blocks, tail_len, nullptr,
                                0, B, H, QG, G, D, Sb, bs, ck, cv, Tp,
                                sm_scale, out, nullptr, stream);
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
    int bs, int ck, int cv, int Tp, float sm_scale, void* out, void* stream) {
  return dispatch<true, false>(q, q_dtype, kbm, kval, vbm, vval, ktail, vtail,
                               c_dtype, n_blocks, tail_len, table, n_phys, B,
                               H, QG, G, D, Sb, bs, ck, cv, Tp, sm_scale, out,
                               nullptr, stream);
}

// The prefix-only partial over the flat layout: q [B, H, QG, D], the
// compressed prefix as fused_attention_launch, n_blocks int32 [B]; no tail.
// out f32 [B, H, QG, D] (normalised) and lse f32 [B, H, QG].
REPRO_EXPORT int partial_attention_launch(
    const void* q, int q_dtype, const void* kbm, const void* kval,
    const void* vbm, const void* vval, int c_dtype, const void* n_blocks,
    int B, int H, int QG, int D, int Sb, int bs, int ck, int cv,
    float sm_scale, void* out, void* lse, void* stream) {
  return dispatch<false, true>(q, q_dtype, kbm, kval, vbm, vval, nullptr,
                               nullptr, c_dtype, n_blocks, nullptr, nullptr,
                               0, B, H, QG, QG, D, Sb, bs, ck, cv, 0,
                               sm_scale, out, lse, stream);
}
