"""Flash-decode over the pooled sparse KV cache: fused prefix + tail, and
the prefix-only partial.

Replaces ``repro/kernels/sparse_attention.py:
sparse_decode_attention_fused_pallas`` — the flat branch
(:func:`sparse_decode_attention_fused`) and the paged branch
(:func:`sparse_decode_attention_fused_paged`, whose prefix blocks come out
of a pool-global arena through a per-slot block table) — and
``sparse_decode_attention_pallas``, the prefix-only partial that returns
``(o, lse)`` for an lse merge (:func:`sparse_decode_attention_partial`),
with the CUDA kernels in ``csrc/sparse_attention.cu``.  Beside them live
plain twins of the reference's XLA partial helpers (:func:`gqa_partial`,
:func:`merge_attn`, :func:`len_valid`), which the two-pass decode runs
around the partial.  Bound on the H100: device-memory bytes — each slot's
valid compressed K/V blocks and visible tail tokens, read once; the query
panel's flops are far below the ridge.

The fused kernels split the sequence across thread blocks: one block per
(kv head, slot, split, row tile), a split being one compressed prefix
block or one ``bs``-token tail panel (:func:`attention_plan`: the splits
depend on ``(Sb, Tp, bs)`` alone, so 256 blocks at the serving decode
tick).  Each block stages its split with 16-byte copies, scores its query
rows straight from the staged bitmap and values, and writes its rows'
``(acc, m, l)`` to an f32 scratch; the last block of each (slot, head, row
tile) to finish, told by a ticket counter that it resets, merges the
splits in split order.  A block holds at most ``row_tile`` query rows (16
at bs = D = 128) and a wider panel takes more row tiles, so a verify panel
has no width cap.  A row's result does not depend on the panel width or
the number of slots.  The prefix-only partial is the same kernel with no
tail panel (``attention_plan(Sb, 0, ...)``: ``Sb`` splits, 224 blocks at
the serving shape), whose merge also writes ``lse``; its panel has no
width cap either.

CPU tensors take the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core.sparse_format import BlockSparseWeight, unpack
from . import build

_SRC = "sparse_attention.cu"
# the launch plan and the outputs, after sm_scale: splits, row tile, row
# tiles, shared memory, then scratch, tickets, out and the stream
_PLAN_ARGS = ([ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_long]
              + [ctypes.c_void_p] * 4)
_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
         + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
         + [ctypes.c_int] * 10 + _PLAN_ARGS)
_PAGED_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
               + [ctypes.c_int] + [ctypes.c_void_p] * 3
               + [ctypes.c_int] * 11 + _PLAN_ARGS)
_PARTIAL_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 8
                 + _PLAN_ARGS + [ctypes.c_void_p])
NEG_INF = -1e30             # the kernels' running-max start and mask value
THREADS = 256               # threads of one split-attention block


class AttentionPlan(NamedTuple):
    """The launch of the fused kernels, a function of (Sb, Tp, bs, D, the
    value capacities, the cache dtype) alone; QG sets only the number of
    row tiles (:meth:`tiles`) and the scratch's rows."""
    splits: int             # Sb prefix blocks, then Tp / bs tail panels
                            # (none for the partial: Tp = 0)
    row_tile: int           # query rows one thread block holds
    smem: int               # dynamic shared memory of one block, bytes

    def tiles(self, qg: int) -> int:
        return -(-qg // self.row_tile)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def attention_plan(sb: int, tp: int, bs: int, d: int, ck: int, cv: int,
                   c_bytes: int) -> AttentionPlan:
    """Splits, row tile and shared memory of the split kernel.  The byte
    count mirrors ``SplitLayout`` in ``csrc/sparse_attention.cu``, whose
    launchers refuse any other: the tile's f32 query rows and scores, 272
    bytes of scan scratch and flag, the split's V as dense rows (each
    padded by 16 bytes), then the larger of a tail panel's K rows and a
    prefix block's staging (K and V bitmap words and their prefix
    popcounts, the packed values up to capacity)."""
    row_tile = min(16, 8 * min(max(1, THREADS // bs), max(1, THREADS // d)))
    words = bs * d // 32
    rows = bs * (d * c_bytes + 16)
    stage = _align16(row_tile * d * 4 + row_tile * bs * 4 + 64 * 4 + 16) \
        + rows
    pre = stage
    for n in (4 * words,) * 4 + (ck * c_bytes, cv * c_bytes):
        pre = _align16(pre + n)
    return AttentionPlan(sb + tp // bs, row_tile, max(pre, stage + rows))


# per device: int32 ticket counters of the split kernel, zero between
# launches (each launch's last block per (slot, head, row tile) resets its
# own); grown, never shrunk, and never while a CUDA graph is captured
_TICKETS: Dict[str, torch.Tensor] = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    buf = _TICKETS.get(str(device))
    if buf is None or buf.numel() < n:
        build.refuse_growth_under_capture("the attention's tickets")
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[str(device)] = buf
    return buf


def _dense_prefix(bitmap, values, bs, d):
    """Kernel-layout compressed blocks ``[B, Hkv, Sb, X]`` -> dense
    ``[B, Hkv, Sb*bs, D]``."""
    sb = bitmap.shape[2]
    return unpack(BlockSparseWeight(bitmap[:, :, :, None], values[:, :, :, None],
                                    None, (sb * bs, d), (bs, d)))


def sparse_decode_attention_fused_plain(
        q: torch.Tensor, k_bitmap: torch.Tensor, k_values: torch.Tensor,
        v_bitmap: torch.Tensor, v_values: torch.Tensor,
        k_tail: torch.Tensor, v_tail: torch.Tensor, bs: int,
        sm_scale: float, n_blocks: torch.Tensor, tail_len: torch.Tensor,
        group: Optional[int] = None) -> torch.Tensor:
    """Plain version (twin of ``kernels/ref.py:
    sparse_decode_attention_panel_ref`` on the kernel's operand layout):
    one softmax over the valid prefix and the visible tail, each scored as
    its own panel and merged through a joint max.  The softmax weights stay
    f32 through the PV product, as in the TPU kernel (the reference oracle
    rounds them to the cache dtype first; at f32 the two agree).  Returns
    f32 ``[B, Hkv, QG, D]``; slots with nothing valid return zeros."""
    b, hkv, qg, d = q.shape
    g = group or qg
    k = _dense_prefix(k_bitmap, k_values, bs, d)
    v = _dense_prefix(v_bitmap, v_values, bs, d)
    s_len, t = k.shape[2], k_tail.shape[2]
    dev = q.device
    # validity per (slot, query row, token); row // g is the panel query
    valid_p = (torch.arange(s_len, device=dev)[None, None, :]
               < (n_blocks.to(dev).long() * bs)[:, None, None])
    valid_t = (torch.arange(t, device=dev)[None, None, :]
               < tail_len.to(dev).long()[:, None, None]
               + (torch.arange(qg, device=dev) // g)[None, :, None])
    qq = q.to(torch.float32)

    def panel(kx, vx, valid):
        s = (qq @ kx.to(torch.float32).transpose(-1, -2)) * sm_scale
        vm = valid[:, None]                                # [B, 1, QG|1, S]
        s = torch.where(vm, s, torch.tensor(float("-inf"), device=dev))
        m = s.amax(-1)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.where(vm, torch.exp(s - m_safe[..., None]),
                        torch.zeros((), device=dev))
        o = p @ vx.to(torch.float32)
        return o, p.sum(-1), m

    o1, l1, m1 = panel(k, v, valid_p)
    o2, l2, m2 = panel(k_tail, v_tail, valid_t)
    m = torch.maximum(m1, m2)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w1 = torch.exp(m1 - m_safe)
    w2 = torch.exp(m2 - m_safe)
    l_safe = torch.clamp(l1 * w1 + l2 * w2, min=1e-30)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / l_safe[..., None]
    return o.reshape(b, hkv, qg, d)


def _check(q, k_bitmap, k_values, v_bitmap, v_values, k_tail, v_tail, bs,
           n_blocks, tail_len, group):
    """Geometry and dtype checks shared by both kernel entries; returns the
    int32 length vectors and the contiguous query."""
    b, hkv, qg, d = q.shape
    g = group or qg
    tp = k_tail.shape[2]
    if qg % g or tp % bs or tp < bs or d % 32:
        raise ValueError(f"bad geometry: QG={qg}, G={g}, tail={tp}, bs={bs}, "
                         f"D={d}")
    if k_values.dtype != k_tail.dtype or v_values.dtype != k_tail.dtype \
            or q.dtype != k_tail.dtype or q.dtype not in build.DTYPE_CODE:
        raise TypeError("fused attention kernel takes one f32/bf16 dtype "
                        "for q, cache values and tail")
    q = q.contiguous()
    n_blocks = n_blocks.to(torch.int32).contiguous()
    tail_len = tail_len.to(torch.int32).contiguous()
    build.require_cuda(q, k_bitmap, k_values, v_bitmap, v_values, k_tail,
                       v_tail, n_blocks, tail_len)
    return q, n_blocks, tail_len, g


def _launch(entry, argtypes, head_args, geometry, plan, q, sm_scale,
            with_lse=False):
    """Allocate the output (and ``lse``) and the scratch, take the ticket
    counters and make the C call: ``head_args`` (pointers, dtype codes, the
    paged table), the ``geometry``, then the plan; returns ``out`` or
    ``(out, lse)``."""
    b, hkv, qg, d = q.shape
    tiles = plan.tiles(qg)
    outs = [torch.empty((b, hkv, qg, d), dtype=torch.float32,
                        device=q.device)]
    if with_lse:
        outs.append(torch.empty((b, hkv, qg), dtype=torch.float32,
                                device=q.device))
    scratch = torch.empty((b, hkv, plan.splits, qg, d + 2),
                          dtype=torch.float32, device=q.device)
    tickets = _tickets(q.device, b * hkv * tiles)
    p = build.ptr
    build.call(_SRC, entry, argtypes, *head_args, *geometry, float(sm_scale),
               plan.splits, plan.row_tile, tiles, plan.smem, p(scratch),
               p(tickets), *map(p, outs), build.stream())
    return tuple(outs) if with_lse else outs[0]


def _fused_geometry(q, g, sb, bs, k_values, v_values, k_tail):
    """The fused entries' geometry and plan."""
    b, hkv, qg, d = q.shape
    ck, cv, tp = k_values.shape[-1], v_values.shape[-1], k_tail.shape[2]
    return ((b, hkv, qg, g, d, sb, bs, ck, cv, tp),
            attention_plan(sb, tp, bs, d, ck, cv, k_tail.element_size()))


def sparse_decode_attention_fused(
        q: torch.Tensor, k_bitmap: torch.Tensor, k_values: torch.Tensor,
        v_bitmap: torch.Tensor, v_values: torch.Tensor,
        k_tail: torch.Tensor, v_tail: torch.Tensor, bs: int,
        sm_scale: float, n_blocks: torch.Tensor, tail_len: torch.Tensor,
        group: Optional[int] = None) -> torch.Tensor:
    """q ``[B, Hkv, QG, D]`` (rows query-major within the GQA group);
    compressed prefix ``[B, Hkv, Sb, X]``; tail ring ``[B, Hkv, Tp, D]`` with
    ``Tp % bs == 0``; ``n_blocks`` / ``tail_len`` int32 ``[B]``.  Returns
    f32 ``[B, Hkv, QG, D]``.  CPU tensors take the plain version."""
    args = (q, k_bitmap, k_values, v_bitmap, v_values, k_tail, v_tail, bs,
            sm_scale, n_blocks, tail_len, group)
    if q.device.type == "cpu":
        return sparse_decode_attention_fused_plain(*args)
    q, n_blocks, tail_len, g = _check(
        q, k_bitmap, k_values, v_bitmap, v_values, k_tail, v_tail, bs,
        n_blocks, tail_len, group)
    p = build.ptr
    out = _launch(
        "fused_attention_launch", _ARGS,
        (p(q), build.DTYPE_CODE[q.dtype], p(k_bitmap), p(k_values),
         p(v_bitmap), p(v_values), p(k_tail), p(v_tail),
         build.DTYPE_CODE[k_tail.dtype], p(n_blocks), p(tail_len)),
        *_fused_geometry(q, g, k_bitmap.shape[2], bs, k_values, v_values,
                         k_tail), q, sm_scale)
    sparse_decode_attention_fused.launches += 1
    return out


sparse_decode_attention_fused.launches = 0


def gather_paged(table: torch.Tensor, bitmap: torch.Tensor,
                 values: torch.Tensor, n_blocks: torch.Tensor):
    """Arena ``[n_phys, Hkv, X]`` + block table ``[B, Sb]`` -> each slot's
    logical prefix in the flat kernel layout ``[B, Hkv, Sb, X]`` (twin of
    ``kernels/ref.py:gather_paged_prefix``).  Blocks at or past
    ``n_blocks[b]`` come back with an empty bitmap, so their pages — dead,
    possibly rewritten or poisoned — never reach the arithmetic, as in the
    kernel, which does not read them at all."""
    idx = table.long().clamp(0, bitmap.shape[0] - 1)
    b, sb = table.shape
    live = (torch.arange(sb, device=table.device)[None]
            < n_blocks.to(table.device).long()[:, None])      # [B, Sb]
    rows = lambda a: a.index_select(0, idx.reshape(-1)).reshape(
        b, sb, *a.shape[1:]).permute(0, 2, 1, 3)
    bm = rows(bitmap)
    bm = torch.where(live[:, None, :, None], bm, torch.zeros((), dtype=bm.dtype,
                                                             device=bm.device))
    return bm, rows(values)


def sparse_decode_attention_fused_paged_plain(
        q: torch.Tensor, k_bitmap: torch.Tensor, k_values: torch.Tensor,
        v_bitmap: torch.Tensor, v_values: torch.Tensor, table: torch.Tensor,
        k_tail: torch.Tensor, v_tail: torch.Tensor, bs: int,
        sm_scale: float, n_blocks: torch.Tensor, tail_len: torch.Tensor,
        group: Optional[int] = None) -> torch.Tensor:
    """Plain version of the paged entry: gather each slot's blocks out of
    the arena (:func:`gather_paged`), then the flat plain version — paged
    attention is gather-then-flat attention."""
    kbm, kvl = gather_paged(table, k_bitmap, k_values, n_blocks)
    vbm, vvl = gather_paged(table, v_bitmap, v_values, n_blocks)
    return sparse_decode_attention_fused_plain(
        q, kbm, kvl, vbm, vvl, k_tail, v_tail, bs, sm_scale, n_blocks,
        tail_len, group)


def sparse_decode_attention_fused_paged(
        q: torch.Tensor, k_bitmap: torch.Tensor, k_values: torch.Tensor,
        v_bitmap: torch.Tensor, v_values: torch.Tensor, table: torch.Tensor,
        k_tail: torch.Tensor, v_tail: torch.Tensor, bs: int,
        sm_scale: float, n_blocks: torch.Tensor, tail_len: torch.Tensor,
        group: Optional[int] = None) -> torch.Tensor:
    """The paged pool's entry: compressed prefix in a shared arena
    ``[n_phys, Hkv, X]``, reached through ``table`` int32 ``[B, Sb]``
    (entries at or past ``n_blocks`` are dead but in range); q, tail and
    lengths as :func:`sparse_decode_attention_fused`.  Returns f32
    ``[B, Hkv, QG, D]``.  CPU tensors take the plain version."""
    args = (q, k_bitmap, k_values, v_bitmap, v_values, table, k_tail,
            v_tail, bs, sm_scale, n_blocks, tail_len, group)
    if q.device.type == "cpu":
        return sparse_decode_attention_fused_paged_plain(*args)
    if k_bitmap.dim() != 3 or table.dim() != 2 \
            or table.shape[0] != q.shape[0]:
        raise ValueError(f"paged attention takes a [n_phys, Hkv, X] arena "
                         f"and a [B, Sb] table, got {tuple(k_bitmap.shape)} "
                         f"and {tuple(table.shape)}")
    q, n_blocks, tail_len, g = _check(
        q, k_bitmap, k_values, v_bitmap, v_values, k_tail, v_tail, bs,
        n_blocks, tail_len, group)
    table = table.to(torch.int32).contiguous()
    build.require_cuda(q, table)
    p = build.ptr
    out = _launch(
        "fused_attention_paged_launch", _PAGED_ARGS,
        (p(q), build.DTYPE_CODE[q.dtype], p(k_bitmap), p(k_values),
         p(v_bitmap), p(v_values), p(k_tail), p(v_tail),
         build.DTYPE_CODE[k_tail.dtype], p(n_blocks), p(tail_len), p(table),
         k_bitmap.shape[0]),
        *_fused_geometry(q, g, table.shape[1], bs, k_values, v_values,
                         k_tail), q, sm_scale)
    sparse_decode_attention_fused_paged.launches += 1
    return out


sparse_decode_attention_fused_paged.launches = 0


# ---------------------------------------------------------------------------
# the prefix-only partial and the reference's XLA partial helpers
# ---------------------------------------------------------------------------

def sparse_decode_attention_partial_plain(
        q: torch.Tensor, k_bitmap: torch.Tensor, k_values: torch.Tensor,
        v_bitmap: torch.Tensor, v_values: torch.Tensor, bs: int,
        sm_scale: float, n_blocks: Optional[torch.Tensor] = None):
    """Plain version of the prefix-only partial (the TPU kernel's
    arithmetic in one pass): scores over each slot's first ``n_blocks``
    compressed blocks (all of them when None), the running max started at
    ``NEG_INF``, ``l_safe = max(l, 1e-30)``, ``o = acc / l_safe``,
    ``lse = m + log(l_safe)``.  A slot with no valid block returns
    ``o = 0`` and ``lse = -1e30``.  Blocks past ``n_blocks`` never reach
    the arithmetic (their expanded rows are zeroed), so whatever they hold
    cannot leak, as in the kernel, which does not read them.  Returns f32
    ``(o [B, Hkv, QG, D], lse [B, Hkv, QG])``."""
    b, _, _, d = q.shape
    dev = q.device
    if n_blocks is None:
        n_blocks = torch.full((b,), k_bitmap.shape[2], dtype=torch.int32)
    valid = (torch.arange(k_bitmap.shape[2] * bs, device=dev)[None]
             < (n_blocks.to(dev).long() * bs)[:, None])[:, None, None]
    zero = torch.zeros((), device=dev)
    k, v = (torch.where(valid.transpose(-1, -2), _dense_prefix(
        bm, vals, bs, d).to(torch.float32), zero)
        for bm, vals in ((k_bitmap, k_values), (v_bitmap, v_values)))
    s = (q.to(torch.float32) @ k.transpose(-1, -2)) * sm_scale
    s = torch.where(valid, s, torch.tensor(NEG_INF, device=dev))
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]),
                    torch.zeros((), device=dev))
    l_safe = torch.clamp(p.sum(-1), min=1e-30)
    return (p @ v) / l_safe[..., None], m + torch.log(l_safe)


def sparse_decode_attention_partial(
        q: torch.Tensor, k_bitmap: torch.Tensor, k_values: torch.Tensor,
        v_bitmap: torch.Tensor, v_values: torch.Tensor, bs: int,
        sm_scale: float, n_blocks: Optional[torch.Tensor] = None):
    """The prefix-only partial: q ``[B, Hkv, QG, D]`` (any QG), the
    compressed prefix ``[B, Hkv, Sb, X]`` as
    :func:`sparse_decode_attention_fused`, ``n_blocks`` int32 ``[B]`` (None:
    every block is valid).  Returns f32 ``(o [B, Hkv, QG, D], lse [B, Hkv,
    QG])``.  CPU tensors take the plain version; a CUDA tensor launches the
    split kernel in partial mode (``attention_plan(Sb, 0, ...)``)."""
    args = (q, k_bitmap, k_values, v_bitmap, v_values, bs, sm_scale,
            n_blocks)
    if q.device.type == "cpu":
        return sparse_decode_attention_partial_plain(*args)
    b, hkv, qg, d = q.shape
    sb = k_bitmap.shape[2]
    if sb < 1 or d % 32:
        raise ValueError(f"bad geometry: Sb={sb}, D={d}")
    if k_values.dtype != q.dtype or v_values.dtype != q.dtype \
            or q.dtype not in build.DTYPE_CODE:
        raise TypeError("partial attention kernel takes one f32/bf16 dtype "
                        "for q and the cache values")
    if n_blocks is None:
        n_blocks = torch.full((b,), sb, dtype=torch.int32, device=q.device)
    q = q.contiguous()
    n_blocks = n_blocks.to(torch.int32).contiguous()
    build.require_cuda(q, k_bitmap, k_values, v_bitmap, v_values, n_blocks)
    ck, cv = k_values.shape[-1], v_values.shape[-1]
    p = build.ptr
    out, lse = _launch(
        "partial_attention_launch", _PARTIAL_ARGS,
        (p(q), build.DTYPE_CODE[q.dtype], p(k_bitmap), p(k_values),
         p(v_bitmap), p(v_values), build.DTYPE_CODE[k_values.dtype],
         p(n_blocks)),
        (b, hkv, qg, d, sb, bs, ck, cv),
        attention_plan(sb, 0, bs, d, ck, cv, k_values.element_size()), q,
        sm_scale, with_lse=True)
    sparse_decode_attention_partial.launches += 1
    return out, lse


sparse_decode_attention_partial.launches = 0


def len_valid(n: int, length, b: int) -> torch.Tensor:
    """``[B, n]`` validity mask from a scalar or per-slot ``[B]`` length
    (twin of ``kernels/ref.py:_len_valid``)."""
    length = torch.as_tensor(length)
    if length.dim() == 1:
        length = length[:, None]
    return torch.broadcast_to(torch.arange(n, device=length.device)[None, :]
                              < length, (b, n))


def gqa_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                sm_scale: float, valid: Optional[torch.Tensor] = None):
    """Grouped single-query partial with no head repeat (twin of
    ``kernels/ref.py:gqa_partial_ref``): q ``[B, Hkv, G, D]``, k, v
    ``[B, Hkv, S, D]``, ``valid`` bool ``[B, S]``.  Products accumulate in
    f32 and the weights round to ``v``'s dtype before the PV product, as
    in the reference.  Returns f32 ``(o [B, Hkv, G, D], lse [B, Hkv, G])``;
    a row with nothing valid gets ``lse = log(1e-30)``."""
    s = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) \
        * sm_scale
    if valid is not None:
        vm = valid.to(q.device)[:, None, None, :]
        s = torch.where(vm, s, torch.full((), float("-inf"), device=q.device))
    m = s.amax(-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    if valid is not None:
        p = torch.where(vm, p, torch.zeros((), device=q.device))
    l_safe = torch.clamp(p.sum(-1), min=1e-30)
    o = p.to(v.dtype).to(torch.float32) @ v.to(torch.float32)
    return o / l_safe[..., None], m_safe + torch.log(l_safe)


def merge_attn(o1: torch.Tensor, lse1: torch.Tensor, o2: torch.Tensor,
               lse2: torch.Tensor):
    """Join two attention partials through their log-sum-exps (twin of
    ``kernels/ref.py:_merge_attn``); returns ``(o, lse)``."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)[..., None]
    w2 = torch.exp(lse2 - m)[..., None]
    den = w1 + w2
    return (o1 * w1 + o2 * w2) / den, m + torch.log(den[..., 0])
