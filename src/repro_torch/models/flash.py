"""Attention over a whole sequence (twin of ``repro.models.flash``): the
unblocked attention of short sequences and of the prefill chunk, and the
memory-bounded blocked attention of sequences past ``cfg.full_attn_max``
(training and the one-shot prefill).

The blocked attention is the reference's flash structure, in plain
PyTorch in f32 inside each block as the reference's is plain JAX (no
Pallas kernel): an online softmax over KV blocks for each query block, so
at most one ``bq x bkv`` score panel per (B, H) lives at a time.  Python
loops stand for the reference's ``lax.map`` over query blocks and
``lax.scan`` over KV blocks, and autograd differentiates them.  Two
schedules, as in the reference:

* ``masked``: every (query block, KV block) pair is computed and causally
  masked (about twice the causal-optimal work: the baseline);
* ``triangular``: only the pairs with a key at or before the query block's
  last query, the reference's static pair list (``_triangular``), visited
  in its order; a skipped pair is one the masked schedule computes and
  masks whole, which leaves its state as it was.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sm_scale: float, causal: bool = True,
                   kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,H,Sq,D], k/v [B,H,Skv,D]; causal aligns the query block with the
    end of the key sequence; ``kv_valid [B, Skv]`` masks keys."""
    s = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)
         ) * sm_scale
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    if causal:
        sq, skv = q.shape[2], k.shape[2]
        mask = ((torch.arange(sq, device=q.device)[:, None] + (skv - sq))
                >= torch.arange(skv, device=q.device)[None])
        s = torch.where(mask[None, None], s, neg)
    if kv_valid is not None:
        s = torch.where(kv_valid[:, None, None, :], s, neg)
    p = torch.softmax(s, dim=-1)
    return (p @ v.to(torch.float32)).to(q.dtype)


def _attn_block(qi, kj, vj, s_mask, m, l, acc, sm_scale):
    """One online-softmax update, all f32.  qi [..., bq, D], kj / vj
    [..., bkv, D]; m, l [..., bq] and acc [..., bq, D]."""
    s = (qi @ kj.transpose(-1, -2)) * sm_scale
    if s_mask is not None:
        s = torch.where(s_mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    if s_mask is not None:
        p = torch.where(s_mask, p, 0.0)
    l_new = l * alpha + p.sum(-1)
    acc_new = acc * alpha[..., None] + p @ vj
    return m_new, l_new, acc_new


def _first_visitor(j: int, bq: int, bkv: int, triangular: bool) -> int:
    """The first query block that visits KV block ``j``: 0, or in the
    causal-optimal schedule the first ``i`` of the reference's pair list
    (``_triangular``: ``j * bkv < (i + 1) * bq``)."""
    return (j * bkv) // bq if triangular else 0


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sm_scale: float, causal: bool = True,
                      bq: int = 512, bkv: int = 512,
                      impl: str = "masked") -> torch.Tensor:
    """q [B,H,S,D], k/v [B,H,Skv,D] -> [B,H,S,D] in q's dtype.  The block
    sizes clamp to the sequences; each sequence must then be a multiple of
    its block (``ValueError`` otherwise).  ``impl="triangular"`` takes the
    causal-optimal schedule when ``causal``; a non-causal call visits every
    pair in either schedule.  The causal mask is ``qpos >= kpos`` (query
    and key positions from 0), as in the reference.

    The loop runs over KV blocks; each step updates every query block that
    visits the block at once (the reference maps over query blocks, which
    are independent), so each query block still sees its KV blocks in the
    reference's order, one online-softmax update each."""
    b, h, s, d = q.shape
    skv = k.shape[2]
    bq = min(bq, s)
    bkv = min(bkv, skv)
    if s % bq != 0 or skv % bkv != 0:
        raise ValueError(f"seq {s}/{skv} not multiples of blocks {bq}/{bkv}")
    nq, nk = s // bq, skv // bkv
    triangular = impl == "triangular" and causal
    dev = q.device
    f32 = torch.float32
    # cast once (the reference casts each block; the values are the same);
    # k and v split into blocks, so each gets one gradient ``cat``
    qb = q.to(f32).reshape(b, h, nq, bq, d)
    ks = k.to(f32).split(bkv, dim=2)
    vs = v.to(f32).split(bkv, dim=2)
    qpos = torch.arange(s, device=dev).reshape(nq, bq, 1)
    m = torch.full((b, h, nq, bq), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((b, h, nq, bq), dtype=f32, device=dev)
    acc = torch.zeros((b, h, nq, bq, d), dtype=f32, device=dev)
    for j in range(nk):
        lo = _first_visitor(j, bq, bkv, triangular)
        mask = None
        if causal:                                  # [nq - lo, bq, bkv]
            mask = qpos[lo:] >= torch.arange(j * bkv, (j + 1) * bkv,
                                             device=dev)
        mj, lj, aj = _attn_block(qb[:, :, lo:], ks[j][:, :, None],
                                 vs[j][:, :, None], mask, m[:, :, lo:],
                                 l[:, :, lo:], acc[:, :, lo:], sm_scale)
        if lo:              # the query blocks before lo are done with j
            mj = torch.cat([m[:, :, :lo], mj], dim=2)
            lj = torch.cat([l[:, :, :lo], lj], dim=2)
            aj = torch.cat([acc[:, :, :lo], aj], dim=2)
        m, l, acc = mj, lj, aj
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, h, s, d).to(q.dtype)
