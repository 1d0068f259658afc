"""Unblocked attention for the prefill chunk (twin of
``repro.models.flash.full_attention``; the blocked training schedules are
not ported yet)."""
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
