"""The decoder-only LM on the pooled serving cache, dense family (twin of
the pooled serving half of ``repro.models.lm``).

A Python loop over the layer-stacked params replaces the reference's
``lax.scan``; each layer works on views of the pool storage, which the
forwards update **in place** (the pool is the largest state on the card,
and the reference's functional copy of it per tick buys nothing here).
The forwards return the same ``(logits, state)`` pair as the reference,
``state`` being the caller's dict, mutated.
"""
from __future__ import annotations

from math import gcd
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.sparse_format import BlockSparseWeight
from repro_torch.core.sparse_kv import freeze_chunk_blocks
from . import module as mod
from .attention import attn_specs, pooled_attn_panel, \
    pooled_attn_prefill_chunk
from .layers import (embed_apply, embed_specs, mlp_apply, mlp_specs,
                     norm_spec, rms_norm, unembed_apply)
from .module import ParamSpec


def period_len(cfg) -> int:
    p = 1
    if cfg.family == "hybrid":
        p = p * cfg.attn_every // gcd(p, cfg.attn_every)
    if cfg.n_experts:
        p = p * cfg.moe_every // gcd(p, cfg.moe_every)
    return p


def layer_kind(cfg, i: int) -> Tuple[str, str]:
    if cfg.family == "ssm":
        return ("rwkv", "cmix")
    mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
    ffn = "moe" if cfg.is_moe_layer(i) else "mlp"
    return (mixer, ffn)


def _attn_kinds(cfg) -> List[Tuple[str, str]]:
    """The pooled path serves attention + MLP stacks; other families (MoE,
    recurrent, encoder-decoder, frontends) are not ported yet."""
    if cfg.family != "dense" or cfg.frontend or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    return [layer_kind(cfg, j) for j in range(period_len(cfg))]


def _stack_specs(tree: Any, n: int) -> Any:
    return mod.map_with_path(
        lambda p, s: ParamSpec((n,) + tuple(s.shape), s.dtype,
                               ("layers",) + tuple(s.axes or
                                                   (None,) * len(s.shape)),
                               init=s.init, scale=s.scale), tree)


def model_specs(cfg) -> Dict[str, Any]:
    kinds = _attn_kinds(cfg)
    n_periods = cfg.n_layers // len(kinds)
    period = {f"l{j}": {"ln1": norm_spec(cfg), "mixer": attn_specs(cfg),
                        "ln2": norm_spec(cfg), "ffn": mlp_specs(cfg)}
              for j in range(len(kinds))}
    return {"embed": embed_specs(cfg),
            "blocks": _stack_specs(period, n_periods),
            "final_norm": norm_spec(cfg)}


def init_params(cfg, seed: int = 0,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Dense parameters drawn on ``device`` (the CUDA device unless the
    caller asks for the CPU) from per-leaf generators seeded by ``seed``."""
    return mod.initialize(model_specs(cfg), seed, resolve_device(device))


def _layer(tree: Any, i: int) -> Any:
    """Slice layer ``i`` off every layer-stacked leaf."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, BlockSparseWeight):
        return tree.layer(i)
    return tree[i]


def logits_fn(params, hidden: torch.Tensor, cfg) -> torch.Tensor:
    return unembed_apply(params["embed"], hidden, cfg)


def _pooled_ffn(pj, h2: torch.Tensor) -> torch.Tensor:
    """The MLP half of a pooled panel block, run on rows (the panel width
    is invisible to it, as in the reference)."""
    rows = h2.reshape(-1, h2.shape[-1])
    out = mlp_apply(pj["ffn"], rows)
    return out.reshape(*h2.shape[:-1], out.shape[-1])


def forward_panel_pooled(params, state: Dict[str, Any],
                         tokens: torch.Tensor, slot_mask: torch.Tensor,
                         cfg, bs: int) -> Tuple[torch.Tensor, Dict]:
    """THE per-token serving forward: score a ``[B, Qn]`` token panel per
    slot over the pooled cache (``Qn == 1`` is a decode tick).

    Every live slot's ``Qn`` fresh K/V are appended to its tail ring and
    its ``pos`` / ``tail_len`` advance by ``Qn``; masked slots are left
    untouched.  Returns ``(logits [B, Qn, V] f32, state)``."""
    qn = tokens.shape[1]
    kinds = _attn_kinds(cfg)
    x = embed_apply(params["embed"], tokens, cfg)             # [B, Qn, d]
    positions = state["pos"][:, None] + torch.arange(
        qn, dtype=state["pos"].dtype, device=tokens.device)[None, :]
    prefix_blocks = state["prefix_blocks"]
    tail_len = state["tail_len"]
    # paged pool: the block table is pool-level state every layer reads
    table = state.get("table")
    n_periods = cfg.n_layers // len(kinds)
    for i in range(n_periods):
        pp = _layer(params["blocks"], i)
        for j in range(len(kinds)):
            pj = pp[f"l{j}"]
            kv = {k: a[i] for k, a in state["layers"][f"l{j}"]["kv"].items()}
            h = pooled_attn_panel(pj["mixer"], rms_norm(x, pj["ln1"]), kv,
                                  cfg, positions, prefix_blocks, tail_len,
                                  slot_mask, bs, table=table)
            x = x + h
            x = x + _pooled_ffn(pj, rms_norm(x, pj["ln2"]))
    x = rms_norm(x, params["final_norm"])
    logits = logits_fn(params, x, cfg)
    grow = qn * slot_mask.to(state["pos"].dtype)
    state["pos"] += grow
    state["tail_len"] += grow
    return logits, state


# the compressed leaves of a layer's kv tree: per-slot grids on the flat
# pool, the shared arena on the paged pool (tails are per-slot either way)
ARENA_KEYS = ("k_bitmap", "k_values", "v_bitmap", "v_values")


def forward_prefill_chunk(params, state: Dict[str, Any],
                          tokens: torch.Tensor, slot: int, cfg, bs: int,
                          new_ids: Optional[List[int]] = None
                          ) -> Tuple[torch.Tensor, Dict]:
    """Prefill one prompt chunk ``tokens [1, C]`` for pool slot ``slot``.

    The chunk attends to the slot's frozen prefix; then, layer by layer,
    its full ``bs``-token blocks are pruned and packed into the slot's next
    prefix blocks and a trailing remainder (< bs tokens, last chunk only)
    lands at the head of the tail ring.  Returns ``(last-token logits
    [1, V] f32, state)``.

    Paged pool (``state`` carries a block table): the slot attends to its
    prefix through its table row, and the chunk's ``C // bs`` new blocks
    are frozen into the fresh arena pages ``new_ids`` (host-allocated),
    appended to the table row with refcount 1 — never into shared storage,
    which is the copy-on-write guarantee."""
    c = tokens.shape[1]
    nb_new, rem = divmod(c, bs)
    kinds = _attn_kinds(cfg)
    paged = "table" in state
    x = embed_apply(params["embed"], tokens, cfg)            # [1, C, d]
    dev = tokens.device
    start = state["pos"][slot].clone()
    pb0 = state["prefix_blocks"][slot].clone()
    positions = start + torch.arange(c, dtype=start.dtype, device=dev)
    ctx_len = pb0 * bs
    new_blocks = pb0 + torch.arange(nb_new, dtype=torch.long, device=dev)
    table_row = None
    if paged:
        if nb_new and (new_ids is None or len(new_ids) != nb_new):
            raise ValueError("paged prefill needs one fresh arena id per "
                             "full block of the chunk")
        table_row = state["table"][slot]
        ids = torch.as_tensor(list(new_ids or []), dtype=torch.long,
                              device=dev)
    n_periods = cfg.n_layers // len(kinds)
    for i in range(n_periods):
        pp = _layer(params["blocks"], i)
        for j in range(len(kinds)):
            pj = pp[f"l{j}"]
            kvl = state["layers"][f"l{j}"]["kv"]
            slot_kv = {k: (a[i] if paged and k in ARENA_KEYS
                           else a[i, slot:slot + 1]) for k, a in kvl.items()}
            h, k_c, v_c = pooled_attn_prefill_chunk(
                pj["mixer"], rms_norm(x, pj["ln1"]), slot_kv, cfg, positions,
                ctx_len, bs, table_row=table_row)
            x = x + h
            x = x + mlp_apply(pj["ffn"], rms_norm(x, pj["ln2"]))
            # this layer's attention has read the slot's prefix: freeze the
            # chunk into it now (layers never read each other's storage)
            if nb_new:
                frozen = freeze_chunk_blocks(
                    k_c[:, :, :nb_new * bs], v_c[:, :, :nb_new * bs],
                    cfg.kv_k_sparsity, cfg.kv_v_sparsity, bs,
                    kvl["k_values"].shape[-1], kvl["v_values"].shape[-1])
                for key, upd in zip(ARENA_KEYS, frozen):
                    if paged:
                        dst = kvl[key][i]                # [n_phys, Hkv, X]
                        dst.index_copy_(0, ids, upd[0].transpose(0, 1)
                                        .to(dst.dtype))
                    else:
                        dst = kvl[key][i, slot]          # [Hkv, Sb, X]
                        dst.index_copy_(1, new_blocks, upd[0].to(dst.dtype))
            if rem:
                for key, src in (("k_tail", k_c), ("v_tail", v_c)):
                    dst = kvl[key][i, slot]                  # [Hkv, T, hd]
                    dst[:, :rem] = src[0, :, nb_new * bs:].to(dst.dtype)
    hidden = rms_norm(x, params["final_norm"])
    logits = logits_fn(params, hidden[:, -1:], cfg)[:, 0]
    state["pos"][slot] = start + c
    state["prefix_blocks"][slot] = pb0 + nb_new
    state["tail_len"][slot] = rem
    if paged and nb_new:
        state["table"][slot].index_copy_(0, new_blocks,
                                         ids.to(state["table"].dtype))
        state["refcount"].index_add_(
            0, ids, torch.ones_like(ids, dtype=state["refcount"].dtype))
    return logits, state
