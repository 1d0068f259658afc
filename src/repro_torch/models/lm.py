"""The decoder-only LM, dense family (twin of ``repro.models.lm``): the
full prefill and the one-token decode over the legacy per-batch cache of
the one-shot engine, and the panel forward and the prefill chunk over the
pooled serving cache.

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
from repro_torch.core.sparse_kv import (NAN_CHECK, device_ids, distinct_ids,
                                         flag_, freeze_chunk_blocks,
                                         put_rows_)
from . import module as mod
from repro_torch.core.sparse_kv import SparseKVCache, abstract_cache
from .attention import (DenseKVCache, attn_apply, attn_decode, attn_specs,
                        pooled_attn_panel, pooled_attn_prefill_chunk)
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


# ---------------------------------------------------------------------------
# prefill: the full forward, collecting every layer's K/V (one-shot engine)
# ---------------------------------------------------------------------------

def _sublayer_prefill(x, p, cfg, positions):
    h, (k, v) = attn_apply(p["mixer"], rms_norm(x, p["ln1"]), cfg,
                           positions, return_kv=True)
    x = x + h
    return x + mlp_apply(p["ffn"], rms_norm(x, p["ln2"])), {"k": k, "v": v}


def forward_prefill(params, batch: Dict[str, torch.Tensor], cfg
                    ) -> Tuple[torch.Tensor, Dict]:
    """The full forward over ``batch["tokens"] [B, S]``; returns ``(final
    hidden [B, S, d], collected)``, ``collected["layers"][f"l{j}"]``
    holding the post-RoPE ``k`` / ``v`` ``[P, B, Hkv, S, hd]`` stacked over
    periods and ``collected["len"] = S``."""
    kinds = _attn_kinds(cfg)
    tokens = batch["tokens"]
    x = embed_apply(params["embed"], tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    n_periods = cfg.n_layers // len(kinds)
    got = {f"l{j}": {"k": [], "v": []} for j in range(len(kinds))}
    for i in range(n_periods):
        pp = _layer(params["blocks"], i)
        for j in range(len(kinds)):
            x, kv = _sublayer_prefill(x, pp[f"l{j}"], cfg, positions)
            for key in ("k", "v"):
                got[f"l{j}"][key].append(kv[key])
    hidden = rms_norm(x, params["final_norm"])
    layers = {name: {key: torch.stack(vals) for key, vals in d.items()}
              for name, d in got.items()}
    return hidden, {"layers": layers, "len": x.shape[1]}


# ---------------------------------------------------------------------------
# the legacy decode cache and the one-token decode
# ---------------------------------------------------------------------------

def _cache_map(c, fn):
    """A cache of the same kind with ``fn`` applied to each tensor."""
    if isinstance(c, SparseKVCache):
        sw = lambda w: BlockSparseWeight(fn(w.bitmap), fn(w.values), None,
                                         w.shape, w.block, w.packed4)
        return SparseKVCache(sw(c.k_sp), sw(c.v_sp), fn(c.k_tail),
                             fn(c.v_tail), fn(c.tail_len))
    return DenseKVCache(fn(c.k), fn(c.v), fn(c.length))


def init_cache(cfg, batch: int, prefix: int, mode: str = "sparse",
               abstract: bool = False,
               device: Optional[torch.device] = None) -> Dict[str, Any]:
    """The one-shot cache, every leaf stacked over periods.  ``"sparse"``:
    the compressed frozen prefix (at the balanced capacity the KV
    sparsities imply) and the dense tail; ``"dense"``: a preallocated cache
    of ``prefix + kv_tail`` tokens.  ``abstract=True`` gives meta tensors
    (nothing allocated), otherwise zeros on ``device`` (the CUDA device
    unless the caller asks for the CPU)."""
    kinds = _attn_kinds(cfg)
    n_periods = cfg.n_layers // len(kinds)
    hkv, hd, dt = cfg.n_kv, cfg.hd, cfg.cdtype
    if mode == "sparse":
        one = abstract_cache(batch, hkv, prefix, hd, 1.0 - cfg.kv_k_sparsity,
                             1.0 - cfg.kv_v_sparsity,
                             tail_size=cfg.kv_tail, dtype=dt)
    else:
        meta = lambda shape, d: torch.empty(shape, dtype=d, device="meta")
        kv = meta((batch, hkv, prefix + cfg.kv_tail, hd), dt)
        one = DenseKVCache(kv, kv, meta((), torch.int32))
    dev = torch.device("meta") if abstract else resolve_device(device)
    stack = lambda t: torch.zeros((n_periods,) + tuple(t.shape),
                                  dtype=t.dtype, device=dev)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "layers": {f"l{j}": {"kv": _cache_map(one, stack)}
                       for j in range(len(kinds))}}


def _sublayer_decode(x_t, p, cache_j, cfg, position):
    h, cache_j = attn_decode(p["mixer"], rms_norm(x_t, p["ln1"]), cache_j,
                             cfg, position)
    x_t = x_t + h
    return x_t + mlp_apply(p["ffn"], rms_norm(x_t, p["ln2"])), cache_j


def forward_decode(params, cache: Dict[str, Any], tokens: torch.Tensor,
                   cfg) -> Tuple[torch.Tensor, Dict]:
    """``tokens [B, 1]`` -> ``(logits [B, V] f32, cache)``: one decode step
    over the legacy cache, whose tails (or dense rows) and lengths are
    written **in place**, ``cache["pos"]`` advanced by one."""
    kinds = _attn_kinds(cfg)
    x_t = embed_apply(params["embed"], tokens[:, 0], cfg)
    position = cache["pos"]
    n_periods = cfg.n_layers // len(kinds)
    for i in range(n_periods):
        pp = _layer(params["blocks"], i)
        for j in range(len(kinds)):
            kv = cache["layers"][f"l{j}"]["kv"].layer(i)
            x_t, _ = _sublayer_decode(x_t, pp[f"l{j}"], kv, cfg, position)
    x_t = rms_norm(x_t, params["final_norm"])
    logits = unembed_apply(params["embed"], x_t, cfg)
    cache["pos"] += 1
    return logits, cache


# ---------------------------------------------------------------------------
# the pooled serving cache
# ---------------------------------------------------------------------------

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
                                  slot_mask, bs, table=table,
                                  err=state.get("err"))
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
                          tokens: torch.Tensor, slot, cfg, bs: int,
                          new_ids=None, length=None, write=None
                          ) -> Tuple[torch.Tensor, Dict]:
    """Prefill one prompt chunk ``tokens [1, W]`` for pool slot ``slot``.

    The chunk attends to the slot's frozen prefix; then, layer by layer,
    its full ``bs``-token blocks are pruned and packed into the slot's next
    prefix blocks and a trailing remainder (< bs tokens, last chunk only)
    lands at the head of the tail ring.  Returns ``(logits [1, V] f32 of
    the chunk's last valid token, state)``.

    Every operand may be a device tensor, so one capture serves every slot
    and every length of a width class: ``slot`` (int64 ``[1]`` or an int);
    ``length`` (int64 ``[1]``, ``L <= W``; default ``W``), the valid
    tokens at the head of ``tokens``, the rest padding; ``write`` (bool
    ``[1]``; default true), which when false leaves the state untouched.
    ``nb = L // bs`` blocks freeze and ``rem = L % bs`` rows reach the
    tail, both computed on the device: blocks at index >= nb and tail rows
    at index >= rem write nothing.  The chunk is causal, so a padded row
    is never seen by a valid one, and the logits row is gathered before
    the unembedding (which runs at one row).

    Paged pool (``state`` carries a block table): the slot attends to its
    prefix through its table row, and the chunk's blocks are frozen into
    the fresh arena pages ``new_ids`` (int64 ``[W // bs]``, host-allocated;
    entries past ``nb`` are ignored), appended to the table row with
    refcount 1 — never into shared storage, which is the copy-on-write
    guarantee."""
    w = tokens.shape[1]
    nbw = w // bs                       # blocks a chunk of this width holds
    kinds = _attn_kinds(cfg)
    paged = "table" in state
    dev = tokens.device
    slot = device_ids(slot, (1,), dev)
    ln = device_ids(w if length is None else length, (1,), dev)
    wr = (torch.ones(1, dtype=torch.bool, device=dev) if write is None
          else write.to(dev, torch.bool).reshape(1))
    x = embed_apply(params["embed"], tokens, cfg)            # [1, W, d]
    start = state["pos"].index_select(0, slot).long()
    pb0 = state["prefix_blocks"].index_select(0, slot).long()
    positions = start + torch.arange(w, device=dev)
    ctx_len = pb0 * bs
    nb = torch.div(ln, bs, rounding_mode="floor")
    rem = ln - nb * bs
    j = torch.arange(nbw, device=dev)
    live_blk = (j < nb) & wr                                 # [W // bs]
    r = torch.arange(bs, device=dev)
    live_row = (r < rem) & wr                                # [bs]
    src_row = (nb * bs + r).clamp(max=w - 1)
    slot_row = slot.expand(bs)
    err = state.get("err")               # the sanitized pool's error word
    if err is not None:
        valid = (torch.arange(w, device=dev) < ln) & wr
    kv0 = state["layers"]["l0"]["kv"]
    if paged:
        sb = state["table"].shape[1]
        table_row = state["table"].index_select(0, slot)[0]
        n_phys = kv0["k_bitmap"].shape[1]
        if (new_ids is None and nbw) or (length is None and new_ids is not None
                                         and len(new_ids) != nbw):
            raise ValueError("paged prefill needs one fresh arena id per "
                             "full block of the chunk")
        ids = device_ids([] if new_ids is None else new_ids, (nbw,), dev)
        dest = distinct_ids(ids, live_blk, n_phys)
    else:
        sb = kv0["k_bitmap"].shape[3]
        table_row = None
    if nbw > sb:
        raise ValueError(f"a chunk of {w} tokens exceeds the slot's {sb} "
                         "blocks")
    blk = (pb0 + j) % sb           # pairwise distinct: nbw <= sb
    slot_blk = slot.expand(nbw)
    n_periods = cfg.n_layers // len(kinds)
    for i in range(n_periods):
        pp = _layer(params["blocks"], i)
        for jj in range(len(kinds)):
            pj = pp[f"l{jj}"]
            kvl = state["layers"][f"l{jj}"]["kv"]
            h, k_c, v_c = pooled_attn_prefill_chunk(
                pj["mixer"], rms_norm(x, pj["ln1"]),
                {k: kvl[k][i] for k in ARENA_KEYS}, cfg, positions, ctx_len,
                bs, slot, table_row=table_row)
            x = x + h
            x = x + mlp_apply(pj["ffn"], rms_norm(x, pj["ln2"]))
            if err is not None:
                nan = torch.isnan(k_c[0]).any(2).any(0) | \
                    torch.isnan(v_c[0]).any(2).any(0)
                flag_(err, nan & valid, NAN_CHECK)
            # this layer's attention has read the slot's prefix: freeze the
            # chunk into it now (layers never read each other's storage)
            if nbw:
                frozen = freeze_chunk_blocks(
                    k_c[:, :, :nbw * bs], v_c[:, :, :nbw * bs],
                    cfg.kv_k_sparsity, cfg.kv_v_sparsity, bs,
                    kvl["k_values"].shape[-1], kvl["v_values"].shape[-1])
                for key, upd in zip(ARENA_KEYS, frozen):
                    rows = upd[0].transpose(0, 1)        # [W//bs, Hkv, X]
                    if paged:                            # [n_phys, Hkv, X]
                        put_rows_(kvl[key][i], (dest,), rows, live_blk)
                    else:                                # [B, Sb, Hkv, X]
                        put_rows_(kvl[key][i].transpose(1, 2),
                                  (slot_blk, blk), rows, live_blk)
            for key, src in (("k_tail", k_c), ("v_tail", v_c)):
                rows = src[0].index_select(1, src_row).transpose(0, 1)
                put_rows_(kvl[key][i].transpose(1, 2), (slot_row, r), rows,
                          live_row)                      # [B, T, Hkv, hd]
    last = x.index_select(1, (ln - 1).clamp(min=0))
    logits = logits_fn(params, rms_norm(last, params["final_norm"]), cfg)[:, 0]
    put_rows_(state["pos"], (slot,), start + ln, wr)
    put_rows_(state["prefix_blocks"], (slot,), pb0 + nb, wr)
    put_rows_(state["tail_len"], (slot,), rem, wr)
    if paged and nbw:
        put_rows_(state["table"], (slot_blk, blk), ids.clamp(0, n_phys - 1),
                  live_blk)
        state["refcount"].index_add_(0, ids.clamp(0, n_phys - 1),
                                     live_blk.to(state["refcount"].dtype))
    return logits, state
