"""The model builder of every family (twin of ``repro.models.lm``): the
training forward, the full prefill and the one-token decode over the
legacy per-batch cache of the one-shot engine, and the panel forward and
the prefill chunk over the pooled serving cache.

Families, as in the reference:

* dense / moe / vlm: a decoder-only LM (a VLM's stub frontend embeddings
  before the prompt); an MoE layer's FFN is
  :func:`repro_torch.models.moe.moe_apply`, on the same rows as the
  reference gives it;
* ssm: RWKV-6, a time-mix and a channel-mix a layer
  (:mod:`repro_torch.models.ssm`);
* hybrid: Jamba, Mamba and attention mixers interleaved over a period of
  ``period_len`` layers, MoE every other layer;
* encdec: an encoder over ``src_embeds`` and a causal decoder with cross
  attention over the encoder's output.

Only attention stacks without cross attention or a frontend take the
pooled path (:func:`_attn_kinds`); the others serve through the one-shot
engine, as in the reference.

A Python loop over the layer-stacked params replaces the reference's
``lax.scan``; each layer works on views of the pool storage, which the
forwards update **in place** (the pool is the largest state on the card,
and the reference's functional copy of it per tick buys nothing here).
The forwards return the same ``(logits, state)`` pair as the reference,
``state`` being the caller's dict, mutated.  The training forward
(:func:`forward_train`) writes into nothing autograd keeps: with
``cfg.remat`` each period runs under ``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` of its scan body.
"""
from __future__ import annotations

from math import gcd
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core.sparse_format import BlockSparseWeight
from repro_torch.core.sparse_kv import (NAN_CHECK, device_ids, distinct_ids,
                                         flag_, put_rows_)
from repro_torch.distributed.serving_sharding import freeze_heads
from . import module as mod
from repro_torch.core.sparse_kv import SparseKVCache, abstract_cache
from .attention import (DenseKVCache, attn_apply, attn_decode, attn_specs,
                        cross_attn_decode, pooled_attn_panel,
                        pooled_attn_prefill_chunk)
from .layers import (embed_apply, embed_specs, mlp_apply, mlp_specs,
                     norm_spec, rms_norm, unembed_apply)
from .module import ParamSpec
from .moe import moe_apply, moe_specs
from .ssm import (mamba_apply, mamba_decode, mamba_init_state, mamba_specs,
                  rwkv_channel_mix, rwkv_channel_mix_decode, rwkv_init_state,
                  rwkv_specs, rwkv_time_mix, rwkv_time_mix_decode)


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


def _kinds(cfg) -> List[Tuple[str, str]]:
    """The layer kinds of a period, every family: ``("attn", "mlp" |
    "moe")``, ``("mamba", "mlp" | "moe")`` or ``("rwkv", "cmix")``."""
    return [layer_kind(cfg, j) for j in range(period_len(cfg))]


def _attn_kinds(cfg) -> List[Tuple[str, str]]:
    """The pooled serving path's kinds: attention stacks only, with no
    cross attention and no frontend, as in the reference (its
    ``ValueError`` is what the launcher's one-shot fallback and the pool's
    refusal rest on)."""
    if cfg.family == "encdec" or cfg.frontend:
        raise ValueError(
            "pooled serving has no cross-attention / frontend-embedding path")
    kinds = _kinds(cfg)
    if not all(k[0] == "attn" for k in kinds):
        raise ValueError(
            "pooled serving supports attention stacks (dense/moe families)")
    return kinds


def _stack_specs(tree: Any, n: int) -> Any:
    return mod.map_with_path(
        lambda p, s: ParamSpec((n,) + tuple(s.shape), s.dtype,
                               ("layers",) + tuple(s.axes or
                                                   (None,) * len(s.shape)),
                               init=s.init, scale=s.scale), tree)


def _block_specs(cfg, kind: Tuple[str, str], cross: bool = False
                 ) -> Dict[str, Any]:
    mixer, ffn = kind
    if mixer == "rwkv":
        return {"ln1": norm_spec(cfg), "tmix": rwkv_specs(cfg),
                "ln2": norm_spec(cfg)}
    s: Dict[str, Any] = {"ln1": norm_spec(cfg)}
    s["mixer"] = attn_specs(cfg) if mixer == "attn" else mamba_specs(cfg)
    if cross:
        s["ln_cross"] = norm_spec(cfg)
        s["cross"] = attn_specs(cfg, cross=True)
    s["ln2"] = norm_spec(cfg)
    s["ffn"] = moe_specs(cfg) if ffn == "moe" else mlp_specs(cfg)
    return s


def model_specs(cfg) -> Dict[str, Any]:
    kinds = _kinds(cfg)
    if cfg.n_layers % len(kinds):
        raise ValueError(f"n_layers {cfg.n_layers} not a multiple of "
                         f"period {len(kinds)}")
    cross = cfg.family == "encdec"
    period = {f"l{j}": _block_specs(cfg, kinds[j], cross=cross)
              for j in range(len(kinds))}
    specs = {"embed": embed_specs(cfg),
             "blocks": _stack_specs(period, cfg.n_layers // len(kinds)),
             "final_norm": norm_spec(cfg)}
    if cross:
        specs["encoder"] = _stack_specs(
            {"l0": _block_specs(cfg, ("attn", "mlp"))}, cfg.enc_layers)
        specs["enc_norm"] = norm_spec(cfg)
    return specs


def abstract_params(cfg) -> Dict[str, Any]:
    """The params tree as meta tensors: shapes and dtypes, nothing
    allocated."""
    return mod.abstract(model_specs(cfg))


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


def _layers(tree: Any) -> List[Any]:
    """Every layer of a layer-stacked tree: ``unbind`` for a tensor, so
    that under autograd each stack's gradient is one ``stack`` of its
    layers' (a select per layer would each add a zero-filled copy of the
    whole stack)."""
    if isinstance(tree, dict):
        per = {k: _layers(v) for k, v in tree.items()}
        return [dict(zip(per, vals)) for vals in zip(*per.values())]
    if isinstance(tree, BlockSparseWeight):
        return [tree.layer(i) for i in range(tree.bitmap.shape[0])]
    return list(tree.unbind(0))


def logits_fn(params, hidden: torch.Tensor, cfg, ctx=None) -> torch.Tensor:
    """f32 logits of ``hidden``; under a training ``ctx`` whose model axis
    cut the head, this rank's vocabulary columns (the reference constrains
    them to ``("batch", None, "vocab")``)."""
    return unembed_apply(params["embed"], hidden, cfg, ctx)


def _ffn(p, kind, h2: torch.Tensor, cfg, length=None, rows=None,
         ctx=None) -> torch.Tensor:
    """The MLP or MoE half of a block on ``h2 [B, S, d]`` (an MoE routes
    all ``B * S`` rows; ``length``: a padded chunk's valid rows; ``rows``:
    the rows that pick the MLP's sparse kernel; ``ctx``: the mesh, where
    an MoE routes this data shard's rows and a cut layer runs
    tensor-parallel)."""
    if kind[1] == "moe":
        return moe_apply(p["ffn"], h2, cfg, ctx, length)
    return mlp_apply(p["ffn"], h2, rows, ctx, cfg.d_ff)


# ---------------------------------------------------------------------------
# the full-sequence forward: training, and the prefill collecting every
# layer's K/V or state (one-shot engine)
# ---------------------------------------------------------------------------

def _sublayer(x, p, kind, cfg, positions, memory=None, attn_impl="masked",
              ctx=None):
    """One layer of the full forward (the reference's ``_sublayer`` and
    ``_sublayer_prefill``, whose values are the same); returns ``x`` and
    what the decode needs of it: ``{"k", "v"}`` for attention,
    ``{"state": ...}`` for a recurrent mixer (the states hold the normed
    f32 inputs' last rows), and ``{"cross": (k, v)}`` beside them for a
    decoder layer with a memory: the cross attention's K/V ``[B, Hkv, Sm,
    hd]``, projected once (the reference projects them a second time for
    the cache, to the same values).  Training drops the second part.
    ``attn_impl`` is the blocked attention's schedule past
    ``cfg.full_attn_max``.  Under a training ``ctx`` (a mesh) the layer
    runs tensor-parallel and returns nothing for a cache."""
    mixer, _ = kind
    if mixer == "rwkv":
        xin1 = rms_norm(x, p["ln1"])
        h, st = rwkv_time_mix(p["tmix"], xin1, cfg, return_state=True)
        x = x + h
        xin2 = rms_norm(x, p["ln2"])
        h = rwkv_channel_mix(p["tmix"], xin2, cfg)
        return x + h, {"state": {**st, "cm_x": xin2.float()[:, -1]}}
    h = rms_norm(x, p["ln1"])
    if mixer == "attn" and ctx is not None:
        h = attn_apply(p["mixer"], h, cfg, positions, attn_impl=attn_impl,
                       ctx=ctx)
        got = {}
    elif mixer == "attn":
        h, (k, v) = attn_apply(p["mixer"], h, cfg, positions,
                               attn_impl=attn_impl, return_kv=True)
        got = {"k": k, "v": v}
    else:
        h, st = mamba_apply(p["mixer"], h, cfg, return_state=True)
        got = {"state": st}
    x = x + h
    if "cross" in p and memory is not None:
        h, got["cross"] = attn_apply(p["cross"], rms_norm(x, p["ln_cross"]),
                                     cfg, positions, memory=memory,
                                     return_kv=True)
        x = x + h
    return x + _ffn(p, kind, rms_norm(x, p["ln2"]), cfg, ctx=ctx), got


def _stack_forward(blocks, x: torch.Tensor, cfg, positions: torch.Tensor,
                   kinds, memory=None, attn_impl: str = "masked", ctx=None
                   ) -> torch.Tensor:
    """``x`` through every period of the layer-stacked ``blocks``.  With
    ``cfg.remat``, under autograd, each period is recomputed in the
    backward (``torch.utils.checkpoint``), keeping only its input, as the
    reference's ``jax.checkpoint`` of its scan body."""
    for pp in _layers(blocks):
        def body(xc, pp=pp):
            for j, kind in enumerate(kinds):
                xc, _ = _sublayer(xc, pp[f"l{j}"], kind, cfg, positions,
                                  memory, attn_impl, ctx)
            return xc
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(body, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(x)
    return x


def _encode(params, src: torch.Tensor, cfg) -> torch.Tensor:
    """The encoder over ``src [B, Sm, d]``, then ``enc_norm``.  Its
    attention masks causally, as the reference's does: the reference's
    encoder stack takes its mask from ``memory``, of which it has none."""
    positions = torch.arange(src.shape[1], device=src.device)
    src = _stack_forward(params["encoder"], src, cfg, positions,
                         [("attn", "mlp")])
    return rms_norm(src, params["enc_norm"])


# what a training mesh does not run yet, and the ROADMAP item of each
FSDP_ITEM = ("cfg.fsdp (the embed dim over the data axes: weight gathers) "
             "under a training mesh is ROADMAP Queue 1 item 4")
FAMILY_ITEM = ("the {} family under a training mesh is ROADMAP Queue 1 "
               "item 5 (the recurrent and encoder-decoder families)")


def check_train_mesh(cfg) -> None:
    """Raise for what a training mesh does not run: ``cfg.fsdp`` and the
    families other than dense, VLM and MoE, each naming its item."""
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(FAMILY_ITEM.format(cfg.family))
    if cfg.fsdp:
        raise NotImplementedError(FSDP_ITEM)


def forward_train(params, batch: Dict[str, torch.Tensor], cfg,
                  attn_impl: str = "masked", ctx=None) -> torch.Tensor:
    """The training forward over ``batch["tokens"] [B, S]`` (after a
    frontend config's ``batch["frontend_embeds"] [B, F, d]``; an
    encoder-decoder's decoder cross-attending to the encoder over
    ``batch["src_embeds"] [B, Sm, d]``, the reference's
    ``_encdec_forward``): the final hidden states ``[B, S (+ F), d]``.
    The loss computes the logits in chunks, so the ``[B, S, V]`` tensor
    never exists.

    On a mesh (``ctx``, params placed by ``tree_param_specs``) ``batch``
    is this rank's data shard; the layers run tensor-parallel over the
    model axis and the residual stream stays replicated over it
    (``seq`` sharding is the reference's placement only)."""
    if ctx is not None and ctx.mesh is None:
        ctx = None
    if ctx is not None:
        check_train_mesh(cfg)
    memory = None
    if cfg.family == "encdec":
        memory = _encode(params, batch["src_embeds"].to(cfg.cdtype), cfg)
    x = embed_apply(params["embed"], batch["tokens"], cfg, ctx)
    if cfg.frontend and "frontend_embeds" in batch:
        x = torch.cat([batch["frontend_embeds"].to(x.device, x.dtype), x],
                      dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _stack_forward(params["blocks"], x, cfg, positions, _kinds(cfg),
                       memory, attn_impl, ctx)
    return rms_norm(x, params["final_norm"])


def _stack(leaves: List[Any]) -> Any:
    """Per-period dicts of tensors -> one dict of ``[P, ...]`` stacks."""
    if isinstance(leaves[0], dict):
        return {k: _stack([d[k] for d in leaves]) for k in leaves[0]}
    return torch.stack(leaves)


def forward_prefill(params, batch: Dict[str, torch.Tensor], cfg
                    ) -> Tuple[torch.Tensor, Dict]:
    """The full forward over ``batch["tokens"] [B, S]``; returns ``(final
    hidden [B, S, d], collected)``, stacked over periods:
    ``collected["layers"][f"l{j}"]`` holds the post-RoPE ``k`` / ``v``
    ``[P, B, Hkv, S, hd]`` of an attention layer or the ``state`` of a
    recurrent one; ``collected["cross"]["l0"]`` an encoder-decoder's
    cross K/V ``[P, B, Hkv, Sm, hd]`` of the encoder's output over
    ``batch["src_embeds"] [B, Sm, d]`` (empty for the other families);
    ``collected["len"] = S``.  A frontend config's
    ``batch["frontend_embeds"] [B, F, d]`` are prepended to the token
    embeddings, so ``S`` and the positions count them."""
    kinds = _kinds(cfg)
    memory = None
    if cfg.family == "encdec":
        memory = _encode(params, batch["src_embeds"].to(cfg.cdtype), cfg)
    x = embed_apply(params["embed"], batch["tokens"], cfg)
    if cfg.frontend and "frontend_embeds" in batch:
        x = torch.cat([batch["frontend_embeds"].to(x.device, x.dtype), x],
                      dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    got = {f"l{j}": [] for j in range(len(kinds))}
    for i in range(cfg.n_layers // len(kinds)):
        pp = _layer(params["blocks"], i)
        for j in range(len(kinds)):
            x, col = _sublayer(x, pp[f"l{j}"], kinds[j], cfg, positions,
                               memory)
            got[f"l{j}"].append(col)
    hidden = rms_norm(x, params["final_norm"])
    layers, cross = {}, {}
    for name, cols in got.items():
        pairs = [c.pop("cross") for c in cols if "cross" in c]
        if pairs:
            cross[name] = {"k": torch.stack([k for k, _ in pairs]),
                           "v": torch.stack([v for _, v in pairs])}
        layers[name] = _stack(cols)
    return hidden, {"layers": layers, "cross": cross, "len": x.shape[1]}


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
    if isinstance(c, DenseKVCache):
        return DenseKVCache(fn(c.k), fn(c.v), fn(c.length))
    return {k: fn(v) for k, v in c.items()}


def init_cache(cfg, batch: int, prefix: int, mode: str = "sparse",
               abstract: bool = False,
               device: Optional[torch.device] = None) -> Dict[str, Any]:
    """The one-shot cache, every leaf stacked over periods.  An attention
    layer's ``"kv"``: with ``"sparse"`` the compressed frozen prefix (at
    the balanced capacity the KV sparsities imply) and the dense tail; with
    ``"dense"`` a preallocated cache of ``prefix + kv_tail`` tokens.  A
    recurrent layer's ``"state"`` (Mamba's conv window and SSM state,
    RWKV's WKV state and token-shift rows, all f32).  An encoder-decoder's
    ``"cross"`` K/V ``[P, B, Hkv, prefix, hd]``.  ``abstract=True`` gives
    meta tensors (nothing allocated), otherwise zeros on ``device`` (the
    CUDA device unless the caller asks for the CPU)."""
    kinds = _kinds(cfg)
    n_periods = cfg.n_layers // len(kinds)
    hkv, hd, dt = cfg.n_kv, cfg.hd, cfg.cdtype
    meta = lambda shape, d: torch.empty(shape, dtype=d, device="meta")

    def attn_cache():
        if mode == "sparse":
            return abstract_cache(batch, hkv, prefix, hd,
                                  1.0 - cfg.kv_k_sparsity,
                                  1.0 - cfg.kv_v_sparsity,
                                  tail_size=cfg.kv_tail, dtype=dt)
        kv = meta((batch, hkv, prefix + cfg.kv_tail, hd), dt)
        return DenseKVCache(kv, kv, meta((), torch.int32))

    def leaf(kind):
        if kind[0] == "attn":
            return {"kv": attn_cache()}
        init = mamba_init_state if kind[0] == "mamba" else rwkv_init_state
        return {"state": init(cfg, batch, device="meta")}

    dev = torch.device("meta") if abstract else resolve_device(device)
    stack = lambda t: torch.zeros((n_periods,) + tuple(t.shape),
                                  dtype=t.dtype, device=dev)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev),
             "layers": {f"l{j}": {k: _cache_map(v, stack)
                                  for k, v in leaf(kinds[j]).items()}
                        for j in range(len(kinds))}}
    if cfg.family == "encdec":
        kv = meta((batch, hkv, prefix, hd), dt)
        cache["cross"] = {"k": stack(kv), "v": stack(kv)}
    return cache


def _write_state_(views: Dict[str, torch.Tensor],
                  new: Dict[str, torch.Tensor]) -> None:
    """Copy a step's new state into the cache's views of it, in place."""
    for k, t in new.items():
        if t is not views[k]:
            views[k].copy_(t)


def _sublayer_decode(x_t, p, kind, cache_j, cfg, position, cross_kv=None,
                     ctx=None):
    """One layer of the decode step on ``x_t [B, d]``; ``cache_j`` holds
    this layer's views of the cache (an attention layer's ``"kv"``, a
    recurrent layer's ``"state"``), written in place."""
    mixer, _ = kind
    if mixer == "rwkv":
        h, st = rwkv_time_mix_decode(p["tmix"], rms_norm(x_t, p["ln1"]),
                                     cache_j["state"], cfg)
        x_t = x_t + h
        h, st = rwkv_channel_mix_decode(p["tmix"], rms_norm(x_t, p["ln2"]),
                                        st, cfg)
        _write_state_(cache_j["state"], st)
        return x_t + h
    h = rms_norm(x_t, p["ln1"])
    if mixer == "attn":
        h, _ = attn_decode(p["mixer"], h, cache_j["kv"], cfg, position, ctx)
    else:
        h, st = mamba_decode(p["mixer"], h, cache_j["state"], cfg)
        _write_state_(cache_j["state"], st)
    x_t = x_t + h
    if "cross" in p and cross_kv is not None:
        x_t = x_t + cross_attn_decode(p["cross"], rms_norm(x_t, p["ln_cross"]),
                                      cross_kv[0], cross_kv[1], cfg)
    # an MoE sees the B tokens as [B, 1, d], as in the reference
    h2 = _ffn(p, kind, rms_norm(x_t, p["ln2"])[:, None, :], cfg,
              ctx=ctx)[:, 0]
    return x_t + h2


def forward_decode(params, cache: Dict[str, Any], tokens: torch.Tensor,
                   cfg, ctx=None) -> Tuple[torch.Tensor, Dict]:
    """``tokens [B, 1]`` -> ``(logits [B, V] f32, cache)``: one decode step
    over the legacy cache, whose tails (or dense rows), lengths and
    recurrent states are written **in place**, ``cache["pos"]`` advanced by
    one.  An encoder-decoder's layers attend to ``cache["cross"]``.  A mesh
    ``ctx`` reaches the attention (its context-parallel decode)."""
    kinds = _kinds(cfg)
    x_t = embed_apply(params["embed"], tokens[:, 0], cfg)
    position = cache["pos"]
    cross = cache.get("cross")
    for i in range(cfg.n_layers // len(kinds)):
        pp = _layer(params["blocks"], i)
        ck = None if cross is None else (cross["k"][i], cross["v"][i])
        for j in range(len(kinds)):
            leaf = cache["layers"][f"l{j}"]
            cache_j = ({"kv": leaf["kv"].layer(i)} if "kv" in leaf else
                       {"state": {k: a[i] for k, a in leaf["state"].items()}})
            x_t = _sublayer_decode(x_t, pp[f"l{j}"], kinds[j], cache_j, cfg,
                                   position, ck, ctx)
    x_t = rms_norm(x_t, params["final_norm"])
    logits = unembed_apply(params["embed"], x_t, cfg)
    cache["pos"] += 1
    return logits, cache


# ---------------------------------------------------------------------------
# the pooled serving cache
# ---------------------------------------------------------------------------

def _pooled_ffn(pj, kind, h2: torch.Tensor, cfg, rows=None,
                ctx=None) -> torch.Tensor:
    """The MLP or MoE half of a pooled panel block, run on rows (the panel
    width is invisible to it, as in the reference): an MoE routes all
    ``B * Qn`` rows, masked slots included, in row order (on a mesh this
    rank's slots' rows)."""
    flat = h2.reshape(-1, h2.shape[-1])
    out = _ffn(pj, kind, flat[:, None, :], cfg, rows=rows, ctx=ctx)[:, 0]
    return out.reshape(*h2.shape[:-1], out.shape[-1])


def forward_panel_pooled(params, state: Dict[str, Any],
                         tokens: torch.Tensor, slot_mask: torch.Tensor,
                         cfg, bs: int, ctx=None, shards: int = 1
                         ) -> Tuple[torch.Tensor, Dict]:
    """THE per-token serving forward: score a ``[B, Qn]`` token panel per
    slot over the pooled cache (``Qn == 1`` is a decode tick).

    Every live slot's ``Qn`` fresh K/V are appended to its tail ring and
    its ``pos`` / ``tail_len`` advance by ``Qn``; masked slots are left
    untouched.  Returns ``(logits [B, Qn, V] f32, state)``.  On a mesh
    (``ctx``) the panel's rows are this rank's slots and the state its
    shard: only the attention's heads cross the model axis (gathered
    before ``wo``), and nothing crosses the data axis.  The panel is then
    one of ``shards`` data shards, and the sparse linears pick their kernel
    by the whole panel's rows, as one rank would."""
    qn = tokens.shape[1]
    rows = None if shards == 1 else tokens.shape[0] * qn * shards
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
                                  err=state.get("err"), ctx=ctx, rows=rows)
            x = x + h
            x = x + _pooled_ffn(pj, kinds[j], rms_norm(x, pj["ln2"]), cfg,
                                rows, ctx)
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
                          new_ids=None, length=None, write=None, ctx=None
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
    guarantee.  On a mesh (``ctx``) the slot is one of this rank's and the
    state its shard: the rank freezes its KV heads' blocks."""
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
                bs, slot, table_row=table_row, ctx=ctx)
            x = x + h
            # an MoE takes the capacity of the L valid rows, as the
            # reference's chunk of length L does; no ctx: the chunk runs on
            # its slot's data group alone, so nothing may cross data ranks
            x = x + _ffn(pj, kinds[jj], rms_norm(x, pj["ln2"]), cfg,
                         length=ln)
            if err is not None:
                nan = torch.isnan(k_c[0]).any(2).any(0) | \
                    torch.isnan(v_c[0]).any(2).any(0)
                flag_(err, nan & valid, NAN_CHECK)
            # this layer's attention has read the slot's prefix: freeze the
            # chunk into it now (layers never read each other's storage)
            if nbw:
                frozen = freeze_heads(
                    k_c[:, :, :nbw * bs], v_c[:, :, :nbw * bs],
                    cfg.kv_k_sparsity, cfg.kv_v_sparsity, bs,
                    kvl["k_values"].shape[-1], kvl["v_values"].shape[-1],
                    ctx, cfg.n_kv)
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
