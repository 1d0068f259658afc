"""Mesh placement of the pooled serving state (twin of
``repro.distributed.serving_sharding``).

The continuous-batching engine's device state is a tree of
``[slots]``-leading vectors (lengths, sampling lanes) and pooled cache
leaves ``[P, slots, Hkv, ...]``.  On a mesh, **slots shard over the data
axes** (each rank owns a block of the concurrent requests) and **KV heads
over the model axis** (each rank owns a block of each request's cache).
The owners describe their own layout (``CachePool.state_axes``,
``sampling.lane_axes``); the specs come from the same ``ShardCtx.spec``
rules the training side uses, so a leaf whose dim does not divide its axis
replicates (4 slots on data = 8 replicate, as in the reference's ``dp8``).

**Paged pool.**  Any slot may point its block-table row at any physical
page, so the arena's physical-block axis is REPLICATED over the data axes
while its KV-head axis still shards over the model axis; the block table
shards with its slots; the refcount is replicated.  The engine keeps the
replicas equal: every page a rank writes in a tick, and its refcount
changes, reach every rank of its model group in that tick
(``ContinuousEngine._share_pages``).

Weights are replicated.  Where the reference returns ``NamedSharding``s,
the port returns its :class:`~.sharding.PartitionSpec`s, and
:func:`shard_state` cuts a full state down to this rank's blocks.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.core.sparse_kv import freeze_chunk_blocks
from .sharding import (PartitionSpec, ShardCtx, all_gather, default_rules,
                       local_shard)


def serving_ctx(mesh, cfg=None) -> ShardCtx:
    """ShardCtx for serving: the default logical-axis rules (slots and
    batch over data, kv_heads / heads / vocab over model) on ``mesh``;
    ``mesh=None`` is the single-rank no-op context."""
    if mesh is None:
        return ShardCtx()
    multi_pod = "pod" in mesh.shape
    rules = default_rules(multi_pod, cfg)
    # serving activations are [slots, ...]: their batch dim goes where the
    # state's slot dim goes
    rules["batch"] = rules["slots"]
    return ShardCtx(mesh, rules)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, PartitionSpec) and all(
        a is None or isinstance(a, str) for a in x)


def leaf_sharding(ctx: ShardCtx, axes: Sequence[Optional[str]],
                  leaf) -> PartitionSpec:
    """The spec of one leaf from its logical axes (an axis that does not
    divide falls back to replication)."""
    return ctx.spec(axes, tuple(leaf.shape))


def tree_shardings(ctx: ShardCtx, axes_tree: Any, tree: Any) -> Any:
    """An axes tree + a matching state tree -> a tree of specs (leaves
    matched by key)."""
    if _is_axes(axes_tree):
        return leaf_sharding(ctx, axes_tree, tree)
    return {k: tree_shardings(ctx, v, tree[k]) for k, v in axes_tree.items()}


def state_shardings(ctx: ShardCtx, state: Any, axes_tree: Any) -> Any:
    """Specs of the engine's full device state (pool + lanes); only shapes
    are read."""
    return tree_shardings(ctx, axes_tree, state)


def token_sharding(ctx: ShardCtx, slots: int) -> PartitionSpec:
    """Spec of per-tick ``[slots, Q]`` token panels (any Q)."""
    return ctx.spec(("slots", None), (slots, 1))


def vec_sharding(ctx: ShardCtx, slots: int) -> PartitionSpec:
    """Spec of ``[slots]`` per-tick vectors (masks, draft lengths, sampled
    tokens, chosen-token logprobs)."""
    return ctx.spec(("slots",), (slots,))


def replicated(ctx: ShardCtx) -> PartitionSpec:
    """Full replication (scalars, small host-fed operands)."""
    return PartitionSpec()


def shard_state(ctx: ShardCtx, state: Any, axes_tree: Any) -> Any:
    """A full state tree in, this rank's blocks out (fresh contiguous
    tensors that own their storage)."""
    specs = state_shardings(ctx, state, axes_tree)

    def cut(spec, leaf):
        if isinstance(spec, dict):
            return {k: cut(spec[k], leaf[k]) for k in spec}
        return local_shard(leaf, spec, ctx.mesh).contiguous().clone()
    if ctx.mesh is None:
        return state
    return cut(specs, state)


def describe(ctx: ShardCtx, state: Any, axes_tree: Any) -> Dict[str, str]:
    """Placement summary, ``{"layers/l0/kv/k_values": "PartitionSpec(...)"}``
    (launcher logging)."""
    out: Dict[str, str] = {}

    def walk(spec, path):
        if isinstance(spec, dict):
            for k, v in spec.items():
                walk(v, f"{path}/{k}" if path else k)
        else:
            out[path] = repr(spec)
    walk(state_shardings(ctx, state, axes_tree), "")
    return out


def local_slots(ctx: ShardCtx, slots: int) -> range:
    """The global slot ids this rank holds (all of them when the slots
    replicate)."""
    start, n = ctx.shard_range("slots", slots)
    return range(start, start + n)


def local_heads(ctx: ShardCtx, hkv: int) -> range:
    """The KV heads this rank holds (all of them when they replicate)."""
    start, n = ctx.shard_range("kv_heads", hkv)
    return range(start, start + n)


def freeze_heads(k: torch.Tensor, v: torch.Tensor, k_sparsity: float,
                 v_sparsity: float, bs: int, cap_k: int, cap_v: int, ctx,
                 n_kv: int):
    """``freeze_chunk_blocks`` of a chunk whose ``k``/``v`` ``[B, Hkv, C,
    D]`` hold this rank's KV heads (all ``n_kv`` off a mesh).  The
    magnitude threshold spans every head, so where the model axis splits
    the heads a pruned chunk's heads are all-gathered over it first and the
    rank keeps its heads' blocks: the bytes equal the unsharded freeze's.
    At zero sparsity every head packs alone and nothing is gathered."""
    h0, hl = (0, n_kv) if ctx is None else ctx.shard_range("kv_heads", n_kv)
    if hl == n_kv or (k_sparsity == 0 and v_sparsity == 0):
        return freeze_chunk_blocks(k, v, k_sparsity, v_sparsity, bs, cap_k,
                                   cap_v)
    axis = ctx.spec(("kv_heads",), (n_kv,))[0]
    full = freeze_chunk_blocks(all_gather(k, ctx.mesh, axis, 1),
                               all_gather(v, ctx.mesh, axis, 1), k_sparsity,
                               v_sparsity, bs, cap_k, cap_v)
    return tuple(t.narrow(1, h0, hl).contiguous() for t in full)
