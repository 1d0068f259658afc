"""Logical-axis sharding rules, the model-visible shard context and the
collectives (twin of ``repro.distributed.sharding``).

Logical axes used by param specs and the pooled state:

  batch     -> (pod, data)      activations' batch dim
  slots     -> (pod, data)      serving cache-pool slot dim
  seq       -> model iff cfg.seq_shard (the reference's Megatron sequence
               sharding of the residual stream)
  ctx       -> data + model     KV-cache sequence dim (context-parallel
               decode)
  embed     -> data (+pod) iff cfg.fsdp, else None
  heads, kv_heads, ffn, vocab, expert_in -> model   (tensor parallel)
  experts   -> data (+pod) iff cfg.ep_moe, else None
  layers    -> None

Every mapping degrades to ``None`` (replication) when the dim size does not
divide the mesh axis, and the first use of a mesh axis in one spec wins.

**Explicit SPMD.**  The reference places arrays with ``NamedSharding`` and
lets XLA insert the collectives (``constrain``, ``to_named``).  The port's
ranks are processes, so placement is explicit: :func:`local_shard` cuts a
full tensor down to this rank's block of a spec, and every collective of
the port goes through :func:`all_gather` (over one mesh axis, concatenated
in coordinate order) or :func:`all_reduce` (``"sum"`` or ``"max"``).  An
axis of size 1 costs nothing.  Under the ``gloo`` backend a CUDA tensor is
staged through pinned host memory explicitly (gloo's own CUDA support
varies by op and version); :data:`STATS` counts every collective's calls,
bytes and host seconds, and the staged calls apart.

The serving forwards keep the residual stream replicated over the model
axis: ``seq`` is placement only in the reference, and the port's pooled
forwards gather the attention heads before ``wo`` instead
(``models/attention.py``).

**Training** (the reference's jitted train step under ``NamedSharding``s)
places each rank's shard of the params with :func:`place` (the specs of
:func:`tree_param_specs`; :func:`gather_tree` is its inverse) and runs the
forward and backward through four ``torch.autograd.Function`` classes in the
Megatron pattern, each a call of :func:`all_gather` or :func:`all_reduce`
(so :data:`STATS` counts them, and gloo stages them):

  :func:`copy_to`        identity forward, all-reduce backward (the input
                         of a column-parallel product);
  :func:`reduce_from`    all-reduce forward, identity backward (the output
                         of a row-parallel product);
  :func:`gather_dim`     all-gather forward, this rank's slice backward;
  :func:`reduce_scatter` all-reduce and this rank's slice forward,
                         all-gather backward.

The loss on every rank is the same replicated value, so a leaf's gradient
on a rank is its share of the whole gradient: the model code puts a
:func:`copy_to` on every model-replicated leaf whose use differs between
model ranks (``q_norm``, ``k_norm``, the router), and the train step sums
the data axes that do not shard a leaf (``train/step.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.sparse_format import BlockSparseWeight


class PartitionSpec(tuple):
    """One entry per dim: a mesh axis name, a tuple of names or None (the
    reference's ``jax.sharding.PartitionSpec``, element for element)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axis_size(mesh, axis) -> int:
    if mesh is None or axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _axes(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of mesh axis names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclasses.dataclass
class ShardCtx:
    """Model-visible sharding context.  ``mesh=None`` -> single-rank no-op.
    ``mesh`` needs only a ``shape`` mapping for the spec derivation; the
    collectives and :meth:`shard_range` need a
    :class:`repro_torch.launch.mesh.Mesh`."""
    mesh: Any = None
    rules: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def spec(self, axes: Sequence[Optional[str]],
             sizes: Sequence[int] = None) -> PartitionSpec:
        used: set = set()
        out = []
        for i, ax in enumerate(axes):
            mesh_ax = self.rules.get(ax) if ax is not None else None
            if mesh_ax is None:
                out.append(None)
                continue
            keep = tuple(a for a in _axes(mesh_ax) if a not in used)
            if sizes is not None and keep:
                n = 1
                for a in keep:
                    n *= self.mesh.shape[a]
                if sizes[i] % n != 0:
                    keep = ()
            used.update(keep)
            out.append(None if not keep else
                       (keep if len(keep) > 1 else keep[0]))
        return PartitionSpec(*out)

    @property
    def tp_axis(self) -> Optional[str]:
        return self.rules.get("ffn")

    @property
    def dp_axes(self):
        return self.rules.get("batch")

    def axis_size(self, logical: str) -> int:
        return mesh_axis_size(self.mesh, self.rules.get(logical))

    def mesh_axes(self, logical: str) -> Tuple[str, ...]:
        """The mesh axes of size above 1 that ``logical`` maps to (``()``
        without a mesh): the axes a collective over it must cross."""
        if self.mesh is None:
            return ()
        return tuple(a for a in _axes(self.rules.get(logical))
                     if a in self.mesh.shape and self.mesh.shape[a] > 1)

    def shard_range(self, logical: str, size: int) -> Tuple[int, int]:
        """``(start, count)`` of this rank's block of a ``size``-long dim on
        the logical axis ``logical`` (the whole dim when it replicates)."""
        if self.mesh is None:
            return 0, size
        entry = self.spec((logical,), (size,))[0]
        n = mesh_axis_size(self.mesh, entry)
        if n == 1:
            return 0, size
        return shard_index(self.mesh, _axes(entry)) * (size // n), size // n


NULL_CTX = ShardCtx()


def default_rules(multi_pod: bool, cfg=None) -> Dict[str, Any]:
    dp = ("pod", "data") if multi_pod else ("data",)
    rules: Dict[str, Any] = {
        "batch": dp,
        "slots": dp,
        "ctx": dp + ("model",),
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "vocab": "model",
        "expert_in": "model",
        "experts": None,
        "layers": None,
        "seq": None,
        "embed": None,
        "ssm_inner": "model",
        "state": None,
    }
    if cfg is not None:
        if cfg.seq_shard:
            rules["seq"] = "model"
        if cfg.fsdp:
            rules["embed"] = dp
        if getattr(cfg, "ep_moe", False):
            rules["experts"] = dp
    return rules


# ---------------------------------------------------------------------------
# param specs (dense ParamSpec trees and converted sparse trees)
# ---------------------------------------------------------------------------

def _sparse_leaf_spec(ctx: ShardCtx, sw: BlockSparseWeight,
                      k_ax: Optional[str], n_ax: Optional[str]
                      ) -> BlockSparseWeight:
    """Specs for a BlockSparseWeight: the block axes inherit the dense
    tensor's logical axes; leading stacked dims and the packed trailing
    dim are unsharded."""
    lead = (None,) * (sw.bitmap.dim() - 3)
    kb, nb = sw.bitmap.shape[-3:-1]
    s2 = ctx.spec(lead + (k_ax, n_ax, None), sw.lead_shape + (kb, nb, 1))
    scale_spec = None
    if sw.scale is not None:
        scale_spec = PartitionSpec(*(lead + (s2[len(lead) + 1],)))
    return BlockSparseWeight(bitmap=s2, values=s2, scale=scale_spec,
                             shape=sw.shape, block=sw.block,
                             packed4=sw.packed4)


def tree_param_specs(ctx: ShardCtx, spec_tree: Any, params_tree: Any) -> Any:
    """Spec tree for a (possibly sparse-converted) params tree.
    ``spec_tree`` carries the logical axes (ParamSpec leaves); where the
    params tree has a BlockSparseWeight, its block axes inherit the last
    two logical axes of the original spec."""
    if isinstance(spec_tree, dict):
        return {k: tree_param_specs(ctx, v, params_tree[k])
                for k, v in spec_tree.items()}
    ps, leaf = spec_tree, params_tree
    if isinstance(leaf, BlockSparseWeight):
        axes = ps.axes or (None,) * len(ps.shape)
        return _sparse_leaf_spec(ctx, leaf, axes[-2], axes[-1])
    return ctx.spec(ps.axes or (None,) * len(leaf.shape), tuple(leaf.shape))


def zero1_specs(pspec_tree: Any, params_tree: Any, cfg, ctx: ShardCtx) -> Any:
    """ZeRO-1: optimizer-state specs = param specs + data-parallel sharding
    on the first unsharded, dp-divisible dim.  The train step keeps each
    rank's ``master`` / ``m`` / ``v`` at these specs (``optim/adamw.py``)."""
    dp = tuple(a for a in _axes(ctx.rules.get("batch")) if a is not None)

    def one(spec: PartitionSpec, leaf):
        if not getattr(cfg, "zero1", False) or not dp or len(leaf.shape) == 0:
            return spec
        dims = list(spec) + [None] * (len(leaf.shape) - len(spec))
        used = {a for d in dims for a in _axes(d)}
        free = tuple(a for a in dp if a not in used)
        if not free:
            return spec
        n = mesh_axis_size(ctx.mesh, free)
        for i, d in enumerate(dims):
            if d is None and leaf.shape[i] % n == 0 and leaf.shape[i] >= n:
                dims[i] = free if len(free) > 1 else free[0]
                break
        return PartitionSpec(*dims)

    def walk(s, p):
        if isinstance(s, PartitionSpec):
            return one(s, p)
        if isinstance(s, BlockSparseWeight):      # its array leaves, as a
            return BlockSparseWeight(              # pytree walk reaches them
                one(s.bitmap, p.bitmap), one(s.values, p.values),
                None if s.scale is None else one(s.scale, p.scale),
                s.shape, s.block, s.packed4)
        if isinstance(s, dict):
            return {k: walk(v, p[k]) for k, v in s.items()}
        return s
    return walk(pspec_tree, params_tree)


# ---------------------------------------------------------------------------
# explicit SPMD: this rank's shard and the collectives
# ---------------------------------------------------------------------------

# every collective of the port: calls, payload bytes (this rank's send
# side) and host seconds, and how many of the calls went through host
# memory under gloo
STATS: Dict[str, float] = {"calls": 0, "bytes": 0, "seconds": 0.0,
                           "staged": 0}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0, staged=0)


def shard_index(mesh, axes: Tuple[str, ...]) -> int:
    """This rank's block index over ``axes`` (the first axis major)."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.coordinate(a)
    return i


def local_slices(shape: Sequence[int], spec: Sequence, mesh
                 ) -> Tuple[slice, ...]:
    """The index of this rank's block of an array of ``shape`` under
    ``spec``, one slice a dim (a torch tensor or a numpy array)."""
    out = [slice(None)] * len(shape)
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        n = mesh_axis_size(mesh, axes)
        if n > 1:
            size = shape[dim] // n
            i = shard_index(mesh, axes) * size
            out[dim] = slice(i, i + size)
    return tuple(out)


def local_shard(tensor: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of ``tensor`` under ``spec`` (a view)."""
    return tensor[local_slices(tensor.shape, spec, mesh)]


def _staged(t: torch.Tensor, mesh) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _host(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` copied into ``mesh``'s pinned staging buffer of its dtype (a
    view, valid until the next staged call: every collective here blocks
    until its result is back on the device)."""
    buf = mesh.staging.get(t.dtype)
    if buf is None or buf.numel() < t.numel():
        buf = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
        mesh.staging[t.dtype] = buf
    host = buf[:t.numel()].view(t.shape)
    host.copy_(t)
    return host


def _count(t: torch.Tensor, staged: bool, t0: float) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    STATS["staged"] += int(staged)
    STATS["seconds"] += time.perf_counter() - t0


def all_gather(tensor: torch.Tensor, mesh, axis, dim: int = 0
               ) -> torch.Tensor:
    """Concatenate every rank's ``tensor`` along ``dim`` in coordinate
    order over ``axis`` (a name or a tuple of names, the first major);
    ``tensor`` itself when the axes have size 1."""
    import torch.distributed as dist
    axes = _axes(axis)
    if mesh_axis_size(mesh, axes) == 1:
        return tensor
    for a in reversed(axes):           # the last axis is minor: gather first
        n = mesh.shape[a]
        if n == 1:
            continue
        t0 = time.perf_counter()
        staged = _staged(tensor, mesh)
        src = _host(tensor, mesh) if staged else tensor.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=mesh.group(a))
        out = torch.cat(parts, dim=dim)
        tensor = out.to(tensor.device, non_blocking=False) if staged else out
        _count(src, staged, t0)
    return tensor


def all_reduce(tensor: torch.Tensor, mesh, axis, op: str = "sum"
               ) -> torch.Tensor:
    """The elementwise ``"sum"`` or ``"max"`` of every rank's ``tensor``
    over ``axis`` (a name or a tuple of names), as a new tensor."""
    import torch.distributed as dist
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    axes = _axes(axis)
    if mesh_axis_size(mesh, axes) == 1:
        return tensor
    for a in axes:
        if mesh.shape[a] == 1:
            continue
        t0 = time.perf_counter()
        staged = _staged(tensor, mesh)
        buf = _host(tensor, mesh) if staged else \
            tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=red, group=mesh.group(a))
        tensor = buf.to(tensor.device) if staged else buf
        _count(buf, staged, t0)
    return tensor


def slice_of(tensor: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """This rank's block of ``tensor`` along ``dim`` over ``axis`` (a name
    or a tuple of names, the first major): the inverse of
    :func:`all_gather`."""
    axes = _axes(axis)
    n = mesh_axis_size(mesh, axes)
    if n == 1:
        return tensor
    size = tensor.shape[dim] // n
    return tensor.narrow(dim, shard_index(mesh, axes) * size, size)


# ---------------------------------------------------------------------------
# collectives under autograd (the Megatron pattern)
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (slice_of(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None,
                None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return slice_of(all_reduce(x, mesh, axis), mesh, axis,
                        dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def _trivial(mesh, axis) -> bool:
    return mesh is None or mesh_axis_size(mesh, _axes(axis)) == 1


def copy_to(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``axis``."""
    return x if _trivial(mesh, axis) else _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axis``; the gradient passes
    through as it is."""
    return x if _trivial(mesh, axis) else _ReduceFrom.apply(x, mesh, axis)


def gather_dim(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` over ``axis``; the
    gradient is this rank's slice of the output's."""
    return x if _trivial(mesh, axis) else \
        _GatherDim.apply(x, mesh, axis, dim)


def reduce_scatter(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of every rank's ``x``
    over ``axis``; the gradient is every rank's slice gradient gathered."""
    return x if _trivial(mesh, axis) else \
        _ReduceScatter.apply(x, mesh, axis, dim)


# ---------------------------------------------------------------------------
# placement of whole trees
# ---------------------------------------------------------------------------

def _spec_map(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over the tensor leaves of nested dicts; a spec of
    None leaves its leaf as it is."""
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v, specs[k]) for k, v in tree.items()}
    return tree if specs is None else fn(tree, specs)


def place(tree: Any, spec_tree: Any, mesh) -> Any:
    """This rank's shard of every leaf of the full ``tree`` under
    ``spec_tree`` (fresh contiguous tensors that own their storage; a
    layer-stacked linear cut along K is laid out again by whoever stores
    it for the dense kernel, ``serving/engine.py::params_to``)."""
    return _spec_map(lambda t, s: local_shard(t, s, mesh).contiguous()
                     .clone(), tree, spec_tree)


def gather_tree(tree: Any, spec_tree: Any, mesh) -> Any:
    """The full tensors of a placed ``tree`` (every rank gets them): the
    inverse of :func:`place`."""
    def full(t, spec):
        for dim, entry in enumerate(spec):
            t = all_gather(t.contiguous(), mesh, entry, dim)
        return t
    return _spec_map(full, tree, spec_tree)


def spec_axes(spec: Sequence) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over, in spec order."""
    return tuple(a for entry in spec for a in _axes(entry))


def zero1_dim(pspec: Sequence, zspec: Sequence) -> Tuple[Optional[int],
                                                         Tuple[str, ...]]:
    """Where ZeRO-1 cut a leaf further than its param spec: ``(dim, axes)``
    of the entry :func:`zero1_specs` added, or ``(None, ())``."""
    base = list(pspec) + [None] * (len(zspec) - len(pspec))
    for dim, (z, p) in enumerate(zip(zspec, base)):
        if _axes(z) != _axes(p):
            return dim, _axes(z)
    return None, ()


def zero1_shard(t: torch.Tensor, pspec: Sequence, zspec: Sequence,
                mesh) -> torch.Tensor:
    """This rank's ZeRO-1 block of ``t``, a leaf already placed at
    ``pspec``: its slice along the dim :func:`zero1_specs` added."""
    dim, axes = zero1_dim(pspec, zspec)
    return t if dim is None else slice_of(t, mesh, axes, dim)
