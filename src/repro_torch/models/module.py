"""Parameter specs and initialisation (twin of ``repro.models.module``).

A model is a nested dict of :class:`ParamSpec`.  ``initialize`` draws each
leaf from its own ``torch.Generator``, seeded from the root seed and an MD5
of the leaf's path, so a leaf's values do not depend on the order of the
tree walk.  The draws are not JAX's bits: parity tests carry the
reference's own weights over with :mod:`repro_torch.bridge`.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    axes: Tuple[Optional[str], ...] = ()
    init: str = "fan_in"          # fan_in | normal | zeros | ones | embed | small
    scale: float = 1.0

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} do not match shape {self.shape}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                  is_leaf: Callable[[Any], bool] = is_spec,
                  prefix: str = "") -> Any:
    """Apply ``fn(path, leaf)`` over a nested dict; paths are
    ``"a/b/c"`` exactly as the reference spells them."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: map_with_path(fn, v, is_leaf,
                                 f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree) if is_leaf(tree) else tree


def _leaf_generator(path: str, seed: int, device: torch.device
                    ) -> torch.Generator:
    leaf = int.from_bytes(hashlib.md5(path.encode()).digest()[:4], "little")
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0x7FFFFFFF) << 32) | leaf)
    return g


def _init_leaf(path: str, spec: ParamSpec, seed: int,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    g = _leaf_generator(path, seed, device)
    z = torch.randn(spec.shape, generator=g, dtype=torch.float32,
                    device=device)
    if spec.init == "embed":
        std = 0.02 * spec.scale
    elif spec.init == "small":
        std = 1e-2 * spec.scale
    elif spec.init == "normal":
        std = spec.scale
    else:
        # fan_in: variance scaling on the second-to-last dim (matmul RHS)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / max(fan_in, 1) ** 0.5
    return (z * std).to(spec.dtype)


def initialize(tree: Any, seed: int, device: torch.device) -> Any:
    return map_with_path(lambda p, s: _init_leaf(p, s, seed, device), tree)


def abstract(tree: Any) -> Any:
    """Meta tensors of the specs' shapes and dtypes (nothing allocated)."""
    return map_with_path(lambda p, s: torch.empty(s.shape, dtype=s.dtype,
                                                  device="meta"), tree)


def tree_leaves(tree: Any) -> list:
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_part(tree: Any, i: int) -> Any:
    """Element ``i`` of every leaf of a tree whose leaves are tuples."""
    return tree_map(lambda t: t[i], tree)
