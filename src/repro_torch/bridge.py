"""Carry the reference's arrays into the port, array for array.

The parity tests flatten the JAX params pytree (and pool state) into nested
dicts of numpy arrays — a ``BlockSparseWeight`` becomes a dict with
``bitmap``, ``values``, ``scale``, ``shape``, ``block`` and ``packed4`` —
and hand them here.  Nothing is re-packed:

* uint32 arrays (bitmap words) become int32 bit-views of the same bits;
* bfloat16 arrays (numpy's ``bfloat16`` extension dtype) are reinterpreted
  through ``uint16`` without importing the package that defines the dtype;
* everything else is copied as is (an MoE's f32 router and its dense
  ``[L, E, K, N]`` expert stacks among them).

This module imports neither JAX nor anything of the reference package.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.sparse_format import BlockSparseWeight

_SPARSE_KEYS = {"bitmap", "values", "scale", "shape", "block", "packed4"}


def tensor_from_numpy(a, device) -> torch.Tensor:
    # np.array copies: the arrays handed over may be read-only views
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16)))
        return t.view(torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        return torch.from_numpy(np.array(a.view(np.int32))).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        if set(tree) == _SPARSE_KEYS:
            return BlockSparseWeight(
                bitmap=tensor_from_numpy(tree["bitmap"], device),
                values=tensor_from_numpy(tree["values"], device),
                scale=(None if tree["scale"] is None
                       else tensor_from_numpy(tree["scale"], device)),
                shape=tuple(int(s) for s in tree["shape"]),
                block=tuple(int(s) for s in tree["block"]),
                packed4=bool(tree["packed4"]))
        return {k: _convert(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def params_from_numpy(tree: Any, cfg, device="cpu") -> Any:
    """The port's params from the reference's (flattened to numpy)."""
    del cfg                      # layouts are identical leaf for leaf
    return _convert(tree, device)


def state_from_numpy(tree: Any, device="cpu") -> Any:
    """The port's pool state from the reference's (flattened to numpy)."""
    return _convert(tree, device)
