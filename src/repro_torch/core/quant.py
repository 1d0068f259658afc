"""Symmetric int8 / int4 quantisation (twin of ``repro.core.quant``).

Weights: per-output-channel symmetric int8 (f32 scale ``[N]``), or int4
values in ``[-7, 7]`` held in int8 (nibble-packed at pack time).
Activations: dynamic per-row symmetric int8.  The matmul accumulates in
int32 and rescales ``out[m, n] = acc[m, n] * s_act[m] * s_w[n]``.

Bit-identical to the reference: the division is f32 on both sides and both
``torch.round`` and ``jnp.round`` round half to even.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _quantize(a: torch.Tensor, dim: int, qmax: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    af = a.to(torch.float32)
    amax = af.abs().amax(dim=dim)
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = torch.clamp(torch.round(af / scale.unsqueeze(dim)), -qmax, qmax)
    return q.to(torch.int8), scale


def quantize_weight_int8(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[K, N]`` -> (int8 ``[K, N]``, f32 scale ``[N]``)."""
    return _quantize(w, 0, 127.0)


def quantize_weight_int4(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[K, N]`` -> (int4-valued int8 ``[K, N]`` in ``[-7, 7]``, f32 scale
    ``[N]``) — the paper's §8 int4 extension."""
    return _quantize(w, 0, 7.0)


def quantize_act_int8(x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., K]`` -> (int8, f32 per-row scale ``[...]``)."""
    return _quantize(x, -1, 127.0)


def dequantize(q: torch.Tensor, scale: torch.Tensor, axis: int = -1,
               dtype=torch.float32) -> torch.Tensor:
    shape = [1] * q.dim()
    shape[axis] = q.shape[axis]
    return (q.to(torch.float32) * scale.reshape(shape)).to(dtype)
