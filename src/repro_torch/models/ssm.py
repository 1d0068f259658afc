"""Recurrent mixers: Mamba (Jamba's 7-of-8 layers) and RWKV-6 "Finch"
(twin of ``repro.models.ssm``, the serving half).

The reference runs each recurrence as a chunked ``lax.scan`` over time,
outside any Pallas kernel; here it is a Python loop over time in f32 that
calls the same step function as the one-token decode (:func:`_scan`).
The reference's chunking (``_chunked_scan``: a scan of ``scan_chunk``-step
scans, with ``jax.checkpoint`` on each chunk) only shapes the backward
pass; the forward values are those of one scan, so the loop stands for
both of its branches.

Every projection goes through :func:`repro_torch.kernels.ops.linear`, as
in the reference, so on the card a decode step's linears run the sparse
gemv, a prefill's the sparse matmul, and Mamba's dense ``w_bcdt`` the
dense kernel.  The small f32 products (the decay LoRA, ``dt_w``) are
plain ``torch`` products, as the reference's are plain ``jnp``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .layers import rms_norm
from .module import ParamSpec


def _scan(step: Callable, carry: torch.Tensor, xs_t: Tuple[torch.Tensor, ...]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.scan`` over the leading (time) axis of every tensor of
    ``xs_t``: returns the final carry and the stacked per-step outputs."""
    ys = []
    for t in range(xs_t[0].shape[0]):
        carry, y = step(carry, tuple(a[t] for a in xs_t))
        ys.append(y)
    return carry, torch.stack(ys)


# ===========================================================================
# Mamba (selective SSM), as used by Jamba
# ===========================================================================

def mamba_specs(cfg) -> Dict[str, ParamSpec]:
    d, di, n, dc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    rank = max(d // 16, 8)
    dt = cfg.pdtype
    f32 = torch.float32
    return {
        "w_in": ParamSpec((d, 2 * di), dt, ("embed", "ssm_inner")),
        "conv_w": ParamSpec((dc, di), f32, (None, "ssm_inner"),
                            init="small"),
        "conv_b": ParamSpec((di,), f32, ("ssm_inner",), init="zeros"),
        "w_bcdt": ParamSpec((di, rank + 2 * n), dt, ("ssm_inner", None)),
        "dt_w": ParamSpec((rank, di), f32, (None, "ssm_inner"),
                          init="small"),
        "dt_b": ParamSpec((di,), f32, ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((di, n), f32, ("ssm_inner", "state"),
                           init="zeros"),
        "d_skip": ParamSpec((di,), f32, ("ssm_inner",), init="ones"),
        "w_out": ParamSpec((di, d), dt, ("ssm_inner", "embed")),
    }


def _mamba_conv_train(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over seq: x [B, S, di], w [dc, di]."""
    dc = w.shape[0]
    out = x * w[dc - 1]
    for i in range(1, dc):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[dc - 1 - i]
    return out + b


def _mamba_step(h: torch.Tensor, xs, a: torch.Tensor,
                d_skip: torch.Tensor):
    """h' = dA h + dB x; y = C.h + D x.  Shapes: h [B, di, N]."""
    xc_t, dt_t, b_t, c_t = xs          # [B, di], [B, di], [B, N], [B, N]
    da = torch.exp(dt_t[..., None] * a)                     # [B, di, N]
    db = dt_t[..., None] * b_t[:, None, :]                  # [B, di, N]
    h = da * h + db * xc_t[..., None]
    y = torch.einsum("bdn,bn->bd", h, c_t) + d_skip * xc_t
    return h, y


def _mamba_bcdt(p, xc: torch.Tensor, dtype, rank: int, n: int):
    """``w_bcdt``'s projection split into ``dt`` (softplus'd through
    ``dt_w``), ``B`` and ``C``, all f32."""
    bcdt = ops.linear(xc.to(dtype), p["w_bcdt"]).float()
    dt_lo, b_ssm, c_ssm = torch.split(bcdt, [rank, n, n], dim=-1)
    dt = F.softplus(dt_lo @ p["dt_w"] + p["dt_b"])
    return dt, b_ssm, c_ssm


def mamba_apply(p, x: torch.Tensor, cfg, return_state: bool = False):
    """Prefill path. x [B, S, d] -> [B, S, d] (and, with ``return_state``,
    the decode state: the conv window ``x_in[:, -(d_conv - 1):]`` before
    the conv, and the final SSM state)."""
    n = cfg.d_state
    rank = p["dt_w"].shape[0]
    x_in, z = torch.chunk(ops.linear(x, p["w_in"]), 2, dim=-1)  # [B,S,di]
    xc = F.silu(_mamba_conv_train(x_in.float(), p["conv_w"], p["conv_b"]))
    dt, b_ssm, c_ssm = _mamba_bcdt(p, xc, x.dtype, rank, n)
    a = -torch.exp(p["a_log"])                               # [di, N]
    xs_t = tuple(t.transpose(0, 1) for t in (xc, dt, b_ssm, c_ssm))
    h0 = torch.zeros((x.shape[0], cfg.d_inner, n), dtype=torch.float32,
                     device=x.device)
    h_fin, ys = _scan(lambda c, xs: _mamba_step(c, xs, a, p["d_skip"]),
                      h0, xs_t)
    y = (ys.transpose(0, 1) * F.silu(z.float())).to(x.dtype)
    out = ops.linear(y, p["w_out"])
    if return_state:
        conv = x_in.float()[:, -(cfg.d_conv - 1):]
        return out, {"conv": conv, "ssm": h_fin}
    return out


def mamba_init_state(cfg, batch: int, dtype=torch.float32, device=None):
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return {"conv": z(batch, cfg.d_conv - 1, cfg.d_inner),
            "ssm": z(batch, cfg.d_inner, cfg.d_state)}


def mamba_decode(p, x_t: torch.Tensor, state, cfg
                 ) -> Tuple[torch.Tensor, Any]:
    """One-token step. x_t [B, d]; returns the output and the new state
    (fresh tensors: the caller decides where they are stored)."""
    n = cfg.d_state
    rank = p["dt_w"].shape[0]
    x_in, z = torch.chunk(ops.linear(x_t, p["w_in"]), 2, dim=-1)  # [B,di]
    window = torch.cat([state["conv"], x_in.float()[:, None]], dim=1)
    xc = F.silu(torch.einsum("bcd,cd->bd", window, p["conv_w"])
                + p["conv_b"])
    dt, b_ssm, c_ssm = _mamba_bcdt(p, xc, x_t.dtype, rank, n)
    a = -torch.exp(p["a_log"])
    h, y = _mamba_step(state["ssm"], (xc, dt, b_ssm, c_ssm), a,
                       p["d_skip"])
    y = (y * F.silu(z.float())).to(x_t.dtype)
    return ops.linear(y, p["w_out"]), {"conv": window[:, 1:], "ssm": h}


# ===========================================================================
# RWKV-6 "Finch" (data-dependent decay)
# ===========================================================================

def rwkv_specs(cfg) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    dh = cfg.rwkv_head_dim
    h = d // dh
    dt = cfg.pdtype
    f32 = torch.float32
    lora = 64 if d >= 1024 else 16
    small = lambda *shape, axes: ParamSpec(shape, f32, axes, init="small")
    return {
        # time-mix (attention analogue)
        "mu_r": small(d, axes=("embed",)),
        "mu_k": small(d, axes=("embed",)),
        "mu_v": small(d, axes=("embed",)),
        "mu_w": small(d, axes=("embed",)),
        "mu_g": small(d, axes=("embed",)),
        "w_r": ParamSpec((d, d), dt, ("embed", "heads")),
        "w_k": ParamSpec((d, d), dt, ("embed", "heads")),
        "w_v": ParamSpec((d, d), dt, ("embed", "heads")),
        "w_g": ParamSpec((d, d), dt, ("embed", "heads")),
        "w_o": ParamSpec((d, d), dt, ("heads", "embed")),
        # data-dependent decay lora (the Finch hallmark)
        "decay_w0": ParamSpec((d,), f32, ("embed",), init="zeros"),
        "decay_a": small(d, lora, axes=("embed", None)),
        "decay_b": small(lora, d, axes=(None, "embed")),
        "bonus_u": small(h, dh, axes=("heads", None)),
        "ln_x": ParamSpec((d,), f32, ("embed",), init="ones"),
        # channel-mix (FFN analogue)
        "mu_ck": small(d, axes=("embed",)),
        "mu_cr": small(d, axes=("embed",)),
        "w_ck": ParamSpec((d, f), dt, ("embed", "ffn")),
        "w_cv": ParamSpec((f, d), dt, ("ffn", "embed")),
        "w_cr": ParamSpec((d, d), dt, ("embed", "embed")),
    }


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Token shift: previous timestep (zeros at t=0). x [B, S, d]."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _lerp(x, xs, mu):
    return x + (xs - x) * mu


def _rwkv_step(state: torch.Tensor, xs, u: torch.Tensor):
    """WKV recurrence per head.  state [B, H, dh, dh] (i = key dim, j =
    value dim)."""
    r_t, k_t, v_t, w_t = xs      # [B, H, dh] each
    kv = k_t[..., :, None] * v_t[..., None, :]               # [B,H,dh,dh]
    y = torch.einsum("bhi,bhij->bhj", r_t, u[..., :, None] * kv + state)
    state = w_t[..., :, None] * state + kv
    return state, y


def _rwkv_proj(p, xf: torch.Tensor, xs: torch.Tensor, dtype):
    """The time-mix's r, k, v, g projections and the decay w of the
    token-shifted mix of ``xf`` and ``xs`` (f32)."""
    r, k, v, g = (ops.linear(_lerp(xf, xs, p[f"mu_{c}"]).to(dtype),
                             p[f"w_{c}"]) for c in "rkvg")
    xw = _lerp(xf, xs, p["mu_w"])
    w = torch.exp(-torch.exp(
        p["decay_w0"] + torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]))
    return r, k, v, g, w


def _rwkv_out(p, y: torch.Tensor, g: torch.Tensor, dtype) -> torch.Tensor:
    y = rms_norm(y.to(dtype), p["ln_x"])
    y = (y.float() * F.silu(g.float())).to(dtype)
    return ops.linear(y, p["w_o"])


def rwkv_time_mix(p, x: torch.Tensor, cfg, return_state: bool = False):
    b, s, d = x.shape
    dh = cfg.rwkv_head_dim
    h = d // dh
    xf = x.float()
    r, k, v, g, w = _rwkv_proj(p, xf, _shift(xf), x.dtype)
    to_t = lambda t: t.float().reshape(b, s, h, dh).transpose(0, 1)
    state0 = torch.zeros((b, h, dh, dh), dtype=torch.float32,
                         device=x.device)
    wkv_fin, ys = _scan(lambda c, xx: _rwkv_step(c, xx, p["bonus_u"]),
                        state0, tuple(to_t(t) for t in (r, k, v, w)))
    out = _rwkv_out(p, ys.transpose(0, 1).reshape(b, s, d), g, x.dtype)
    if return_state:
        return out, {"wkv": wkv_fin, "tm_x": xf[:, -1]}
    return out


def _channel_mix(p, xf: torch.Tensor, xs: torch.Tensor, dtype):
    xk = _lerp(xf, xs, p["mu_ck"]).to(dtype)
    xr = _lerp(xf, xs, p["mu_cr"]).to(dtype)
    k = torch.square(F.relu(ops.linear(xk, p["w_ck"]).float())).to(dtype)
    return torch.sigmoid(ops.linear(xr, p["w_cr"]).float()).to(dtype) \
        * ops.linear(k, p["w_cv"])


def rwkv_channel_mix(p, x: torch.Tensor, cfg) -> torch.Tensor:
    xf = x.float()
    return _channel_mix(p, xf, _shift(xf), x.dtype)


def rwkv_init_state(cfg, batch: int, device=None):
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                   device=device)
    return {"wkv": z(batch, d // dh, dh, dh), "tm_x": z(batch, d),
            "cm_x": z(batch, d)}


def rwkv_time_mix_decode(p, x_t: torch.Tensor, state, cfg
                         ) -> Tuple[torch.Tensor, Any]:
    b, d = x_t.shape
    dh = cfg.rwkv_head_dim
    h = d // dh
    xf = x_t.float()
    r, k, v, g, w = _rwkv_proj(p, xf, state["tm_x"], x_t.dtype)
    hd = lambda t: t.float().reshape(b, h, dh)
    new_wkv, y = _rwkv_step(state["wkv"], (hd(r), hd(k), hd(v), hd(w)),
                            p["bonus_u"])
    out = _rwkv_out(p, y.reshape(b, d), g, x_t.dtype)
    return out, {**state, "wkv": new_wkv, "tm_x": xf}


def rwkv_channel_mix_decode(p, x_t: torch.Tensor, state, cfg
                            ) -> Tuple[torch.Tensor, Any]:
    xf = x_t.float()
    return (_channel_mix(p, xf, state["cm_x"], x_t.dtype),
            {**state, "cm_x": xf})
