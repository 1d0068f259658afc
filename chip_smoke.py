#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. **card**: the card's name and power limit (``nvidia-smi``), the torch,
   CUDA and nvcc versions.
2. **build**: every CUDA source under ``src/repro_torch/kernels/csrc`` is
   compiled for ``sm_90a`` (one ``nvcc`` per source, all started together).
3. **kernels**: each hand-written kernel is held against its plain PyTorch
   version on the card, at the shapes the serving path of full-width
   Qwen3-0.6B gives it, within a stated tolerance, and timed with CUDA
   events beside its bound and the nearest single PyTorch call.
4. **serve**: full-width Qwen3-0.6B (random weights from seed 0, pruned and
   packed on the card) serves six requests through ``ContinuousEngine``.
   Every kernel's launch counter is zeroed just before and read just after;
   one decode tick's logits through the kernels are held against the same
   tick through the plain versions.

The lines before the last carry the kernel table (one JSON object) and the
serving numbers; the last line is the device JSON.  ``--out PATH`` also
writes every measurement (per-shape kernel rows, serving, the decode
profile) to a JSON file.  It needs one CUDA card and this repository's
``src/`` beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor cores
SLOTS = 4
PREFILL_CHUNK = 256
N_REQUESTS = 6
NEW_TOKENS = 160
PROMPT_RANGE = (200, 600)
# decode logits, kernels vs plain versions on one state: max |diff| over
# max |plain|.  In bf16 a one-ulp rounding difference anywhere in 28 layers
# moves the logits of a random-weight model by about 2 % of their range;
# widened to f32 the two paths differ only in summation order.
LOGIT_TOL = {"bf16": 5e-2, "f32": 1e-3}
# top-1 agreement across slot-ticks: over all of them in f32; in bf16 over
# those whose plain top-1 margin exceeds TOP1_CLEAR of the row's largest
# |logit| (below the bf16 noise of up to 2 % of the range, so a flip there
# is possible from rounding alone, and above it a kernel fault shows), of
# which there must be at least TOP1_MIN_COUNTED
TOP1_MIN = 0.99
TOP1_CLEAR = 1e-2
TOP1_MIN_COUNTED = 50


def fail(msg: str, code: int = 1) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


CARD = []                       # "name, power limit" once read


def say(msg: str) -> None:
    """One progress line; every line after the card phase carries the
    card's name and power limit."""
    tag = f" [{CARD[0]}]" if CARD else ""
    print(f"[chip_smoke] {msg}{tag}", flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of one call, the L2 flushed before each."""

    def __init__(self, torch, reps: int = 20, warmup: int = 3):
        self.torch = torch
        self.reps, self.warmup = reps, warmup
        # twice the 50 MB L2: weights are cold on the serving path
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        times = []
        for i in range(self.warmup + self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            if i >= self.warmup:
                times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def values_read(bitmap, length: int, cap: int, valid=None) -> int:
    """Packed values a decompressing kernel must read: each block's set
    bits, at most its capacity (the gather clamps there); ``valid`` masks
    the blocks it skips."""
    from repro_torch.core.sparse_format import unpack_bits
    nnz = unpack_bits(bitmap, length).sum(-1).clamp(max=cap)
    if valid is not None:
        nnz = nnz * valid
    return int(nnz.sum())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def card_phase(torch, build) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    CARD.append(card)
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    nvcc_v = (nvcc.stdout.strip().splitlines() or ["?"])[-1]
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc: {nvcc_v}, device {torch.cuda.get_device_name(0)}")
    return card


def build_phase(build) -> float:
    t0 = time.perf_counter()
    logs = build.build_all(extra_flags=("-Xptxas", "-v"))
    dt = time.perf_counter() - t0
    for src, text in logs.items():
        regs = [ln.split("ptxas info    : ")[-1].strip()
                for ln in text.splitlines() if "registers" in ln]
        say(f"build {src}: " + ("; ".join(regs) if regs else "ok"))
    say(f"build: {len(build.SOURCES)} sources in {dt:.1f} s "
        f"({'built' if logs else 'cached'})")
    return dt


def _packed(torch, k, n, gen, sparsity=0.5):
    from repro_torch.core.pruning import make_mask
    from repro_torch.core.sparse_format import (DEFAULT_BLOCK,
                                                balanced_capacity, pack)
    w = (torch.randn((k, n), generator=gen, device="cuda")
         / k ** 0.5).to(torch.bfloat16)
    mask = make_mask(w, sparsity, "balanced", DEFAULT_BLOCK)
    return pack(w, mask, DEFAULT_BLOCK,
                capacity=balanced_capacity(1 - sparsity, DEFAULT_BLOCK))


def _check(name, got, ref, tol, errs):
    """Max abs error against the plain version, held to ``tol``; returns
    it with the relative error (over the largest plain output)."""
    err = (got.float() - ref.float()).abs().max().item()
    if not (err <= tol):        # NaN fails too
        fail(f"{name}: max abs err {err:.3e} > tolerance {tol:.3e}")
    errs.append(err)
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def kernel_phase(torch, cfg):
    import torch.nn.functional as F
    from repro_torch.core.sparse_format import unpack
    from repro_torch.core.sparse_kv import freeze_chunk_blocks, pooled_view
    from repro_torch.kernels.dense_matmul import (dense_matmul,
                                                  dense_matmul_plain)
    from repro_torch.kernels.sparse_attention import (
        sparse_decode_attention_fused, sparse_decode_attention_fused_plain)
    from repro_torch.kernels.sparse_gemv import sparse_gemv, \
        sparse_gemv_plain
    from repro_torch.kernels.sparse_matmul import sparse_matmul, \
        sparse_matmul_plain
    from repro_torch.models import lm

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    detail = []

    # the seven linears of one layer, from the model's own specs
    blk = lm.model_specs(cfg)["blocks"]["l0"]
    linears = [(k, s.shape[-2], s.shape[-1])
               for part in ("mixer", "ffn") for k, s in blk[part].items()
               if len(s.shape) == 3]
    shapes = sorted({(k, n) for _, k, n in linears})
    weights = {kn: _packed(torch, *kn, gen) for kn in shapes}
    dense_w = {kn: unpack(sw) for kn, sw in weights.items()}

    def sparse_costs(x_rows, kn, sw):
        k, n = kn
        nnz = values_read(sw.bitmap, sw.block[0] * sw.block[1],
                          sw.values.shape[-1])
        scale = 0 if sw.scale is None else \
            sw.scale.numel() * sw.scale.element_size()
        n_bytes = (x_rows * k * 2 + sw.bitmap.numel() * 4
                   + nnz * sw.values.element_size() + scale + x_rows * n * 2)
        return n_bytes, 2.0 * x_rows * nnz

    def linear_rows(name, fn, plain, m_list, per_layer_m):
        errs, layer = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                           "bound_ms": 0.0, "bytes": 0.0, "ops": 0.0}
        for m in m_list:
            for kn in shapes:
                sw, wd = weights[kn], dense_w[kn]
                x = torch.randn((m, kn[0]), generator=gen,
                                device="cuda").to(torch.bfloat16)
                got, ref = fn(x, sw), plain(x, sw)
                torch.cuda.synchronize()
                # both accumulate in f32 and round once to bf16: two bf16
                # ulps of the largest output
                tol = 2.0 ** -7 * ref.float().abs().max().item()
                err, rel = _check(f"{name} M={m} K,N={kn}", got, ref, tol,
                                  errs)
                t = timer(lambda: fn(x, sw))
                tp = timer(lambda: plain(x, sw))
                tl = timer(lambda: torch.matmul(x, wd))
                nb, no = sparse_costs(m, kn, sw)
                b, by = bound_ms(nb, no)
                row = {"kernel": name, "M": m, "K": kn[0], "N": kn[1],
                       "max_abs_err": err, "tol": tol, "ms": t,
                       "plain_ms": tp, "library_ms": tl, "bound_ms": b,
                       "bound_by": by}
                detail.append(row)
                say(f"{name} M={m} K={kn[0]} N={kn[1]}: err {err:.2e} "
                    f"(rel {rel:.1e}, tol {tol:.2e}) kernel {t * 1e3:.1f} us, plain "
                    f"{tp * 1e3:.1f} us, torch.matmul {tl * 1e3:.1f} us, "
                    f"bound {b * 1e3:.2f} us")
                if m == per_layer_m:
                    count = sum(1 for _, k, n in linears if (k, n) == kn)
                    for key, val in (("ms", t), ("plain_ms", tp),
                                     ("library_ms", tl), ("bytes", nb),
                                     ("ops", no)):
                        layer[key] += count * val
        layer["bound_ms"], layer["bound_by"] = bound_ms(layer["bytes"],
                                                        layer["ops"])
        layer["max_abs_err"] = max(errs)
        return layer

    gemv = linear_rows("sparse_gemv", sparse_gemv, sparse_gemv_plain,
                       (1, 4, 8), SLOTS)
    matmul = linear_rows("sparse_matmul", sparse_matmul, sparse_matmul_plain,
                         (PREFILL_CHUNK,), PREFILL_CHUNK)

    # -- fused decode attention at the pool's serving geometry ------------
    hkv, hd, g = cfg.n_kv, cfg.hd, cfg.padded_heads // cfg.n_kv
    bs, sb, tp = 128, 7, cfg.kv_tail
    b = SLOTS
    kv = torch.randn((2, b, hkv, sb * bs, hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    from repro_torch.serving.cache_pool import CachePool
    pool = CachePool.build(cfg, SLOTS, sb * bs, bs=bs, device="cuda")
    kbm, kvl, vbm, vvl = freeze_chunk_blocks(
        kv[0], kv[1], cfg.kv_k_sparsity, cfg.kv_v_sparsity, bs, pool.cap_k,
        pool.cap_v)
    tails = torch.randn((2, b, hkv, tp, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
    # empty prefix + 1 tail token; 3 blocks + full ring; full prefix + empty
    # ring; an all-empty slot
    n_blocks = torch.tensor([0, 3, sb, 0], dtype=torch.int32, device="cuda")
    tail_len = torch.tensor([1, tp, 0, 0], dtype=torch.int32, device="cuda")
    sm = 1.0 / hd ** 0.5
    errs = []
    vmax = max(kv[1].float().abs().max().item(),
               tails[1].float().abs().max().item())
    for qn in (1, 2):            # the decode tick and a 2-query panel
        q = torch.randn((b, hkv, qn * g, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        args = (q, kbm, kvl, vbm, vvl, tails[0], tails[1], bs, sm,
                n_blocks, tail_len, g)
        got = sparse_decode_attention_fused(*args)
        ref = sparse_decode_attention_fused_plain(*args)
        torch.cuda.synchronize()
        # f32 scores, weights and sums on both sides, in another order
        tol = 1e-3 * vmax
        err, rel = _check(f"attention Q={qn}", got, ref, tol, errs)
        # panel query 0 of the all-empty slot sees nothing (query j sees j
        # tail tokens more)
        if (ref[3, :, :g].abs().max().item() != 0
                or got[3, :, :g].abs().max().item() != 0):
            fail("attention: the all-empty slot must return zeros")
        say(f"attention Q={qn}: err {err:.2e} (rel {rel:.1e}, tol "
            f"{tol:.2e})")
    q = torch.randn((b, hkv, g, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    args = (q, kbm, kvl, vbm, vvl, tails[0], tails[1], bs, sm, n_blocks,
            tail_len, g)
    t = timer(lambda: sparse_decode_attention_fused(*args))
    t_plain = timer(lambda: sparse_decode_attention_fused_plain(*args))
    # SDPA on the unpacked cache (prefix + ring) with a validity mask
    k_all = torch.cat([unpack(pooled_view(kbm, kvl, bs, hd)), tails[0]], 2)
    v_all = torch.cat([unpack(pooled_view(vbm, vvl, bs, hd)), tails[1]], 2)
    pos = torch.arange(sb * bs + tp, device="cuda")
    valid = ((pos[None] < n_blocks[:, None] * bs)
             | ((pos[None] >= sb * bs)
                & (pos[None] - sb * bs < tail_len[:, None])))
    qs = q.reshape(b, hkv * g, 1, hd)
    kr = k_all.repeat_interleave(g, 1)
    vr = v_all.repeat_interleave(g, 1)
    mask = valid[:, None, None, :]
    t_lib = timer(lambda: F.scaled_dot_product_attention(
        qs, kr, vr, attn_mask=mask, scale=sm))
    # bytes the function needs: q, the lengths, the f32 output, the valid
    # prefix blocks' bitmap words and set values, the visible tail tokens
    words = kbm.shape[-1]
    valid = (torch.arange(sb, device="cuda")[None]
             < n_blocks[:, None])[:, None, :]
    nnz = (values_read(kbm, bs * hd, pool.cap_k, valid)
           + values_read(vbm, bs * hd, pool.cap_v, valid))
    tok = (n_blocks * bs + tail_len).sum().item()
    n_bytes = (q.numel() * 2 + 8 * b + q.numel() * 4
               + hkv * int(n_blocks.sum()) * 2 * words * 4
               + nnz * kvl.element_size()
               + hkv * int(tail_len.sum()) * hd * 2 * 2)
    n_ops = 4.0 * hd * g * hkv * tok
    bnd, bby = bound_ms(n_bytes, n_ops)
    attn = {"ms": t, "plain_ms": t_plain, "library_ms": t_lib,
            "bound_ms": bnd, "bound_by": bby, "max_abs_err": max(errs)}
    detail.append({"kernel": "sparse_decode_attention_fused", "B": b,
                   "Hkv": hkv, "QG": g, "Sb": sb, "bs": bs, "tail": tp,
                   "n_blocks": n_blocks.tolist(),
                   "tail_len": tail_len.tolist(), **attn})
    say(f"attention B={b}: kernel {t * 1e3:.1f} us, plain "
        f"{t_plain * 1e3:.1f} us, SDPA {t_lib * 1e3:.1f} us, bound "
        f"{bnd * 1e3:.2f} us")

    # -- tied unembedding --------------------------------------------------
    tok_w = (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                         device="cuda") * 0.02).to(torch.bfloat16)
    errs = []
    dense = {}
    for m in (1, SLOTS):
        x = torch.randn((m, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        got = dense_matmul(x, tok_w, torch.float32)
        ref = dense_matmul_plain(x, tok_w, torch.float32)
        torch.cuda.synchronize()
        # same f32 products, summed in another order
        tol = 1e-4 * ref.abs().max().item()
        err, rel = _check(f"dense_matmul M={m}", got, ref, tol, errs)
        t = timer(lambda: dense_matmul(x, tok_w, torch.float32))
        t_plain = timer(lambda: dense_matmul_plain(x, tok_w, torch.float32))
        t_lib = timer(lambda: torch.matmul(x, tok_w.t()))
        n_bytes = tok_w.numel() * 2 + x.numel() * 2 + m * cfg.vocab * 4
        bnd, bby = bound_ms(n_bytes, 2.0 * m * tok_w.numel())
        row = {"kernel": "dense_matmul", "M": m, "K": cfg.d_model,
               "N": cfg.vocab, "max_abs_err": err, "tol": tol, "ms": t,
               "plain_ms": t_plain, "library_ms": t_lib, "bound_ms": bnd,
               "bound_by": bby}
        detail.append(row)
        if m == SLOTS:
            dense = dict(row)
        say(f"dense_matmul M={m}: err {err:.2e} (rel {rel:.1e}, tol "
            f"{tol:.2e}) kernel "
            f"{t * 1e3:.1f} us, plain {t_plain * 1e3:.1f} us, torch.matmul "
            f"{t_lib * 1e3:.1f} us, bound {bnd * 1e3:.2f} us")
    dense["max_abs_err"] = max(errs)
    return {"sparse_gemv": gemv, "sparse_matmul": matmul,
            "sparse_decode_attention_fused": attn,
            "dense_matmul": dense}, detail


@contextlib.contextmanager
def plain_kernels():
    """Route the ops layer through the plain versions, for the logits
    comparison only (the package itself has no such switch)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dense_matmul import dense_matmul_plain
    from repro_torch.kernels.sparse_attention import \
        sparse_decode_attention_fused_plain
    from repro_torch.kernels.sparse_gemv import sparse_gemv_plain
    from repro_torch.kernels.sparse_matmul import sparse_matmul_plain
    swap = {"_dense_kernel": dense_matmul_plain,
            "sparse_decode_attention_fused":
                sparse_decode_attention_fused_plain,
            "sparse_gemv": sparse_gemv_plain,
            "_sparse_matmul_kernel": sparse_matmul_plain}
    saved = {k: getattr(ops, k) for k in swap}
    for k, v in swap.items():
        setattr(ops, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ops, k, v)


def _clone(tree, dtype=None):
    """Copy a state or params tree; ``dtype`` widens the floating leaves
    (sparse weights keep their packed bf16 values and bitmaps)."""
    from repro_torch.core.sparse_format import BlockSparseWeight
    if isinstance(tree, dict):
        return {k: _clone(v, dtype) for k, v in tree.items()}
    if isinstance(tree, BlockSparseWeight):
        return tree
    if dtype is not None and tree.is_floating_point():
        return tree.to(dtype)
    return tree.clone()


def logits_check(torch, eng, cfg, dtype=None, n_ticks=25):
    """Teacher-forced decode ticks from the engine's live state, once
    through the kernels and once through the plain versions, in the
    serving dtype or (``dtype=torch.float32``) widened to f32."""
    import dataclasses
    from repro_torch.models import lm
    slots, mask, tokens = _decode_inputs(torch, eng)
    params = eng.params
    if dtype is not None:
        name = str(dtype).split(".")[-1]
        cfg = dataclasses.replace(cfg, compute_dtype=name, param_dtype=name)
        params = _clone(params, dtype)
    st_k, st_p = _clone(eng.state, dtype), _clone(eng.state, dtype)
    worst, agree, margins = 0.0, [], []
    for _ in range(n_ticks):
        lk, st_k = lm.forward_panel_pooled(params, st_k, tokens, mask, cfg,
                                           eng.pool.bs)
        with plain_kernels():
            lp, st_p = lm.forward_panel_pooled(params, st_p, tokens, mask,
                                               cfg, eng.pool.bs)
        lk, lp = lk[slots, 0].float(), lp[slots, 0].float()
        if not torch.isfinite(lk).all():
            fail("decode logits through the kernels are not finite")
        worst = max(worst, ((lk - lp).abs().max()
                            / lp.abs().max()).item())
        agree += (lk.argmax(-1) == lp.argmax(-1)).tolist()
        top2 = lp.topk(2, -1).values
        margins += ((top2[:, 0] - top2[:, 1])
                    / lp.abs().max(-1).values).tolist()
        tokens[slots, 0] = lp.argmax(-1)
    clear = [a for a, m in zip(agree, margins) if m > TOP1_CLEAR]
    return {"rel_err": worst, "top1": sum(agree) / len(agree),
            "slot_ticks": len(agree),
            "top1_clear": sum(clear) / max(len(clear), 1),
            "clear_slot_ticks": len(clear),
            "top1_margin_min": min(margins),
            "flip_margins": sorted(m for a, m in zip(agree, margins)
                                   if not a)}


def _decode_inputs(torch, eng):
    slots = eng.scheduler.decoding_slots()
    b = eng.pool.slots
    mask = torch.zeros(b, dtype=torch.bool, device="cuda")
    mask[slots] = True
    tokens = torch.zeros((b, 1), dtype=torch.long, device="cuda")
    for s in slots:
        tokens[s, 0] = eng._last_tok[s]
    return slots, mask, tokens


def decode_profile(torch, eng, cfg, n_ticks=8):
    """Wall time per decode tick through the kernels (forward, sampler and
    the token sync, from a copy of the live state), and the device time of
    the same ticks from a ``torch.profiler`` trace: the device's busy and
    idle shares."""
    from repro_torch.models import lm
    from repro_torch.serving import sampling
    slots, mask, tokens = _decode_inputs(torch, eng)
    live = mask.tolist()
    st = _clone(eng.state)

    def tick():
        logits, _ = lm.forward_panel_pooled(eng.params, st, tokens, mask, cfg,
                                            eng.pool.bs)
        tok, _ = sampling.sample_step(logits[:, 0], eng.lanes,
                                      [None] * len(live), live)
        tok.tolist()

    tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        tick()
    wall = (time.perf_counter() - t0) / n_ticks
    res = {"ticks": n_ticks, "slots": len(slots), "wall_ms": wall * 1e3}
    # the profiler is a measurement, not a check: its own failures are
    # reported; a failing tick fails the run
    try:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:
        res["device"] = f"not measured: {type(e).__name__}: {e}"
        return res
    for _ in range(n_ticks):
        tick()
    torch.cuda.synchronize()
    try:
        prof.stop()
        rows = [(e.key, e.self_device_time_total / n_ticks / 1e3,
                 e.count // n_ticks)
                for e in prof.key_averages()
                if "CUDA" in str(e.device_type)
                and e.self_device_time_total > 0]
    except Exception as e:
        res["device"] = f"not measured: {type(e).__name__}: {e}"
        return res
    if not rows:
        res["device"] = "not measured: the trace holds no device time"
        return res
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    res.update(device_ms=busy, idle_share=max(0.0, 1 - busy / res["wall_ms"]),
               top=[{"kernel": k[:80], "ms_per_tick": t, "per_tick": c}
                    for k, t, c in rows[:8]])
    return res


def serve_phase(torch, cfg):
    import numpy as np
    from repro_torch.core.convert import convert_concrete
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.launch.serve import launch_counts, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.serving import ContinuousEngine, SamplingParams

    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    params = convert_concrete(params, lm.model_specs(cfg), cfg,
                              device="cuda")
    torch.cuda.synchronize()
    say(f"serve: qwen3-0.6b full width ({cfg.n_layers} layers) initialised "
        f"and packed on the card in {time.perf_counter() - t0:.1f} s")
    lo, hi = PROMPT_RANGE
    paused = [0.0]            # the checks below stop the engine's clock
    eng = ContinuousEngine(params, cfg, slots=SLOTS,
                           max_tokens=hi + NEW_TOKENS + cfg.kv_tail,
                           prefill_chunk=PREFILL_CHUNK, device="cuda",
                           clock=lambda: time.perf_counter() - paused[0])
    if eng.pool.bs != 128:
        fail(f"expected bs=128, got {eng.pool.bs}")
    prompts = host_batch(DataConfig(vocab=cfg.vocab, seq_len=hi,
                                    global_batch=N_REQUESTS), 0)["tokens"]
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, N_REQUESTS)
    params_of = [SamplingParams(max_new_tokens=NEW_TOKENS)] * (N_REQUESTS - 1)
    params_of.append(SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                    seed=1234, max_new_tokens=NEW_TOKENS))

    # count the forwards the engine makes, to state launches per tick
    ticks = {"decode": 0, "prefill": 0}
    fwd_panel, fwd_chunk = lm.forward_panel_pooled, lm.forward_prefill_chunk

    def panel(*a, **k):
        ticks["decode"] += 1
        return fwd_panel(*a, **k)

    def chunk(*a, **k):
        ticks["prefill"] += 1
        return fwd_chunk(*a, **k)

    rids = [eng.submit(prompts[i][:lens[i]], params_of[i])
            for i in range(N_REQUESTS)]
    check = profile = None
    steps = {"decode": [], "prefill": []}
    lm.forward_panel_pooled, lm.forward_prefill_chunk = panel, chunk
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        while not eng.scheduler.done():
            sch = eng.scheduler
            slots = sch.decoding_slots()
            if (check is None and len(slots) == SLOTS
                    and max(len(sch.active[s].generated) for s in slots)
                    >= eng.pool.tail + 12):
                # one slot has crossed a refreeze: compare the tick's
                # logits (outside the counted, timed main path)
                eng._refreeze_tick()
                c0 = time.perf_counter()
                saved = launch_counts()
                lm.forward_panel_pooled = fwd_panel
                check = {"bf16": logits_check(torch, eng, cfg),
                         "f32": logits_check(torch, eng, cfg,
                                             torch.float32)}
                profile = decode_profile(torch, eng, cfg)
                lm.forward_panel_pooled = panel
                from repro_torch.launch import serve as serve_mod
                for name, n in saved.items():
                    serve_mod.KERNELS[name].launches = n
                paused[0] += time.perf_counter() - c0
            n_pre = ticks["prefill"]
            s0 = time.perf_counter()
            eng.step()
            steps["prefill" if ticks["prefill"] > n_pre else "decode"].append(
                time.perf_counter() - s0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0 - paused[0]
        counts = launch_counts()
    finally:
        lm.forward_panel_pooled, lm.forward_prefill_chunk = fwd_panel, \
            fwd_chunk
    out = {r: eng.scheduler.finished[r].output() for r in rids}
    for name, n in counts.items():
        if n <= 0:
            fail(f"serve: kernel {name} was never launched on the main path")
    total = 0
    for r in rids:
        toks = out[r].token_ids
        if len(toks) != NEW_TOKENS or out[r].finish_reason != "length":
            fail(f"serve: request {r} finished {out[r].finish_reason!r} with "
                 f"{len(toks)} tokens")
        if min(toks) < 0 or max(toks) >= cfg.vocab:
            fail(f"serve: request {r} has a token out of range")
        total += len(toks)
    if check is None:
        fail("serve: the logits comparison never ran")
    for name, c in check.items():
        say(f"serve: decode logits kernels vs plain ({name}) over "
            f"{c['slot_ticks']} slot-ticks: max|diff|/max|plain| "
            f"{c['rel_err']:.2e} (tol {LOGIT_TOL[name]}), top-1 agreement "
            f"{c['top1']:.3f}; {c['top1_clear']:.3f} over the "
            f"{c['clear_slot_ticks']} with a top-1 margin above "
            f"{TOP1_CLEAR} of max|logit| (min {TOP1_MIN}); smallest margin "
            f"{c['top1_margin_min']:.2e}, margins of the flips "
            f"{[float(f'{m:.2e}') for m in c['flip_margins']]}")
        if not (c["rel_err"] <= LOGIT_TOL[name]):
            fail(f"serve: {name} decode logits through the kernels disagree "
                 "with the plain versions")
        if c["clear_slot_ticks"] < TOP1_MIN_COUNTED:
            fail(f"serve: {name}: only {c['clear_slot_ticks']} slot-ticks "
                 f"with a top-1 margin above {TOP1_CLEAR}")
        if c["top1_clear"] < TOP1_MIN:
            fail(f"serve: {name} top-1 agreement below {TOP1_MIN} where the "
                 "margin is clear of rounding noise")
    if check["f32"]["top1"] < TOP1_MIN:
        fail(f"serve: f32 top-1 agreement below {TOP1_MIN}")
    ttft = sorted(o.metrics.ttft for o in out.values())
    tpot = sorted(o.metrics.tpot for o in out.values())
    step_ms = {k: statistics.median(v) * 1e3 for k, v in steps.items() if v}
    res = {"requests": N_REQUESTS, "tokens": total, "seconds": dt,
           "tok_s": total / dt, "ttft_p50_s": statistics.median(ttft),
           "ttft_max_s": ttft[-1], "tpot_p50_s": statistics.median(tpot),
           "decode_ticks": ticks["decode"],
           "prefill_chunks": ticks["prefill"], "launches": counts,
           "median_step_ms": step_ms, "decode_profile": profile,
           "prompt_lens": [int(x) for x in lens], "logits_check": check}
    say(f"[serve] stream: {N_REQUESTS} requests, {total} tokens in "
        f"{dt:.2f}s ({total / dt:.1f} tok/s) on {SLOTS} slots; ttft p50 "
        f"{res['ttft_p50_s'] * 1e3:.0f} ms max {ttft[-1] * 1e3:.0f} ms; "
        f"{ticks['decode']} decode ticks, {ticks['prefill']} prefill chunks")
    say(f"serve: kernel launches {counts}; median step ms {step_ms}")
    dev = profile.get("device")
    say(f"serve: decode tick ({profile['slots']} slots) wall "
        f"{profile['wall_ms']:.2f} ms, " + (dev if dev else
        f"device busy {profile['device_ms']:.2f} ms (idle share "
        f"{profile['idle_share']:.2f}); top: " + ", ".join(
            f"{r['kernel'][:40]} {r['ms_per_tick']:.2f} ms x{r['per_tick']}"
            for r in profile["top"][:4])))
    return res


SOURCES = {
    "sparse_gemv": ("src/repro_torch/kernels/csrc/sparse_gemv.cu",
                    "src/repro/kernels/sparse_gemv.py:47"),
    "sparse_decode_attention_fused": (
        "src/repro_torch/kernels/csrc/sparse_attention.cu",
        "src/repro/kernels/sparse_attention.py:236"),
    "sparse_matmul": ("src/repro_torch/kernels/csrc/sparse_matmul.cu",
                      "src/repro/kernels/sparse_matmul.py:46"),
    "dense_matmul": ("src/repro_torch/kernels/csrc/dense_matmul.cu",
                     "src/repro/kernels/dense_matmul.py:40"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository", code=2)
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card", code=2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    card = card_phase(torch, build)
    t_build = build_phase(build)
    cfg = get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    summary, detail = kernel_phase(torch, cfg)
    say(f"kernels: all four agree with their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    serve = serve_phase(torch, cfg)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": serve["launches"][name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"card": card, "build_s": t_build, "kernels": kernels,
             "detail": detail, "serve": serve}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
