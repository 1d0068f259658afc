#!/usr/bin/env python3
"""Flat bf16, spec k=4 and paged int8 serving of two checkouts on one card,
and the cost of RMSNorm's f64 sum of squares; or, with ``--attention`` or
``--linears`` or ``--dense``, the two checkouts' kernels alone at the same
shapes.

    python3 tools/compare_trees.py PARENT_DIR [CHANGE_DIR] [--out PATH]
    python3 tools/compare_trees.py PARENT_DIR --attention [--out PATH]
    python3 tools/compare_trees.py PARENT_DIR --linears [--out PATH]
    python3 tools/compare_trees.py PARENT_DIR --dense K,N [--out PATH]

1. **trees**: for each checkout, in the order parent, change, change,
   parent, a subprocess in that checkout imports its own ``chip_smoke.py``
   (for its traffic, its model set-up and its kernel build) and its own
   ``src/repro_torch``, and serves ``chip_smoke.py``'s flat bf16, spec
   k=4 and paged int8 traffic (greedy, serial) through that checkout's
   ``ContinuousEngine`` as a user builds it, with no gate, check or
   profile between the ticks; per run: the engine's build time (captures
   included where the engine makes them when built), tok/s, TTFT p50 and
   max, TPOT p50, the median host time of a decode (or verify) step, of
   one that also refreezes and of one that prefills, their counts, and the
   engine's graph captures.  ``CHANGE_DIR`` defaults to the checkout
   holding this script.
2. **rms_norm**, in the change's package: how many rows of the f32 mean of
   squares (the reference's form) and of the f64 sum (the port's) differ
   between a call on 4 rows and a call on more rows that hold them, and the
   time per call of both forms at the decode tick's shapes (host clock
   around 2,000 calls ending in a synchronise: what a host-paced tick pays).

With ``--attention`` each run instead builds its checkout's
``sparse_attention.cu`` alone and times its flat and paged fused attention
(``sparse_decode_attention_fused``, ``..._paged``) on the same seeded bf16
inputs: the serving decode geometry (4 slots, 8 kv heads, 7 prefix blocks
of 128 tokens, a 128-token ring; the lengths and the paged table of
``chip_smoke.py``'s kernel phase) at panels of 1, the verify panel and 9
queries, and a 32-block (4096-token) prefix in every slot at 1 query;
and its prefix-only partial (``sparse_decode_attention_partial``) on the
same flat prefix at G and 34 rows (``n_blocks`` 0, 3, 7, 1: the kernel
phase's) and at 32 blocks in every slot.  Each shape gives the CUDA-event
time (L2 flushed) and the traced device time per call, or the error with
which the checkout refused it, in step 1's order (parent, change, change,
parent); step 2 is skipped.

With ``--linears`` each run instead builds its checkout's
``sparse_gemv.cu`` and ``dense_matmul.cu`` alone and times the sparse
gemv over the seven Qwen3-0.6B linears of a layer at M = 4 (bf16, seeded
random weights at 50% sparsity, as ``chip_smoke.py`` packs them) and the
tied unembedding (151936 x 1024 bf16) at M = 4 and 20, on the same seeded
inputs: the CUDA-event time (L2 flushed) and the traced device time per
call (a layer's sum for the gemv) and the largest error against the plain
version, in step 1's order; step 2 is skipped.

With ``--dense K,N`` each run instead builds its checkout's
``dense_matmul.cu`` alone and times its bf16 dense product against a
seeded random ``[N, K]`` bf16 table (rows, as the engine lays out an
untied head) at M = 1, 4, 20 and 64, on the same seeded inputs: the
CUDA-event time (L2 flushed), the traced device time per call, the
largest error against the plain version and the f64 sum of the f32
output (equal sums across checkouts: the same bits, barring a
coincidence), in step 1's order; step 2 is skipped.

It needs one CUDA card and exits non-zero without one.  The parent's
checkout lives in a git-ignored directory of this repository, made with
``git archive``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
NORMS_PER_TICK = 113          # 28 layers x (2 block + q + k norms) + final

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, "."); sys.path.insert(0, "src")
import numpy as np
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.kernels import build
from repro_torch.serving import ContinuousEngine, SamplingParams, SpecConfig
cs.card_phase(torch, build)
cs.build_phase(build)
cfg = get_config("qwen3-0.6b")


def stream(params, prompts, new_tokens, max_tokens, lead=False, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ContinuousEngine(params, cfg, slots=cs.SLOTS, max_tokens=max_tokens,
                           prefill_chunk=cs.PREFILL_CHUNK, device="cuda", **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    did = set()
    prefill_tick, refreeze_tick = eng._prefill_tick, eng._refreeze_tick

    def noted_prefill(*a):
        if eng.scheduler.next_prefill() is not None:
            did.add("prefill")
        return prefill_tick(*a)

    def noted_refreeze(*a):
        if any(t >= eng.pool.tail for t in eng._tail_len):
            did.add("refreeze")
        return refreeze_tick(*a)
    eng._prefill_tick, eng._refreeze_tick = noted_prefill, noted_refreeze
    sp = SamplingParams(max_new_tokens=new_tokens)
    steps = {"decode": [], "refreeze": [], "prefill": []}
    sch = eng.scheduler
    t0 = time.perf_counter()
    pending = list(prompts)
    rids = [eng.submit(pending.pop(0), sp)] if lead else []
    while pending or not sch.done():
        if pending and not (lead and not sch.finished and not any(
                r.generated for r in sch.active.values())):
            rids += [eng.submit(p, sp) for p in pending]
            pending = []
        did.clear()
        s0 = time.perf_counter()
        eng.step()
        kind = ("prefill" if "prefill" in did else
                "refreeze" if "refreeze" in did else "decode")
        steps[kind].append(time.perf_counter() - s0)
    eng.quiesce()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = [sch.finished[r].output() for r in rids]
    ttft = sorted(o.metrics.ttft for o in out)
    total = sum(len(o.token_ids) for o in out)
    return {"build_s": build_s, "tok_s": total / dt,
            "ttft_p50_s": statistics.median(ttft), "ttft_max_s": ttft[-1],
            "tpot_p50_ms": statistics.median(o.metrics.tpot for o in out)
            * 1e3,
            **{f"{k}_step_ms": statistics.median(v) * 1e3 if v else None
               for k, v in steps.items()},
            **{f"{k}_steps": len(v) for k, v in steps.items()},
            "captures": eng.trace_counts()}


out = {}
params = cs._model(torch, cfg, "bf16")
lo, hi = cs.PROMPT_RANGE
toks = host_batch(DataConfig(vocab=cfg.vocab, seq_len=hi,
                             global_batch=cs.N_REQUESTS), 0)["tokens"]
lens = np.random.default_rng(0).integers(lo, hi + 1, cs.N_REQUESTS)
out["bf16"] = stream(params, [toks[i][:lens[i]] for i in range(len(lens))],
                     cs.NEW_TOKENS, hi + cs.NEW_TOKENS + cfg.kv_tail)
out["spec"] = stream(params, cs._spec_prompts(cfg), cs.SPEC_TOKENS,
                     cs.MOTIF * cs.MOTIF_REPEATS + cs.SPEC_TOKENS
                     + cfg.kv_tail, spec=SpecConfig(k=cs.SPEC_K))
del params
params = cs._model(torch, cfg, "int8")
out["int8"] = stream(params, cs._shared_prompts(cfg, cs.PAGED_REQUESTS),
                     cs.PAGED_NEW_TOKENS,
                     cs.SHARED_PREFIX + cs.SUFFIX_RANGE[1]
                     + cs.PAGED_NEW_TOKENS + cfg.kv_tail, lead=True,
                     paged=True)
print("RESULT " + json.dumps(out), flush=True)
"""

ATTENTION_CHILD = r"""
import json, sys
sys.path.insert(0, "."); sys.path.insert(0, "src")
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.core.sparse_kv import freeze_chunk_blocks
from repro_torch.kernels import build
from repro_torch.kernels.sparse_attention import (
    sparse_decode_attention_fused, sparse_decode_attention_fused_paged,
    sparse_decode_attention_partial)
from repro_torch.serving.cache_pool import CachePool
cs.card_phase(torch, build)
build.build_all(["sparse_attention.cu"])
cfg = get_config("qwen3-0.6b")
hkv, hd, tp, bs, b = cfg.n_kv, cfg.hd, cfg.kv_tail, 128, 4
g = cfg.padded_heads // cfg.n_kv
sm = hd ** -0.5
pool = CachePool.build(cfg, b, 32 * bs, bs=bs, device="cuda")
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
timer = cs.Timer(torch)


def randn(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def cache(lead, n):
    kv = randn(2, *lead, n * bs, hd)
    return freeze_chunk_blocks(kv[0], kv[1], cfg.kv_k_sparsity,
                               cfg.kv_v_sparsity, bs, pool.cap_k, pool.cap_v)


def ints(v):
    return torch.tensor(v, dtype=torch.int32, device="cuda")


tails = randn(2, b, hkv, tp, hd)
flat7 = cache((b, hkv), 7)
arena7 = [a[:, :, 0] for a in cache((16, hkv), 1)]
table7 = ints([[0, 1, 2, 3, 4, 5, 6], [0, 1, 2, 7, 8, 15, 15],
               [9, 10, 15, 15, 15, 15, 15], [15] * 7])
flat32 = cache((b, hkv), 32)
arena32 = [a[:, :, 0] for a in cache((b * 32, hkv), 1)]
table32 = torch.randperm(b * 32, generator=gen, device="cuda").to(
    torch.int32).reshape(b, 32)
cases = []
for qn in (1, cs.SPEC_K + 1, 9):
    cases.append((f"flat QG={qn * g} Sb=7", qn, sparse_decode_attention_fused,
                  (*flat7,), ints([0, 3, 7, 0]), ints([1, tp, 0, 0])))
for qn in (1, cs.PAGED_SPEC_K + 1, 9):
    cases.append((f"paged QG={qn * g} Sb=7", qn,
                   sparse_decode_attention_fused_paged, (*arena7, table7),
                   ints([7, 5, 2, 0]), ints([1, tp, 37, 0])))
cases.append((f"flat QG={g} Sb=32", 1, sparse_decode_attention_fused,
               (*flat32,), ints([32] * b), ints([tp // 2] * b)))
cases.append((f"paged QG={g} Sb=32", 1, sparse_decode_attention_fused_paged,
               (*arena32, table32), ints([32] * b), ints([tp // 2] * b)))
out = {}


def measure(name, fn, args):
    try:
        fn(*args)
    except ValueError as e:
        out[name] = {"refused": str(e)}
        return
    torch.cuda.synchronize()
    out[name] = {"ms": timer(lambda: fn(*args)),
                 "device_ms": cs.device_ms_per_call(torch, lambda: fn(*args))}


for name, qn, fn, prefix, n_blocks, tail_len in cases:
    q = randn(b, hkv, qn * g, hd)
    measure(name, fn, (q, *prefix, tails[0], tails[1], bs, sm, n_blocks,
                       tail_len, g))
for qg, sb, prefix, n_blocks in ((g, 7, flat7, ints([0, 3, 7, 1])),
                                 (17 * g, 7, flat7, ints([0, 3, 7, 1])),
                                 (g, 32, flat32, ints([32] * b))):
    measure(f"partial QG={qg} Sb={sb}", sparse_decode_attention_partial,
            (randn(b, hkv, qg, hd), *prefix, bs, sm, n_blocks))
print("RESULT " + json.dumps(out), flush=True)
"""

LINEARS_CHILD = r"""
import json, sys
sys.path.insert(0, "."); sys.path.insert(0, "src")
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.dense_matmul import dense_matmul, dense_matmul_plain
from repro_torch.kernels.sparse_gemv import sparse_gemv, sparse_gemv_plain
cs.card_phase(torch, build)
build.build_all(["sparse_gemv.cu", "dense_matmul.cu"])
cfg = get_config("qwen3-0.6b")
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
timer = cs.Timer(torch)
linears = cs._layer_linears(cfg)
out = {"gemv layer M=4": {"ms": 0.0, "device_ms": 0.0, "max_abs_err": 0.0}}
row = out["gemv layer M=4"]
for _, k, n in linears:
    sw = cs._packed(torch, k, n, gen)
    x = torch.randn((4, k), generator=gen, device="cuda").to(torch.bfloat16)
    err = (sparse_gemv(x, sw).float() - sparse_gemv_plain(x, sw).float())
    row["max_abs_err"] = max(row["max_abs_err"], err.abs().max().item())
    row["ms"] += timer(lambda: sparse_gemv(x, sw))
    row["device_ms"] += cs.device_ms_per_call(torch, lambda: sparse_gemv(x, sw))
tok = (torch.randn((cfg.vocab, cfg.d_model), generator=gen, device="cuda")
       * 0.02).to(torch.bfloat16)
xs = torch.randn((20, cfg.d_model), generator=gen,
                 device="cuda").to(torch.bfloat16)
for m in (4, 20):
    x = xs[:m]
    err = (dense_matmul(x, tok, torch.float32)
           - dense_matmul_plain(x, tok, torch.float32)).abs().max().item()
    out[f"unembed M={m}"] = {
        "ms": timer(lambda: dense_matmul(x, tok, torch.float32)),
        "device_ms": cs.device_ms_per_call(
            torch, lambda: dense_matmul(x, tok, torch.float32)),
        "max_abs_err": err}
print("RESULT " + json.dumps(out), flush=True)
"""


DENSE_CHILD = r"""
import json, sys
sys.path.insert(0, "."); sys.path.insert(0, "src")
import torch
import chip_smoke as cs
from repro_torch.kernels import build
from repro_torch.kernels.dense_matmul import dense_matmul, dense_matmul_plain
cs.card_phase(torch, build)
build.build_all(["dense_matmul.cu"])
K, N = @SHAPE@
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
timer = cs.Timer(torch)
w = (torch.randn((N, K), generator=gen, device="cuda")
     / K ** 0.5).to(torch.bfloat16)
xs = torch.randn((64, K), generator=gen, device="cuda").to(torch.bfloat16)
out = {}
for m in (1, 4, 20, 64):
    x = xs[:m]
    y = dense_matmul(x, w, torch.float32)
    err = (y - dense_matmul_plain(x, w, torch.float32)).abs().max().item()
    out[f"[{K}, {N}] M={m}"] = {
        "ms": timer(lambda: dense_matmul(x, w, torch.float32)),
        "device_ms": cs.device_ms_per_call(
            torch, lambda: dense_matmul(x, w, torch.float32)),
        "max_abs_err": err, "sum": y.double().sum().item()}
print("RESULT " + json.dumps(out), flush=True)
"""


def run_tree(label: str, tree: Path, timeout: float, child: str) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", child], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{label} ({tree}): exit {proc.returncode}")
    res = json.loads(lines[-1][len("RESULT "):])
    print(f"[compare] {label}: {json.dumps(res)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return res


def rms_norm_f32(torch, x, scale, eps=1e-6):
    """The reference's form: the f32 mean of squares."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def _rows_differing(torch, fn, x) -> dict:
    """Rows of ``fn`` over the first ``n`` rows of ``x`` that differ bit for
    bit from ``fn`` over the same rows four at a time."""
    four = torch.cat([fn(x[i:i + 4]) for i in range(0, x.shape[0], 4)])
    out = {}
    for n in (8, 16, 20, 32, 256):
        rows = (fn(x[:n]) != four[:n]).reshape(n, -1).any(-1)
        out[n] = f"{int(rows.sum())}/{n}"
    return out


def rms_norm_costs(torch) -> dict:
    from repro_torch.models.layers import rms_norm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    res = {"rows_differing": {}, "us_per_call": {}}
    forms = {
        "f32 mean": (lambda a, s: rms_norm_f32(torch, a, s),
                     lambda xf: torch.mean(xf * xf, dim=-1)),
        "f64 sum": (rms_norm,
                    lambda xf: torch.mean(xf * xf, dim=-1,
                                          dtype=torch.float64).float())}
    for shape in ((1024,), (16, 128)):
        x = torch.randn((256, *shape), generator=gen,
                        device="cuda").to(torch.bfloat16)
        scale = torch.randn(shape[-1:], generator=gen, device="cuda")
        for name, (norm, var) in forms.items():
            key = f"{name} {list(shape)}"
            res["rows_differing"][f"{key}, mean of squares"] = \
                _rows_differing(torch, lambda a: var(a.float()), x)
            res["rows_differing"][f"{key}, bf16 output"] = \
                _rows_differing(torch, lambda a: norm(a, scale), x)
            x4 = x[:4]
            for _ in range(50):
                norm(x4, scale)
            torch.cuda.synchronize()
            reps = []
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(400):
                    norm(x4, scale)
                torch.cuda.synchronize()
                reps.append((time.perf_counter() - t0) / 400 * 1e6)
            res["us_per_call"][f"{name} [4, {', '.join(map(str, shape))}]"] \
                = statistics.median(reps)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path, nargs="?", default=HERE)
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--attention", action="store_true",
                    help="time the two checkouts' fused attention kernels "
                         "instead of serving")
    ap.add_argument("--linears", action="store_true",
                    help="time the two checkouts' sparse gemv and dense "
                         "unembedding instead of serving")
    ap.add_argument("--dense", default=None, metavar="K,N",
                    help="time the two checkouts' bf16 dense product "
                         "against a [N, K] table instead of serving")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this "
                         "comparison needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[compare] card: {card}", flush=True)
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    child = (ATTENTION_CHILD if args.attention else
             LINEARS_CHILD if args.linears else
             DENSE_CHILD.replace("@SHAPE@", ", ".join(
                 str(int(v)) for v in args.dense.split(",")))
             if args.dense else CHILD)
    runs = [(label, run_tree(label, trees[label], args.timeout, child))
            for label in ("parent", "change", "change", "parent")]
    if args.attention or args.linears or args.dense:
        for key in runs[0][1]:
            print(f"[compare] {'attention ' if args.attention else ''}"
                  f"{key}: " + "; ".join(
                f"{label} {json.dumps(r[key])}" for label, r in runs),
                flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(
                {"card": card, "runs": runs}, indent=1))
        return 0
    summary = {}
    for label in trees:
        for mode in ("bf16", "spec", "int8"):
            vals = [r[mode] for lb, r in runs if lb == label]
            summary[f"{label} {mode}"] = {
                k: [v[k] for v in vals] for k in vals[0]}
    for key, val in summary.items():
        print(f"[compare] {key}: " + "; ".join(
            f"{k} " + ", ".join(x if isinstance(x, str) else
                                json.dumps(x) if isinstance(x, dict)
                                else f"{x:.3f}" for x in v if x is not None)
            for k, v in val.items()), flush=True)
    rms = rms_norm_costs(torch)
    for key, val in rms["rows_differing"].items():
        print(f"[compare] rms_norm {key}: rows differing from the 4-row "
              f"call: {val}", flush=True)
    for key, val in rms["us_per_call"].items():
        print(f"[compare] rms_norm {key}: {val:.2f} us per call, "
              f"{val * NORMS_PER_TICK / 1e3:.3f} ms per tick of "
              f"{NORMS_PER_TICK} norms", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "runs": runs, "summary": summary,
             "rms_norm": rms}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
