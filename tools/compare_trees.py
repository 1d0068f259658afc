#!/usr/bin/env python3
"""Paged int8 and int4 serving of two checkouts on one card, and the cost of
RMSNorm's f64 sum of squares.

    python3 tools/compare_trees.py PARENT_DIR [CHANGE_DIR] [--out PATH]

1. **trees**: for each checkout, in the order parent, change, change,
   parent, a subprocess in that checkout imports its own ``chip_smoke.py``
   and ``src/repro_torch``, builds its kernels and runs its paged int8 and
   paged int4 phases, every gate included; their tok/s, TPOT p50, median
   decode step and traced decode tick are printed per run.  ``CHANGE_DIR``
   defaults to the checkout holding this script.
2. **rms_norm**, in the change's package: how many rows of the f32 mean of
   squares (the reference's form) and of the f64 sum (the port's) differ
   between a call on 4 rows and a call on more rows that hold them, and the
   time per call of both forms at the decode tick's shapes (host clock
   around 2,000 calls ending in a synchronise: what a host-paced tick pays).

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
import json, sys
sys.path.insert(0, "."); sys.path.insert(0, "src")
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.configs import get_config
from repro_torch.kernels import build
cs.card_phase(torch, build)
cs.build_phase(build)
cfg = get_config("qwen3-0.6b")
out = {}
for mode, n_req, new, kernel in (
        ("int8", cs.PAGED_REQUESTS, cs.PAGED_NEW_TOKENS, "sparse_matmul_int8"),
        ("int4", cs.INT4_REQUESTS, cs.INT4_NEW_TOKENS, "sparse_matmul_int4")):
    r = cs.paged_phase(torch, cfg, mode, n_req, new, kernel)[0]
    p = r["decode_profile"]
    out[mode] = {"tok_s": r["tok_s"], "tpot_p50_ms": r["tpot_p50_s"] * 1e3,
                 "decode_step_ms": r["median_step_ms"]["decode"],
                 "traced_tick_wall_ms": p["wall_ms"],
                 "traced_tick_device_ms": p.get("device_ms")}
print("RESULT " + json.dumps(out), flush=True)
"""


def run_tree(label: str, tree: Path, timeout: float) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
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
    runs = [(label, run_tree(label, trees[label], args.timeout))
            for label in ("parent", "change", "change", "parent")]
    summary = {}
    for label in trees:
        for mode in ("int8", "int4"):
            vals = [r[mode] for lb, r in runs if lb == label]
            summary[f"{label} {mode}"] = {
                k: [v[k] for v in vals] for k in vals[0]}
    for key, val in summary.items():
        print(f"[compare] {key}: " + "; ".join(
            f"{k} {', '.join(f'{x:.2f}' for x in v if x is not None)}"
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
