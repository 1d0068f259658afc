#!/usr/bin/env python3
"""Where a block of the split decode attention spends its time, measured on
one card by taking its phases out one at a time.

    python3 tools/attention_probe.py [--rounds 1] [--out PATH]

``csrc/sparse_attention.cu`` runs one thread block per (kv head, slot,
split, row tile): it stages its split, scores its rows, takes the split's
softmax, sums p * V and writes (acc, m, l); the last block of a (slot,
head, row tile) merges the splits.  This script builds the source as it
stands and variants of it, each a substitution of a few lines
(``VARIANTS``), and runs the flat kernel through its own wrapper:

* ``source``: as it stands, held to the plain version (1e-3 of max |V|);
* ``no merge``: the last block resets its ticket and writes nothing;
* ``no scores``, ``no PV``: the scoring, or the p * V sum, is skipped;
* ``staging only``: both skipped (staging, the prefix scan and V's
  expansion, the softmax of whatever the scores buffer holds, the tickets
  and the merge);
* ``no split``: no split does any work; the launch, the tickets and the
  merge of partials nobody wrote.

Every variant but ``source`` computes garbage: only its time is read.  For
bf16 at the serving decode tick (4 slots, 8 kv heads, 7 prefix blocks of
128 tokens with 0, 3, 7 and 0 valid, a 128-token ring holding 1, 128, 0
and 0 tokens) at panels of 1 and 5 queries, and at a 32-block prefix in
every slot, it reports the traced device time per call.  The variants run
in the order A B ... B A for each round.  It needs one CUDA card and exits
non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SOURCE = "sparse_attention.cu"

# (old, new, count): each old text occurs exactly `count` times
NO_MERGE = [("  if (!s_flag[0]) return;\n",
             "  if (!s_flag[0]) return;\n  if (t == 0) *ticket = 0;\n"
             "  if (t >= 0) return;\n", 1)]
NO_SCORES = [("      score_rows<RPT>(", "      if (false) score_rows<RPT>(",
              2)]
NO_PV = [("    pv_rows<RPT>(", "    if (false) pv_rows<RPT>(", 1)]
NO_SPLIT = [("  if (split < a.Sb ? split < nb : split - a.Sb < nt) {",
             "  if (false) {", 1)]
VARIANTS = {"source": [], "no merge": NO_MERGE, "no scores": NO_SCORES,
            "no PV": NO_PV, "staging only": NO_SCORES + NO_PV,
            "no split": NO_SPLIT}


def variant_source(text: str, subs) -> str:
    for old, new, count in subs:
        if text.count(old) != count:
            raise SystemExit(f"the source no longer holds {old!r} {count} "
                             "times: update VARIANTS")
        text = text.replace(old, new)
    return text


def build_variants(build) -> dict:
    """One shared library per variant, all ``nvcc`` runs started together,
    under the git-ignored build directory."""
    csrc = build.CSRC
    text = (csrc / SOURCE).read_text()
    out_dir = build.BUILD_ROOT.parent / "attention_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        src = out_dir / f"variant{i}.cu"
        src.write_text(variant_source(text, subs))
        lib = out_dir / f"variant{i}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc),
               "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def use_variant(build, lib_path: Path) -> None:
    """Route the wrappers' calls of ``SOURCE`` to one variant's library."""
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    build._LIBS[SOURCE] = lib
    for key in [k for k in build._FUNCS if k[0] == SOURCE]:
        del build._FUNCS[key]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of the order A B ... B A")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(HERE), str(HERE / "src")]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this probe "
                         "needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.sparse_attention import (
        sparse_decode_attention_fused, sparse_decode_attention_fused_plain)
    from repro_torch.serving.cache_pool import CachePool

    card = cs.card_phase(torch, build)
    libs = build_variants(build)
    cfg = get_config("qwen3-0.6b")
    hkv, hd, tp = cfg.n_kv, cfg.hd, cfg.kv_tail
    g, bs, b = cfg.padded_heads // cfg.n_kv, 128, cs.SLOTS
    pool = CachePool.build(cfg, b, 32 * bs, bs=bs, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tails = torch.randn((2, b, hkv, tp, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)

    def ints(v):
        return torch.tensor(v, dtype=torch.int32, device="cuda")

    cases = {}
    cache7, vmax = cs._flat_cache(torch, cfg, gen, b, 7, bs, pool)
    for qn in (1, cs.SPEC_K + 1):
        q = torch.randn((b, hkv, qn * g, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        cases[f"QG={qn * g} Sb=7"] = (
            q, *cache7, tails[0], tails[1], bs, hd ** -0.5,
            ints([0, 3, 7, 0]), ints([1, tp, 0, 0]), g)
    cache32, _ = cs._flat_cache(torch, cfg, gen, b, 32, bs, pool)
    q = torch.randn((b, hkv, g, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    cases[f"QG={g} Sb=32"] = (q, *cache32, tails[0], tails[1], bs,
                              hd ** -0.5, ints([32] * b),
                              ints([tp // 2] * b), g)
    names = list(VARIANTS)
    order = (names + names[::-1]) * args.rounds
    runs = []
    for name in order:
        use_variant(build, libs[name])
        res = {}
        for key, case in cases.items():
            got = sparse_decode_attention_fused(*case)
            torch.cuda.synchronize()
            if name == "source":
                ref = sparse_decode_attention_fused_plain(*case)
                err = (got - ref).abs().max().item()
                if not err <= 1e-3 * vmax:
                    raise SystemExit(f"source {key}: max abs err {err:.3e}")
            res[key] = cs.device_ms_per_call(
                torch, lambda: sparse_decode_attention_fused(*case))
            print(f"[probe] {name}: {key}: traced device {res[key]} ms "
                  f"[{card}]", flush=True)
        runs.append((name, res))
    summary = {}
    for name in names:
        for key in cases:
            vals = [r[key] for n, r in runs
                    if n == name and isinstance(r[key], float)]
            if not vals:
                continue
            summary[f"{name}: {key}"] = statistics.median(vals)
            print(f"[probe] median of {len(vals)} runs, {name}: {key}: "
                  f"traced device {summary[f'{name}: {key}'] * 1e3:.1f} us "
                  f"[{card}]", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "runs": runs, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
