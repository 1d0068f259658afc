#!/usr/bin/env python3
"""Overlapped against serial ticks, paired in one call on one card.

    python3 tools/overlap_probe.py [--reps 2] [--out PATH]

Serves full-width Qwen3-0.6B (random weights from seed 0, packed as
``chip_smoke.py`` packs them) through ``ContinuousEngine`` on three of
``chip_smoke.py``'s traffics: the flat bf16 stream (six requests of
216-541 tokens, 160 new, one seeded), the spec traffic at ``k = 4`` (flat
bf16, four motif prompts and two random ones, 128 new) and the paged int8
shared-prefix stream (eight requests, 96 new, one seeded).  Each traffic
runs in the order serial, overlapped, overlapped, serial, ``--reps``
times, every run on a fresh engine whose forward is captured by a short
warm-up request of its own before the timed stream (so no run pays the
capture).  Each run reports tok/s, the median decode (or verify) step,
TPOT p50 and TTFT p50, and its greedy tokens must equal the first serial
run's.  Prints one line per run and one per traffic with the medians of
each mode and their ratio.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def traffics(cs, cfg):
    """(label, weight mode, engine keywords, prompts, params, lead)."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.serving import SamplingParams
    seeded = dict(temperature=0.8, top_k=50, top_p=0.95, seed=1234)
    lo, hi = cs.PROMPT_RANGE
    base = host_batch(DataConfig(vocab=cfg.vocab, seq_len=hi,
                                 global_batch=cs.N_REQUESTS), 0)["tokens"]
    lens = np.random.default_rng(0).integers(lo, hi + 1, cs.N_REQUESTS)
    flat = [base[i][:lens[i]] for i in range(cs.N_REQUESTS)]
    flat_sp = [SamplingParams(max_new_tokens=cs.NEW_TOKENS)] * (
        cs.N_REQUESTS - 1) + [SamplingParams(max_new_tokens=cs.NEW_TOKENS,
                                             **seeded)]
    spec = cs._spec_prompts(cfg)
    spec_sp = [SamplingParams(max_new_tokens=cs.SPEC_TOKENS)] * len(spec)
    paged = cs._shared_prompts(cfg, cs.PAGED_REQUESTS)
    paged_sp = [SamplingParams(max_new_tokens=cs.PAGED_NEW_TOKENS)] * (
        cs.PAGED_REQUESTS - 1) + [SamplingParams(
            max_new_tokens=cs.PAGED_NEW_TOKENS, **seeded)]
    return [
        ("flat bf16", "bf16",
         dict(max_tokens=hi + cs.NEW_TOKENS + cfg.kv_tail), flat, flat_sp,
         False),
        ("spec k=4", "bf16",
         dict(max_tokens=cs.MOTIF * cs.MOTIF_REPEATS + cs.SPEC_TOKENS
              + cfg.kv_tail, spec_k=cs.SPEC_K), spec, spec_sp, False),
        ("paged int8", "int8",
         dict(max_tokens=cs.SHARED_PREFIX + cs.SUFFIX_RANGE[1]
              + cs.PAGED_NEW_TOKENS + cfg.kv_tail, paged=True), paged,
         paged_sp, True),
    ]


def one_run(torch, cs, cfg, params, kw, prompts, params_of, lead, overlap):
    import numpy as np
    from repro_torch.serving import SamplingParams
    paused = [0.0]
    eng = cs._engine(cfg, params, paused, overlap=overlap, **kw)
    warm = np.random.default_rng(9).integers(0, cfg.vocab, 200).tolist()
    eng.submit(warm, SamplingParams(max_new_tokens=4))
    eng.run()
    run = cs.serve_stream(torch, eng, cfg, prompts, params_of, paused,
                          lead=lead, label="overlap probe")
    out = run["out"]
    total = sum(len(o.token_ids) for o in out.values())
    steps = run["steps"]["decode"]
    return {"overlap": overlap, "tok_s": total / run["seconds"],
            "decode_step_ms": statistics.median(steps) * 1e3,
            "tpot_p50_ms": statistics.median(
                o.metrics.tpot for o in out.values()) * 1e3,
            "ttft_p50_s": statistics.median(
                o.metrics.ttft for o in out.values()),
            "ticks": run["ticks"]["decode"],
            "greedy": [list(out[r].token_ids)
                       for r, sp in zip(run["rids"], params_of)
                       if sp.temperature == 0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(HERE / "src"), str(HERE)]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this probe "
                         "needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    card = cs.card_phase(torch, build)
    cs.build_phase(build)
    cfg = get_config("qwen3-0.6b")
    results, models = {}, {}
    for label, mode, kw, prompts, params_of, lead in traffics(cs, cfg):
        if mode not in models:
            models.clear()
            models[mode] = cs._model(torch, cfg, mode)
        runs = []
        for _ in range(args.reps):
            for overlap in (False, True, True, False):
                r = one_run(torch, cs, cfg, models[mode], kw, prompts,
                            params_of, lead, overlap)
                if runs and r["greedy"] != runs[0]["greedy"]:
                    cs.fail(f"{label}: greedy tokens of a "
                            f"{'overlapped' if overlap else 'serial'} run "
                            "differ from the first serial run's")
                runs.append(r)
                cs.say(f"{label}: {'overlapped' if overlap else 'serial'} "
                       f"{r['tok_s']:.1f} tok/s, decode step "
                       f"{r['decode_step_ms']:.2f} ms, tpot p50 "
                       f"{r['tpot_p50_ms']:.2f} ms, ttft p50 "
                       f"{r['ttft_p50_s']:.3f} s, {r['ticks']} ticks")
        summary = {}
        for overlap in (False, True):
            mine = [r for r in runs if r["overlap"] == overlap]
            summary["overlapped" if overlap else "serial"] = {
                k: statistics.median(r[k] for r in mine)
                for k in ("tok_s", "decode_step_ms", "tpot_p50_ms",
                          "ttft_p50_s")}
        s, o = summary["serial"], summary["overlapped"]
        cs.say(f"{label}: medians of {args.reps * 2} runs each: serial "
               f"{s['tok_s']:.1f} tok/s, step {s['decode_step_ms']:.2f} ms;"
               f" overlapped {o['tok_s']:.1f} tok/s, step "
               f"{o['decode_step_ms']:.2f} ms; overlapped / serial tok/s "
               f"{o['tok_s'] / s['tok_s']:.3f}; greedy tokens identical")
        results[label] = {"runs": [{k: v for k, v in r.items()
                                    if k != "greedy"} for r in runs],
                          "summary": summary}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card,
                                              "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
