"""Serving launcher, stream mode: sparse weights + sparse KV through the
continuous-batching engine (twin of ``repro.launch.serve`` without the
later slices' flags).  ``--int8`` serves int8 block-sparse weights,
``--paged`` the shared-prefix paged pool (``--phys-blocks`` sizes its
arena), ``--spec-k K`` draft-verify speculation with an n-gram drafter
(``--spec-adaptive`` per-slot draft windows), as in the reference.

Stream mode runs overlapped ticks by default, as the reference does: tick
t+1 is enqueued before tick t's tokens reach the host, and each tick's
decode (or verify) forward, each prefill chunk, each refreeze and each
prefix-hit assignment is one replay of a captured CUDA graph.
``--no-overlap`` restores the serial loop, the token-identity oracle
(greedy and seeded output are identical either way).  The run prints the
captures per entry (``decode``, ``prefill_chunk`` per chunk width class,
``refreeze``, ``assign`` on the paged pool, ``verify`` under speculation),
the replays per entry and the kernel launches, replays included.

Initialises the model from a seed on the device, prunes and packs every
linear weight there, and drives a stream of requests with mixed prompt and
output lengths (drawn exactly as the reference launcher draws them) through
the pooled sparse-KV cache.

  python -m repro_torch.launch.serve --arch qwen3-0.6b --device cuda \\
      --requests 8 --slots 4 --prompt-len 256 --steps 64 --prefill-chunk 256
  python -m repro_torch.launch.serve --arch qwen3-0.6b --device cuda \\
      --paged --int8 --requests 8 --slots 4 --prompt-len 256 --steps 64 \\
      --prefill-chunk 256
  python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \\
      --device cpu --requests 4 --slots 2 --prompt-len 48 --steps 12
  python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \\
      --device cpu --spec-k 3 --requests 4 --slots 2 --prompt-len 48 \\
      --steps 12
  python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \\
      --device cpu --no-overlap --requests 4 --slots 2 --prompt-len 48 \\
      --steps 12
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.convert import convert_concrete, sparsity_report
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import lm
from repro_torch.serving import (ContinuousEngine, SamplingParams, SpecConfig,
                                 stable_trace_counts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16,
                    help="max_new_tokens per request")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prompt tokens prefilled per tick (0 = whole)")
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--int8", action="store_true",
                    help="int8 block-sparse weights (per-channel scale)")
    ap.add_argument("--paged", action="store_true",
                    help="paged shared-prefix pool: compressed blocks live "
                         "once in a pool-global arena behind per-slot block "
                         "tables; prompts sharing a block-aligned prefix "
                         "store and prefill it once (needs --prefill-chunk "
                         "for prefix-cache hits)")
    ap.add_argument("--phys-blocks", type=int, default=0,
                    help="with --paged: physical blocks in the shared arena "
                         "(default: slots * max_blocks, the flat pool's "
                         "footprint)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: verify up to K n-gram draft "
                         "tokens per slot per tick (0 = off; greedy output "
                         "is token-identical either way)")
    ap.add_argument("--spec-adaptive", action="store_true",
                    help="with --spec-k: per-slot adaptive draft windows "
                         "(each slot's acceptance rate scales its K)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable the overlapped tick pipeline (overlap is "
                         "on by default: tick t+1 is enqueued before tick "
                         "t's tokens reach the host; --no-overlap is the "
                         "serial token-identity oracle)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the CUDA device (raises without one)")
    args = ap.parse_args(argv)
    if args.spec_adaptive and not args.spec_k:
        ap.error("--spec-adaptive requires --spec-k >= 1")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(cfg, sparsity=args.sparsity)
    params = lm.init_params(cfg, seed=0, device=dev)
    params = convert_concrete(params, lm.model_specs(cfg), cfg,
                              mode="int8" if args.int8 else "bf16",
                              device=dev)
    rep = sparsity_report(params)
    tot_d = sum(r["dense_bytes"] for r in rep.values())
    tot_c = sum(r["compressed_bytes"] for r in rep.values())
    print(f"[serve] sparse-converted {len(rep)} weights: {tot_d/1e6:.1f}MB "
          f"-> {tot_c/1e6:.1f}MB ({tot_c/tot_d:.3f}x) on {dev}")

    n_req = args.requests
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.prompt_len,
                    global_batch=n_req)
    prompts = host_batch(dc, 0)["tokens"]
    eng = ContinuousEngine(
        params, cfg, slots=args.slots,
        max_tokens=args.prompt_len + args.steps + cfg.kv_tail,
        prefill_chunk=args.prefill_chunk or None, device=dev,
        paged=args.paged, phys_blocks=args.phys_blocks,
        spec=SpecConfig(k=args.spec_k, adaptive=args.spec_adaptive)
        if args.spec_k else None, overlap=not args.no_overlap)
    if args.paged:
        print(f"[serve] paged pool: {eng.pool.n_phys} physical blocks of "
              f"{eng.pool.bs} tokens behind {args.slots}x"
              f"{eng.pool.max_blocks} block tables")

    rng = np.random.default_rng(0)
    reset_launch_counts()
    t0 = time.time()
    rids = []
    for i in range(n_req):
        plen = int(rng.integers(max(args.prompt_len // 2, 1),
                                args.prompt_len + 1))
        steps = int(rng.integers(max(args.steps // 2, 1), args.steps + 1))
        sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, seed=args.seed + i,
                            max_new_tokens=steps)
        rids.append(eng.submit(prompts[i][:plen], sp))
    out = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    total = sum(len(o.token_ids) for o in out.values())
    print(f"[serve] stream: {n_req} requests, {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s) on {args.slots} slots, "
          f"{'serial' if args.no_overlap else 'overlapped'} ticks")
    print(f"[serve] graph captures per entry: {eng.trace_counts()} "
          f"(stable: {stable_trace_counts(eng.trace_counts())}; "
          f"prefill_chunk: one per chunk width class); entry replays "
          f"{eng.replay_counts()}")
    ttfts = [o.metrics.ttft for o in out.values()
             if o.metrics.ttft is not None]
    if ttfts:
        print(f"[serve] ttft p50={np.median(ttfts)*1e3:.0f}ms "
              f"max={max(ttfts)*1e3:.0f}ms; finish: "
              f"{ {o.finish_reason for o in out.values()} }")
    if args.paged:
        print(f"[serve] paged: prefix trie holds {len(eng._trie)} blocks; "
              f"{eng._alloc.free_blocks()}/{eng.pool.n_phys} reclaimable")
    if args.spec_k:
        apt = [o.metrics.accepted_per_tick for o in out.values()
               if o.metrics.accepted_per_tick is not None]
        mean = f"{np.mean(apt):.2f}" if apt else "n/a (no decode ticks)"
        print(f"[serve] spec: accepted-draft histogram "
              f"{eng.spec_hist.tolist()} (index = drafts accepted/tick); "
              f"mean tokens/tick {mean}")
        if eng.adaptive_hist is not None:
            print(f"[serve] spec: adaptive proposal histogram "
                  f"{eng.adaptive_hist.tolist()} "
                  f"(index = drafts proposed/tick)")
    print("[serve] sample:", list(out[rids[0]].token_ids[:16]))
    print(f"[serve] kernel launches: {launch_counts()} (graph replays "
          f"included)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
