"""Serving launcher: sparse weights + sparse KV (twin of
``repro.launch.serve`` without ``--audit`` and ``--mesh``, which wait for
the sharded part of the port).

* **stream mode** (the default) drives the continuous-batching engine with
  a stream of requests of mixed prompt and output lengths;
* ``--one-shot`` runs the legacy static-batch ``Engine`` instead: the
  first ``--batch`` prompts prefilled whole, frozen into the sparse KV
  cache and decoded lockstep (eagerly: each refreeze grows the prefix).

``--dense`` is the baseline: dense weights and, one-shot, the dense KV
cache; in stream mode it sets the KV sparsity to 0 (the pooled compression
is then a bit-exact round trip).  ``--int8`` serves int8 block-sparse
weights, ``--paged`` the shared-prefix paged pool (``--phys-blocks`` sizes
its arena), ``--spec-k K`` draft-verify speculation with an n-gram drafter
(``--spec-adaptive`` per-slot draft windows), as in the reference.
``--snapshot-dir DIR`` (with ``--paged``) restores the prefix cache from
the newest snapshot under DIR on start (a cold start says why when there
is none) and snapshots it once the stream drains, or at a server's
shutdown.  ``REPRO_CHECKIFY=1`` builds the sanitized pool (a device error
word the engine reads with each tick's tokens).

``--server`` swaps the synthetic request stream for the asyncio HTTP
frontend (``repro_torch.serving.frontend``: ``POST /v1/generate`` streams
NDJSON token frames, ``POST /v1/cancel``, ``GET /healthz``, ``POST
/v1/shutdown``) on ``--host`` / ``--port``.  The lifecycle flags mean what
they mean in the reference: ``--max-queue`` (load shedding),
``--deadline`` / ``--ttft-deadline`` (per-request budgets, stream mode),
``--degrade-queue`` (no drafting under queue pressure, with
``--spec-k``).  Telemetry: ``--metrics-port`` (Prometheus text on
``/metrics``), ``--trace-file`` (Chrome trace of request lifecycles and
fault firings), ``--log-json`` (one JSON line per finished request and a
summary), ``--report-every`` (a one-line ``[obs]`` report every N
seconds), ``--profile-dir`` (a ``torch.profiler`` trace of the stream,
CUDA kernels included on the card, written under the directory).

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
  python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \\
      --device cpu --server --port 0 --slots 2 --prompt-len 32 --steps 8 \\
      --prefill-chunk 16 --max-queue 8 --metrics-port 0
  python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \\
      --device cpu --paged --prefill-chunk 16 --snapshot-dir /tmp/snap
  python -m repro_torch.launch.serve --arch qwen3-0.6b --device cuda \\
      --one-shot --batch 4 --prompt-len 512 --steps 160 [--dense]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.convert import convert_concrete, sparsity_report
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import lm
from repro_torch.serving import (ContinuousEngine, Engine, SamplingParams,
                                 SpecConfig, stable_trace_counts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=0,
                    help="stream mode: number of requests (default: batch)")
    ap.add_argument("--slots", type=int, default=0,
                    help="stream mode: cache-pool slots (default: batch)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16,
                    help="max_new_tokens per request")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prompt tokens prefilled per tick (0 = whole)")
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--int8", action="store_true",
                    help="int8 block-sparse weights (per-channel scale)")
    ap.add_argument("--dense", action="store_true",
                    help="baseline: dense weights + dense KV (stream mode: "
                         "KV sparsity 0)")
    ap.add_argument("--one-shot", action="store_true",
                    help="the legacy static-batch engine instead of the "
                         "continuous-batching stream")
    ap.add_argument("--snapshot-dir", default="",
                    help="stream mode, with --paged: restore the prefix "
                         "cache (arena + trie + allocator) from the newest "
                         "snapshot on start, and snapshot it once the "
                         "stream drains (or at a server's shutdown)")
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
    ap.add_argument("--server", action="store_true",
                    help="instead of a synthetic request stream, serve the "
                         "asyncio HTTP frontend: POST /v1/generate streams "
                         "NDJSON token frames, POST /v1/cancel aborts, GET "
                         "/healthz probes, POST /v1/shutdown drains the "
                         "pipeline and exits")
    ap.add_argument("--host", default="127.0.0.1",
                    help="with --server: bind address")
    ap.add_argument("--port", type=int, default=8731,
                    help="with --server: port (0 = pick a free one)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue: submits past the bound "
                         "are shed at once (finish_reason='shed'); 0 = "
                         "unbounded")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request total wall-clock deadline in seconds "
                         "(finish_reason='timeout' past it); 0 = none")
    ap.add_argument("--ttft-deadline", type=float, default=0.0,
                    help="per-request first-token deadline in seconds; 0 = "
                         "none")
    ap.add_argument("--degrade-queue", type=int, default=0,
                    help="with --spec-k: draft nothing while the queue holds "
                         "at least this many requests; 0 = off")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve Prometheus text on http://127.0.0.1:PORT/"
                         "metrics from a background thread (0 = a free "
                         "port; -1 = off)")
    ap.add_argument("--trace-file", default="",
                    help="write request-lifecycle spans and fault firings "
                         "as a Chrome trace-event JSON (chrome://tracing or "
                         "ui.perfetto.dev)")
    ap.add_argument("--log-json", action="store_true",
                    help="one JSON line per finished request and a summary "
                         "instead of the free-form result lines")
    ap.add_argument("--profile-dir", default="",
                    help="wrap the stream in a torch.profiler trace (CUDA "
                         "kernels included on the card) written under DIR")
    ap.add_argument("--report-every", type=float, default=0.0,
                    help="print a one-line metrics report every N seconds "
                         "of serving; 0 = off")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the CUDA device (raises without one)")
    args = ap.parse_args(argv)
    if args.spec_adaptive and not args.spec_k:
        ap.error("--spec-adaptive requires --spec-k >= 1")
    if args.degrade_queue and not args.spec_k:
        ap.error("--degrade-queue needs --spec-k (it degrades by dropping "
                 "the draft window)")
    if args.one_shot and (args.metrics_port >= 0 or args.trace_file
                          or args.log_json or args.profile_dir
                          or args.report_every):
        ap.error("observability flags (--metrics-port/--trace-file/"
                 "--log-json/--profile-dir/--report-every) are stream-mode "
                 "only")
    if args.snapshot_dir and not args.paged:
        ap.error("--snapshot-dir needs --paged (only the shared-prefix "
                 "arena + trie persist across restarts)")
    if args.server and args.one_shot:
        ap.error("--server is stream-mode only (the one-shot engine has no "
                 "scheduler to serve requests through)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(cfg, sparsity=args.sparsity)
    params = lm.init_params(cfg, seed=0, device=dev)
    if not args.dense:
        params = convert_concrete(params, lm.model_specs(cfg), cfg,
                                  mode="int8" if args.int8 else "bf16",
                                  device=dev)
        rep = sparsity_report(params)
        tot_d = sum(r["dense_bytes"] for r in rep.values())
        tot_c = sum(r["compressed_bytes"] for r in rep.values())
        print(f"[serve] sparse-converted {len(rep)} weights: "
              f"{tot_d/1e6:.1f}MB -> {tot_c/1e6:.1f}MB "
              f"({tot_c/tot_d:.3f}x) on {dev}")

    n_req = args.requests or args.batch
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.prompt_len,
                    global_batch=max(n_req, args.batch))
    prompts = host_batch(dc, 0)["tokens"]
    if args.one_shot:
        eng = Engine(params, cfg, kv_mode="dense" if args.dense else "sparse",
                     device=dev)
        sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, seed=args.seed,
                            max_new_tokens=args.steps)
        reset_launch_counts()
        t0 = time.time()
        toks, _ = eng.generate({"tokens": prompts[:args.batch]}, sp)
        toks = toks.cpu()
        dt = time.time() - t0
        print(f"[serve] one-shot: {args.steps} tokens x {args.batch} reqs "
              f"in {dt:.2f}s ({args.steps * args.batch / dt:.1f} tok/s, "
              f"{'dense' if args.dense else 'sparse'} KV, eager)")
        print("[serve] sample:", toks[0][:16].tolist())
        print(f"[serve] kernel launches: {launch_counts()}")
        return 0
    if args.dense:
        # dense-KV baseline: zero KV sparsity makes the pooled compression
        # a bit-exact round trip at full per-block capacity
        cfg = dataclasses.replace(cfg, kv_k_sparsity=0.0, kv_v_sparsity=0.0)
    slots = args.slots or args.batch
    obs = metrics_server = None
    if args.metrics_port >= 0 or args.trace_file or args.report_every:
        from repro_torch.obs import MetricsServer, Observability
        obs = Observability(trace_path=args.trace_file or None,
                            report_every=args.report_every)
        if args.metrics_port >= 0:
            metrics_server = MetricsServer(obs.registry,
                                           port=args.metrics_port).start()
            print(f"[serve] metrics: {metrics_server.url}")
    eng = ContinuousEngine(
        params, cfg, slots=slots,
        max_tokens=args.prompt_len + args.steps + cfg.kv_tail,
        prefill_chunk=args.prefill_chunk or None, device=dev,
        paged=args.paged, phys_blocks=args.phys_blocks,
        spec=SpecConfig(k=args.spec_k, adaptive=args.spec_adaptive)
        if args.spec_k else None, max_queue=args.max_queue,
        degrade_queue=args.degrade_queue, obs=obs,
        overlap=not args.no_overlap)
    if args.paged:
        print(f"[serve] paged pool: {eng.pool.n_phys} physical blocks of "
              f"{eng.pool.bs} tokens behind {slots}x"
              f"{eng.pool.max_blocks} block tables")
    if args.snapshot_dir:
        try:
            n = eng.load_snapshot(args.snapshot_dir)
            print(f"[serve] warm restart: restored {n} prefix pages from "
                  f"{args.snapshot_dir} (trie holds {len(eng._trie)} "
                  "blocks; matching prompts skip their prefill)")
        except ValueError as e:
            print(f"[serve] cold start: {e}")

    def snapshot():
        step = eng.save_snapshot(args.snapshot_dir)
        print(f"[serve] snapshot: step {step} -> {args.snapshot_dir} "
              f"({len(eng._trie)} prefix blocks persisted)")

    def close_obs():
        if obs is not None:
            obs.close()
            if args.trace_file:
                print(f"[serve] trace: {args.trace_file} "
                      f"({obs.trace.events_written} events; load in "
                      "chrome://tracing or ui.perfetto.dev)")
        if metrics_server is not None:
            metrics_server.close()

    if args.server:
        from repro_torch.serving import ServerFrontend
        def on_shutdown():
            if args.snapshot_dir:
                snapshot()
            close_obs()

        front = ServerFrontend(eng, host=args.host, port=args.port,
                               on_shutdown=on_shutdown)

        def ready(port):
            print(f"[serve] server: http://{args.host}:{port} — POST "
                  "/v1/generate {'prompt': [ids...]} streams NDJSON token "
                  "frames; GET /healthz; POST /v1/cancel; POST "
                  "/v1/shutdown", flush=True)
        try:
            front.run(ready)
        except KeyboardInterrupt:
            pass
        print(f"[serve] server drained after {front.loop_thread.ticks} "
              f"ticks, {front.requests_served} requests; graph captures "
              f"per entry: {eng.trace_counts()}; fault counters "
              f"{eng.fault_counters}")
        return 0

    on_token = None
    if args.log_json:
        def on_token(o):
            """One structured line per finished request."""
            if not o.finished:
                return
            m = o.metrics
            print(json.dumps({
                "event": "request", "id": o.request_id,
                "finish_reason": o.finish_reason,
                "prompt_tokens": len(o.prompt_token_ids),
                "tokens": len(o.token_ids),
                "ttft_s": m.ttft, "tpot_s": m.tpot,
                "queue_s": m.queue_time, "prefill_s": m.prefill_time,
                "decode_s": m.decode_time, "e2e_s": m.e2e_latency}))

    profile = contextlib.nullcontext()
    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profile = torch.profiler.profile(
            activities=acts, on_trace_ready=torch.profiler
            .tensorboard_trace_handler(args.profile_dir))
    rng = np.random.default_rng(0)
    reset_launch_counts()
    t0 = time.time()
    rids = []
    with profile:
        for i in range(n_req):
            plen = int(rng.integers(max(args.prompt_len // 2, 1),
                                    args.prompt_len + 1))
            steps = int(rng.integers(max(args.steps // 2, 1),
                                     args.steps + 1))
            sp = SamplingParams(
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, seed=args.seed + i, max_new_tokens=steps,
                deadline_s=args.deadline or None,
                ttft_deadline_s=args.ttft_deadline or None)
            rids.append(eng.submit(prompts[i][:plen], sp, on_token=on_token))
        out = eng.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dt = time.time() - t0
    total = sum(len(o.token_ids) for o in out.values())
    reasons = [o.finish_reason for o in out.values()]
    if args.log_json:
        print(json.dumps({
            "event": "summary", "requests": n_req, "tokens": total,
            "wall_s": dt, "tok_s": total / dt if dt > 0 else None,
            "slots": slots,
            "finish_reasons": {r: reasons.count(r) for r in set(reasons)},
            "captures": eng.trace_counts(),
            "fault_counters": eng.fault_counters}))
        if args.snapshot_dir:
            snapshot()
        close_obs()
        return 0
    print(f"[serve] stream: {n_req} requests, {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s) on {slots} slots, "
          f"{'serial' if args.no_overlap else 'overlapped'} ticks")
    print(f"[serve] graph captures per entry: {eng.trace_counts()} "
          f"(stable: {stable_trace_counts(eng.trace_counts())}; "
          f"prefill_chunk: one per chunk width class); entry replays "
          f"{eng.replay_counts()}")
    print(f"[serve] fault counters: {eng.fault_counters}")
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
    if obs is not None:
        print(obs.report_line())
    if args.snapshot_dir:
        snapshot()
    close_obs()
    if args.profile_dir:
        print(f"[serve] profile: {args.profile_dir} (Perfetto or "
              "TensorBoard)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
