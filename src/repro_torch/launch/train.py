"""Training launcher: data -> train step -> checkpoint, with restart from
the latest checkpoint and a failure-injection harness for the
fault-tolerance tests (twin of ``repro.launch.train``, single process).

Params are drawn on the device from seed ``cfg.n_layers`` (the reference's
key) and laid out as ``serving/engine.py::params_to`` stores them, so on
the card every dense linear and the tied head run the hand-written dense
kernel as ``[N, K]`` rows, in the forward and the remat replay.  Runs on
the CUDA device unless ``--device cpu``.  ``--data`` / ``--model`` above
1 (a mesh) wait for ROADMAP Queue 1 item 3.

Usage (CPU-scale example):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --device cpu --steps 8 --batch 4 --seq 32 \\
      --ckpt-dir /tmp/ckpt --ckpt-every 4
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.models import lm
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.serving.engine import params_to
from repro_torch.train import make_train_step

MESH_ITEM = ("training over a mesh (--data / --model > 1) waits for "
             "ROADMAP Queue 1 item 3 (the mesh)")


def train_loop(cfg, steps: int, data_cfg: DataConfig,
               ckpt: Optional[CheckpointManager] = None,
               ckpt_every: int = 0, mesh=None, log_every: int = 1,
               fail_at: Optional[int] = None,
               optc: Optional[OptConfig] = None,
               device: Optional[torch.device] = None):
    """Returns ``(params, opt_state, losses)``: steps up to ``steps``, from
    the latest checkpoint of ``ckpt`` when it has one (``{"params",
    "opt"}``, the int32 ``step`` included), saving every ``ckpt_every``
    steps.  ``fail_at`` raises at the start of that step.  ``optc``
    defaults to the reference's (peak 1e-3, a tenth of the steps of
    warm-up, cosine to ``steps``)."""
    if mesh is not None:
        raise NotImplementedError(MESH_ITEM)
    dev = resolve_device(device)
    params = params_to(lm.init_params(cfg, seed=cfg.n_layers, device=dev),
                       dev)
    opt_state = init_opt_state(params)
    step0 = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        step0 = ckpt.latest_step()
        state, _ = ckpt.restore(step0, {"params": params, "opt": opt_state},
                                device=dev)
        params, opt_state = params_to(state["params"], dev), state["opt"]
        print(f"[train] resumed from step {step0}", flush=True)
    if optc is None:
        optc = OptConfig(peak_lr=1e-3, warmup_steps=max(steps // 10, 1),
                         decay_steps=steps)
    step_fn = make_train_step(cfg, optc)
    losses = []
    for i in range(step0, steps):
        if fail_at is not None and i == fail_at:
            raise RuntimeError(f"injected failure at step {i}")
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in host_batch(data_cfg, i).items()}
        t0 = time.time()
        params, opt_state, mets = step_fn(params, opt_state, batch)
        loss = float(mets["loss"])
        losses.append(loss)
        if i % log_every == 0:
            print(f"[train] step {i} loss {loss:.4f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
        if ckpt is not None and ckpt_every and (i + 1) % ckpt_every == 0:
            ckpt.save(i + 1, {"params": params, "opt": opt_state},
                      meta={"loss": loss})
    if ckpt is not None:
        ckpt.wait()
    return params, opt_state, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--data", type=int, default=1, help="data mesh axis")
    ap.add_argument("--model", type=int, default=1, help="model mesh axis")
    ap.add_argument("--retries", type=int, default=0,
                    help="auto-restart-from-checkpoint attempts on failure")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the CUDA device unless cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.data * args.model > 1:
        ap.error(MESH_ITEM)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    attempts = args.retries + 1
    for attempt in range(attempts):
        try:
            _, _, losses = train_loop(
                cfg, args.steps, dc, ckpt, args.ckpt_every,
                fail_at=args.fail_at if attempt == 0 else None,
                device=args.device)
            print(f"[train] done; first loss {losses[0]:.4f} "
                  f"last {losses[-1]:.4f}")
            return 0
        except RuntimeError as e:
            then = ("restarting from checkpoint" if attempt + 1 < attempts
                    else "giving up")
            print(f"[train] FAILURE ({e}); {then}", flush=True)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
