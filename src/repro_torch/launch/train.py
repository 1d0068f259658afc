"""Training launcher: data -> train step -> checkpoint, with restart from
the latest checkpoint and a failure-injection harness for the
fault-tolerance tests (twin of ``repro.launch.train``).

Params are drawn on the device from seed ``cfg.n_layers`` (the reference's
key) and laid out as ``serving/engine.py::params_to`` stores them, so on
the card every dense linear and the tied head run the hand-written dense
kernel as ``[N, K]`` rows, in the forward and the remat replay.  Runs on
the CUDA device unless ``--device cpu``.

``--data D --model M`` (D * M above 1) trains over a ``(data, model)``
mesh of D * M ranks started by ``launch/mesh.py::spawn`` (``--backend
gloo``, the default, for CPU ranks or ranks that share a card; ``nccl``
needs a card a rank): each rank draws the params whole, keeps its
``tree_param_specs`` block, holds its ZeRO-1 block of the optimizer state
and its data shard of every batch (``train_loop(mesh=)``); checkpoints
hold the full tree (restorable onto any mesh).  Rank 0 prints the losses
and a step's collectives.

Usage (CPU-scale examples):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --device cpu --steps 8 --batch 4 --seq 32 \\
      --ckpt-dir /tmp/ckpt --ckpt-every 4
  PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
      --device cpu --data 2 --model 2 --steps 4 --batch 8 --seq 32
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, sharded_batch
from repro_torch.distributed.sharding import (STATS, PartitionSpec,
                                              ShardCtx, default_rules, place,
                                              reset_stats)
from repro_torch.models import lm
from repro_torch.optim import OptConfig, abstract_opt_state, init_opt_state
from repro_torch.serving.engine import params_to
from repro_torch.train import make_train_step
from repro_torch.train.step import train_specs


def _is_rank0(mesh) -> bool:
    return mesh is None or all(mesh.coordinate(a) == 0
                               for a in mesh.axis_names)


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
    warm-up, cosine to ``steps``).

    ``mesh`` (a ``launch.mesh.Mesh``; every rank calls): ``params`` and
    ``opt_state`` come back as this rank's blocks (``tree_param_specs``,
    ZeRO-1), the losses are the global batch's; the mesh's device is the
    device."""
    dev = resolve_device(device) if mesh is None else mesh.device
    full = lm.init_params(cfg, seed=cfg.n_layers, device=dev)
    placement, specs, ctx = None, None, None
    if mesh is not None:
        ctx = ShardCtx(mesh, default_rules("pod" in mesh.shape, cfg))
        lm.check_train_mesh(cfg)
        pspecs, zspecs = train_specs(cfg, ctx)
        placement = (pspecs, zspecs, mesh)
        specs = {"params": pspecs, "opt": {"step": PartitionSpec(),
                                           "master": zspecs, "m": zspecs,
                                           "v": zspecs}}
        full = place(full, pspecs, mesh)
    params = params_to(full, dev)
    del full
    opt_state = init_opt_state(params, placement)
    log = print if _is_rank0(mesh) else (lambda *a, **k: None)
    step0 = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        step0 = ckpt.latest_step()
        like = {"params": params, "opt": opt_state}
        if mesh is not None:
            abstract = lm.abstract_params(cfg)
            like = {"params": abstract, "opt": abstract_opt_state(abstract)}
        state, _ = ckpt.restore(step0, like, device=dev, shardings=(
            None if mesh is None else (specs, mesh)))
        params, opt_state = params_to(state["params"], dev), state["opt"]
        log(f"[train] resumed from step {step0}", flush=True)
    if optc is None:
        optc = OptConfig(peak_lr=1e-3, warmup_steps=max(steps // 10, 1),
                         decay_steps=steps)
    step_fn = make_train_step(cfg, optc, ctx=ctx)
    losses = []
    for i in range(step0, steps):
        if fail_at is not None and i == fail_at:
            raise RuntimeError(f"injected failure at step {i}")
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in sharded_batch(data_cfg, i, mesh).items()}
        reset_stats()
        t0 = time.time()
        params, opt_state, mets = step_fn(params, opt_state, batch)
        loss = float(mets["loss"])
        losses.append(loss)
        if i % log_every == 0:
            coll = "" if mesh is None else (
                f"; collectives {STATS['calls']} calls, "
                f"{STATS['bytes'] / 1e6:.2f} MB, {STATS['seconds']:.2f} s")
            log(f"[train] step {i} loss {loss:.4f} "
                f"({time.time() - t0:.2f}s{coll})", flush=True)
        if ckpt is not None and ckpt_every and (i + 1) % ckpt_every == 0:
            ckpt.save(i + 1, {"params": params, "opt": opt_state},
                      meta={"loss": loss}, shardings=(
                          None if mesh is None else (specs, mesh)))
    if ckpt is not None:
        ckpt.wait()
    return params, opt_state, losses


def _run(args, mesh=None, fail_at=None):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    return train_loop(cfg, args.steps, dc, ckpt, args.ckpt_every,
                      mesh=mesh, fail_at=fail_at, device=args.device)[2]


def _rank(rank: int, world: int, args, fail_at) -> list:
    """One rank of ``main``'s mesh (``launch/mesh.py::spawn``)."""
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh((args.data, args.model), ("data", "model"),
                     args.device, args.backend)
    return _run(args, mesh, fail_at)


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
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the mesh's process group (gloo: CPU ranks or "
                         "ranks sharing a card; nccl: a card a rank)")
    ap.add_argument("--retries", type=int, default=0,
                    help="auto-restart-from-checkpoint attempts on failure")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the CUDA device unless cpu (the plain versions)")
    args = ap.parse_args(argv)
    world = args.data * args.model
    if world > 1:
        from repro_torch.launch.mesh import spawn
        print(f"[train] mesh {args.data}x{args.model} (data x model): "
              f"{world} {args.backend} ranks on "
              f"{resolve_device(args.device).type}", flush=True)
    attempts = args.retries + 1
    for attempt in range(attempts):
        fail_at = args.fail_at if attempt == 0 else None
        try:
            if world > 1:
                losses = spawn(_rank, world, (args, fail_at),
                               backend=args.backend, device=args.device)[0]
            else:
                losses = _run(args, fail_at=fail_at)
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
