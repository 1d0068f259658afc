"""Rank body of ``tests/test_torch_train_mesh.py``: four gloo CPU ranks
train through the port's training mesh.  Imports torch and the port only:
no JAX and nothing of the reference package; the reference's params and
inputs come from a file the parent wrote.  Each rank returns what it saw
(rank 0 also the gathered trees), and the parent holds it against the
reference."""
import dataclasses
import pickle

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, sharded_batch
from repro_torch.distributed import (ShardCtx, all_reduce, default_rules,
                                     gather_tree, place, tree_param_specs)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import train_loop
from repro_torch.models import moe
from repro_torch.models.module import abstract, tree_leaves, tree_map
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.train import (init_dp_error_state, make_compressed_grads,
                               make_train_step, value_and_grad)
from repro_torch.train.step import train_specs

SHAPES = ((2, 2), (4, 1), (1, 4))
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _label(shape):
    return f"{shape[0]}x{shape[1]}"


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _batch(dc, step, mesh):
    return {k: torch.as_tensor(v) for k, v in
            sharded_batch(dc, step, mesh).items()}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _paths(v, f"{prefix}/{k}" if prefix
                                     else k).items()}
    return {prefix: tuple(tree.shape)}


def train_runs(cfg, full, dc, optc, meshes, rank):
    """Four steps from the reference's params on every mesh: losses, the
    ZeRO-1 blocks' shapes, a data rank's rows of step 1; rank 0 also the
    first step's whole gradient (the ranks' shares summed over the data
    axis and gathered) and params after it."""
    out = {}
    for shape, mesh in meshes.items():
        ctx = ShardCtx(mesh, default_rules(False, cfg))
        pspecs, zspecs = train_specs(cfg, ctx)
        placement = (pspecs, zspecs, mesh)
        params = place(full, pspecs, mesh)
        opt = init_opt_state(params, placement)
        step = make_train_step(cfg, optc, ctx=ctx)
        _, share = value_and_grad(params, _batch(dc, 0, mesh), cfg, ctx=ctx)
        grads = gather_tree(tree_map(lambda g: all_reduce(g, mesh, ("data",)),
                                     share), pspecs, mesh)
        losses = []
        for i in range(4):
            params, opt, mets = step(params, opt, _batch(dc, i, mesh))
            losses.append(float(mets["loss"]))
            if i == 0:
                first = gather_tree(params, pspecs, mesh)
        out[_label(shape)] = {
            "losses": losses,
            "coord": {a: mesh.coordinate(a) for a in mesh.axis_names},
            "zero1": {k: _paths(opt[k]) for k in ("master", "m", "v")},
            "rows": sharded_batch(dc, 1, mesh),
            "grads": _np(grads) if rank == 0 else None,
            "first": _np(first) if rank == 0 else None}
    return out


def microbatch(cfg, full, dc, optc, mesh):
    """One step of the global batch whole and as microbatches of 4 global
    rows (2 a data rank) from the same params: the losses and the largest
    master difference."""
    ctx = ShardCtx(mesh, default_rules(False, cfg))
    pspecs, zspecs = train_specs(cfg, ctx)
    params = place(full, pspecs, mesh)
    opt = init_opt_state(params, (pspecs, zspecs, mesh))
    batch = _batch(dc, 0, mesh)
    _, o1, m1 = make_train_step(cfg, optc, ctx=ctx)(params, opt, batch)
    _, o2, m2 = make_train_step(cfg, optc, microbatch=4, ctx=ctx)(
        params, opt, batch)
    worst = max(((a - b).abs() - (1e-6 + 1e-4 * b.abs())).max().item()
                for a, b in zip(tree_leaves(o1["master"]),
                                tree_leaves(o2["master"])))
    return {"loss": float(m1["loss"]), "loss_micro": float(m2["loss"]),
            "master_excess": worst}


def elastic(cfg, dc, optc, meshes, directory):
    """``train_loop`` on (2, 2): four steps straight; two steps and a
    checkpoint, then a restore onto (4, 1) and the last two."""
    kw = dict(optc=optc, device="cpu")
    _, _, straight = train_loop(cfg, 4, dc, mesh=meshes[(2, 2)], **kw)
    train_loop(cfg, 2, dc, ckpt=CheckpointManager(directory), ckpt_every=2,
               mesh=meshes[(2, 2)], **kw)
    params, opt, resumed = train_loop(cfg, 4, dc,
                                      ckpt=CheckpointManager(directory),
                                      mesh=meshes[(4, 1)], **kw)
    return {"straight": straight, "resumed": resumed,
            "step": int(opt["step"]),
            "master": _paths(opt["master"])}


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |x| (the smallest normal's where x is 0)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def _oracle(acc, scheme: str, n: int):
    """The group's ``g_hat`` and each member's residual from the members'
    f32 ``acc`` (gradient plus carried error) of one leaf, as the
    reference's ``compress_and_reduce`` defines them."""
    if scheme == "bf16":
        q = [a.to(torch.bfloat16).float() for a in acc]
        total = q[0]
        for t in q[1:]:
            total = total + t
        return (total.to(torch.bfloat16).float() / n,
                [a - b for a, b in zip(acc, q)])
    amax = torch.stack([a.abs().max() for a in acc]).max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = [torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
         for a in acc]
    total = q[0].to(torch.int32)
    for t in q[1:]:
        total = total + t.to(torch.int32)
    return (total.to(torch.float32) * scale / n,
            [a - b.to(torch.float32) * scale for a, b in zip(acc, q)])


def compressed(cfg, full, dc, mesh, rank):
    """``make_compressed_grads`` at (4, 1), bf16 twice (the error carried)
    and int8 once, against the oracle built from this rank's one-process
    gradients of all four data shards: the largest distance of ``g_hat``
    from it (bf16 ulps; int8 absolute) and of this rank's error row from
    its residual."""
    n = mesh.shape["data"]
    host = {k: torch.as_tensor(v) for k, v in
            sharded_batch(dc, 0, None).items()}
    rows = dc.global_batch // n
    shards = [value_and_grad(full, {k: v[j * rows:(j + 1) * rows]
                                    for k, v in host.items()}, cfg)[1]
              for j in range(n)]
    leaves = [tree_leaves(g) for g in shards]
    batch = _batch(dc, 0, mesh)
    out = {}
    for scheme, calls in (("bf16", 2), ("int8", 1)):
        fn = make_compressed_grads(cfg, scheme, mesh=mesh)
        err = init_dp_error_state(full)
        errs = [[torch.zeros_like(t) for t in gl] for gl in leaves]
        worst, err_diff = 0.0, 0.0
        for _ in range(calls):
            loss, g_hat, err = fn(full, err, batch)
            new = [[] for _ in range(n)]
            for li, (got, row) in enumerate(zip(tree_leaves(g_hat),
                                                tree_leaves(err))):
                want, res = _oracle([leaves[j][li] + errs[j][li]
                                     for j in range(n)], scheme, n)
                diff = (got - want).abs()
                if scheme == "bf16":
                    diff = diff / _bf16_ulp(want)
                worst = max(worst, float(diff.max()))
                err_diff = max(err_diff, float((row[0] - res[rank]).abs()
                                               .max()))
                for j in range(n):
                    new[j].append(res[j])
            errs = new
        out[scheme] = {"loss": float(loss), "worst": worst,
                       "err_diff": err_diff,
                       "g_hat": _np(g_hat) if rank == 0 else None}
    out["shard_grads"] = [_np(g) for g in shards] if rank == 0 else None
    return out


def _moe_params(inp, cfg):
    return {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict)
                else {kk: torch.from_numpy(np.array(vv))
                      for kk, vv in v.items()})
            for k, v in inp["moe_params"].items()}


def moe_tp(cfg, inp, mesh):
    """``moe_apply`` at (2, 2) on this data rank's rows with the experts'
    ``d_ff`` over the model axis: the output, and the gradients of
    ``sum(out * r)`` (the input's, this rank's expert columns', the
    router's) beside one process's ``moe_local`` on the same rows."""
    full = _moe_params(inp, cfg)
    ctx = ShardCtx(mesh, default_rules(False, cfg))
    specs = moe.moe_specs(cfg)
    pspecs = tree_param_specs(ctx, specs, abstract(specs))
    local = place(full, pspecs, mesh)
    rows = inp["moe_x"].shape[0] // mesh.shape["data"]
    r0 = mesh.coordinate("data") * rows
    x = torch.from_numpy(inp["moe_x"][r0:r0 + rows])
    r = torch.from_numpy(inp["moe_r"][r0:r0 + rows])

    def grads(p, fn):
        p = tree_map(lambda t: t.detach().requires_grad_(), p)
        xx = x.clone().requires_grad_()
        out = fn(p, xx)
        (out * r).sum().backward()
        return out.detach(), xx.grad, tree_map(lambda t: t.grad, p)
    out, gx, gp = grads(local, lambda p, xx: moe.moe_apply(p, xx, cfg, ctx))
    d = x.shape[-1]
    one, gx1, gp1 = grads(full, lambda p, xx: moe.moe_local(
        p, xx.reshape(-1, d), cfg).reshape(xx.shape))
    cut = lambda t, key: place({key: t}, {key: pspecs[key]}, mesh)[key]
    w_err = max(float((gp[k] - cut(gp1[k], k)).abs().max()
                      / gp1[k].abs().max()) for k in ("w_gate", "w_up",
                                                      "w_down"))
    return {"out": out.numpy(), "rows": (r0, rows),
            "one_out": float((out - one).abs().max()),
            "gx_err": float((gx - gx1).abs().max() / gx1.abs().max()),
            "w_err": w_err,
            "router_err": float((gp["router"] - gp1["router"]).abs().max()
                                / gp1["router"].abs().max())}


def moe_ep(cfg, inp, mesh):
    """``moe_apply_ep`` at (4, 1), one expert a rank: this rank's output
    rows and the gradients of ``sum(out * r)`` (its input rows', its
    expert's, its router share)."""
    cfg = dataclasses.replace(cfg, ep_moe=True)
    full = _moe_params(inp, cfg)
    ctx = ShardCtx(mesh, default_rules(False, cfg))
    specs = moe.moe_specs(cfg)
    pspecs = tree_param_specs(ctx, specs, abstract(specs))
    p = tree_map(lambda t: t.requires_grad_(), place(full, pspecs, mesh))
    rows = inp["moe_x"].shape[0] // mesh.shape["data"]
    r0 = mesh.coordinate("data") * rows
    x = torch.from_numpy(inp["moe_x"][r0:r0 + rows]).requires_grad_()
    out = moe.moe_apply(p, x, cfg, ctx)
    (out * torch.from_numpy(inp["moe_r"][r0:r0 + rows])).sum().backward()
    return {"out": out.detach().numpy(), "rows": (r0, rows),
            "gx": x.grad.numpy(), "experts": tuple(p["w_gate"].shape),
            "grads": {k: p[k].grad.numpy() for k in
                      ("router", "w_gate", "w_up", "w_down")}}


def run(rank, world, path):
    torch.set_num_threads(1)
    with open(path, "rb") as f:
        inp = pickle.load(f)
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), **F32)
    full = bridge.params_from_numpy(inp["params"], cfg, "cpu")
    dc = DataConfig(vocab=cfg.vocab, seq_len=inp["seq"],
                    global_batch=inp["batch"])
    optc = OptConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=4)
    meshes = {shape: make_mesh(shape, ("data", "model"), "cpu")
              for shape in SHAPES}
    rec = {"train": train_runs(cfg, full, dc, optc, meshes, rank),
           "micro": microbatch(cfg, full, dc, optc, meshes[(2, 2)]),
           "elastic": elastic(cfg, dc, optc, meshes, inp["ckpt_dir"]),
           "compressed": compressed(cfg, full, dc, meshes[(4, 1)], rank)}
    mcfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b").reduced(),
                               **F32)
    rec["moe_tp"] = moe_tp(mcfg, inp, meshes[(2, 2)])
    rec["moe_ep"] = moe_ep(mcfg, inp, meshes[(4, 1)])
    return rec
