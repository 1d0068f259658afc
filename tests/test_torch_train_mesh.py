"""The training mesh on ``torch.distributed`` ranks, held against the
reference's unsharded training.

One spawn of four gloo CPU ranks (``tests/torch_train_mesh_worker.py``:
no JAX, the reference's params read from a file this process wrote), on
reduced Qwen3-0.6B at f32 with 8 x 32 tokens a step:

* on meshes (2, 2), (4, 1) and (1, 4) four steps from the reference's
  params give the losses of the reference's unsharded ``train_loop``
  (rtol 1e-4, atol 1e-4, the reference test's own bar); the first step's
  gathered gradient is one process's (1e-5 of each leaf's range), and
  the ZeRO-1 update of it is one process's AdamW step within ROADMAP
  Queue 3's bar;
* every rank's ``master`` / ``m`` / ``v`` blocks have the shapes of the
  reference's ``zero1_specs``; ``sharded_batch``'s rows are bit-equal to
  the reference's ``host_batch`` rows;
* ``microbatch=4`` under (2, 2) gives the full batch's step;
* ``train_loop`` saves at (2, 2) after two steps and restores onto (4, 1):
  the last two losses are the uninterrupted run's;
* ``make_compressed_grads`` at (4, 1): ``bf16`` within one bf16 ulp of
  ``bf16(sum q_i) / 4`` and ``int8`` exactly the oracle built from one
  process's gradients of the four data shards (which lie within 1e-5 of
  the reference's per-shard ``loss_fn`` gradients), the error rows those
  ranks' residuals, and ``g_hat`` near the reference's
  ``compress_and_reduce`` on the reference's gradients;
* reduced Phi-3.5-MoE: ``moe_apply`` at (2, 2) against the reference's
  per-shard ``moe_local`` (its gradients against one process's), and
  ``moe_apply_ep`` at (4, 1) against the reference's ``moe_apply`` on all
  the tokens, forward and gradients (``test_ep_moe_exact``'s 1e-4);
* ``python -m repro_torch.launch.train --reduced --device cpu --data 2
  --model 2`` prints one rank's losses.
"""
import contextlib
import dataclasses
import io
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import DataConfig as JaxData
from repro.data import host_batch as jax_batch
from repro.distributed.sharding import ShardCtx as JaxCtx
from repro.distributed.sharding import default_rules as jax_rules
from repro.distributed.sharding import tree_param_specs as jax_specs
from repro.distributed.sharding import zero1_specs as jax_zero1
from repro.launch.train import train_loop as jax_train_loop
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import module as jmod
from repro.optim import OptConfig as JaxOpt
from repro.optim import grad_compress as jcompress
from repro.train import step as jstep

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import spawn
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import OptConfig, adamw_step, init_opt_state
from repro_torch.train import value_and_grad

import torch_train_mesh_worker as worker
from torch_parity import to_numpy

ROOT = Path(__file__).resolve().parents[1]
B, S, STEPS = 8, 32, 4
F32 = dict(param_dtype="float32", compute_dtype="float32")
LABELS = [worker._label(s) for s in worker.SHAPES]


def _one_process(cfg, params, dc, optc):
    """The port's one-process run from ``params``: the losses of STEPS
    steps, the first step's gradient and its AdamW state."""
    opt = init_opt_state(params)
    losses, first = [], None
    for i in range(STEPS):
        batch = {k: torch.as_tensor(v) for k, v in host_batch(dc, i).items()}
        loss, g = value_and_grad(params, batch, cfg)
        if first is None:
            first = {"grads": g, "params": params, "opt": opt}
        params, opt, _ = adamw_step(g, opt, optc, params_like=params)
        losses.append(float(loss))
    return losses, first


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg = dataclasses.replace(jax_config("qwen3-0.6b").reduced(), **F32)
    tcfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), **F32)
    # the reference's train_loop draws its params from this key
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(jcfg.n_layers))
    _, _, ref_losses = jax_train_loop(
        jcfg, STEPS, JaxData(vocab=jcfg.vocab, seq_len=S, global_batch=B),
        optc=JaxOpt(peak_lr=1e-3, warmup_steps=1, decay_steps=STEPS))
    np_params = to_numpy(jparams)
    one = _one_process(tcfg, bridge.params_from_numpy(np_params, tcfg, "cpu"),
                       DataConfig(vocab=tcfg.vocab, seq_len=S, global_batch=B),
                       OptConfig(peak_lr=1e-3, warmup_steps=1,
                                 decay_steps=STEPS))
    # the reference's per-shard gradients of the first batch, and its
    # compressed reduction of them (jax.vmap over a "dp" axis of 4)
    nb = jax_batch(JaxData(vocab=jcfg.vocab, seq_len=S, global_batch=B), 0)
    grad = jax.jit(jax.grad(lambda p, b: jstep.loss_fn(
        p, b, jcfg, JaxCtx(None, {}))))
    rows = B // 4
    shard_grads = [grad(jparams, {k: jnp.asarray(v[j * rows:(j + 1) * rows])
                                  for k, v in nb.items()}) for j in range(4)]
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *shard_grads)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, stacked)
    ref_hat = {scheme: jax.tree_util.tree_map(
        lambda a: np.asarray(a[0]), jax.vmap(
            lambda g, e: jcompress.compress_and_reduce(g, e, ("dp",),
                                                       scheme)[0],
            axis_name="dp")(stacked, zeros)) for scheme in ("bf16", "int8")}
    # reduced Phi-3.5-MoE's layer 0 FFN, and its reference outputs
    mcfg = dataclasses.replace(jax_config("phi3.5-moe-42b-a6.6b").reduced(),
                               **F32)
    mp = jax.jit(lambda k: jlm.init_params(mcfg, k))(jax.random.PRNGKey(0))
    p_moe = jax.tree_util.tree_map(lambda a: a[0],
                                   mp["blocks"]["l0"]["ffn"])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, mcfg.d_model)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    moe_out, moe_vjp = jax.vjp(lambda p, xx: jmoe.moe_apply(p, xx, mcfg,
                                                            None),
                               p_moe, jnp.asarray(x))
    moe_gp, moe_gx = moe_vjp(jnp.asarray(r))
    local = {d: np.asarray(jmoe.moe_local(
        p_moe, jnp.asarray(x[2 * d:2 * d + 2]).reshape(-1, mcfg.d_model),
        mcfg)).reshape(2, 8, -1) for d in range(2)}
    path = tmp_path_factory.mktemp("train_mesh") / "inputs.pkl"
    ckpt = tmp_path_factory.mktemp("train_mesh_ckpt")
    with open(path, "wb") as f:
        pickle.dump({"params": np_params, "batch": B, "seq": S,
                     "ckpt_dir": str(ckpt), "moe_params": to_numpy(p_moe),
                     "moe_x": x, "moe_r": r}, f)
    recs = spawn(worker.run, 4, (str(path),), backend="gloo", device="cpu",
                 timeout=600)
    return {"jcfg": jcfg, "jparams": jparams, "ref_losses": ref_losses,
            "one": one, "recs": recs, "shard_grads": shard_grads,
            "ref_hat": ref_hat, "moe": {"out": np.asarray(moe_out),
                                        "gx": np.asarray(moe_gx),
                                        "gp": to_numpy(moe_gp),
                                        "local": local}}


@pytest.mark.parametrize("label", LABELS)
def test_mesh_losses_equal_the_reference_train_loop(run, label):
    for rank, rec in enumerate(run["recs"]):
        np.testing.assert_allclose(rec["train"][label]["losses"],
                                   run["ref_losses"], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{label} rank {rank}")
    # the port's one process agrees with the reference too
    np.testing.assert_allclose(run["one"][0], run["ref_losses"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("label", LABELS)
def test_mesh_first_gradient_equals_one_process(run, label):
    """The first step's whole gradient (the ranks' shares summed over the
    data axis, gathered over the model axis) against one process's: each
    leaf within 1e-5 of its largest magnitude."""
    got = tree_leaves(run["recs"][0]["train"][label]["grads"])
    want = tree_leaves(run["one"][1]["grads"])
    for g, w in zip(got, want):
        w = w.numpy()
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), label


@pytest.mark.parametrize("label", LABELS)
def test_mesh_adamw_step_within_the_bar_of_one_process(run, label):
    """The ZeRO-1 step against one process's ``adamw_step`` on the mesh's
    own first gradient: within 1e-3 of ``lr`` where ``|g|`` exceeds 100
    eps, 5e-2 of ``lr`` elsewhere (ROADMAP Queue 3).  Over several steps
    the trajectories part further where ``|g|`` is near eps, which moves
    the next gradients everywhere: the losses hold those steps."""
    rec = run["recs"][0]["train"][label]
    first = run["one"][1]
    grads = tree_map(torch.from_numpy, rec["grads"])
    optc = OptConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=STEPS)
    params, _, mets = adamw_step(grads, first["opt"], optc,
                                 params_like=first["params"])
    lr = float(mets["lr"])
    for g, got, want in zip(tree_leaves(grads), tree_leaves(rec["first"]),
                            tree_leaves(params)):
        d = np.abs(got - want.numpy())
        big = g.abs().numpy() > 100 * 1e-8
        assert d[big].max(initial=0) <= 1e-3 * lr, label
        assert d.max() <= 5e-2 * lr, label


@pytest.mark.parametrize("label", LABELS)
def test_zero1_blocks_have_the_reference_zero1_shapes(run, label):
    shape = dict(zip(("data", "model"), map(int, label.split("x"))))
    mesh = type("Mesh", (), {"shape": shape})()
    ctx = JaxCtx(mesh, jax_rules(False, run["jcfg"]))
    specs = jlm.model_specs(run["jcfg"])
    abstract = jmod.abstract(specs)
    zero1 = jax_zero1(jax_specs(ctx, specs, abstract), abstract,
                      run["jcfg"], ctx)
    want = {}
    for (kp, spec), leaf in zip(
            jax.tree_util.tree_flatten_with_path(
                zero1, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0],
            jax.tree_util.tree_leaves(abstract)):
        key = "/".join(k.key for k in kp)
        dims = list(spec) + [None] * (len(leaf.shape) - len(spec))
        want[key] = tuple(
            n // int(np.prod([shape[a] for a in
                              ((e,) if isinstance(e, str) else e or ())]))
            for n, e in zip(leaf.shape, dims))
    sharded = 0
    for rank, rec in enumerate(run["recs"]):
        for part in ("master", "m", "v"):
            assert rec["train"][label]["zero1"][part] == want, (label, rank)
        sharded += sum(w != tuple(a.shape) for w, a in
                       zip(want.values(), jax.tree_util.tree_leaves(
                           abstract)))
    assert sharded > 0 or shape["data"] == 1


def test_sharded_batch_rows_equal_the_reference_host_batch(run):
    want = jax_batch(JaxData(vocab=run["jcfg"].vocab, seq_len=S,
                             global_batch=B), 1)
    for label in LABELS:
        n = B // int(label.split("x")[0])
        for rank, rec in enumerate(run["recs"]):
            got = rec["train"][label]["rows"]
            r0 = rec["train"][label]["coord"]["data"] * n
            for k in ("tokens", "labels", "mask"):
                assert np.array_equal(got[k], want[k][r0:r0 + n]), \
                    (label, rank, k)
                assert got[k].dtype == want[k].dtype


def test_microbatch_equals_the_full_batch(run):
    for rank, rec in enumerate(run["recs"]):
        m = rec["micro"]
        assert abs(m["loss"] - m["loss_micro"]) < 1e-5, rank
        assert m["master_excess"] <= 0, rank


def test_elastic_restore_onto_another_mesh(run):
    for rank, rec in enumerate(run["recs"]):
        e = rec["elastic"]
        assert len(e["resumed"]) == 2 and e["step"] == STEPS, rank
        np.testing.assert_allclose(e["resumed"], e["straight"][2:],
                                   rtol=1e-4, atol=1e-4)
        # the restored master blocks are (4, 1)'s
        assert e["master"] == rec["train"]["4x1"]["zero1"]["master"], rank


def test_compressed_gradients_against_the_oracle(run):
    recs = run["recs"]
    for rank, rec in enumerate(recs):
        c = rec["compressed"]
        assert c["bf16"]["worst"] <= 1.0, rank        # bf16 ulps
        assert c["int8"]["worst"] == 0.0, rank
        assert c["bf16"]["err_diff"] == 0.0 and \
            c["int8"]["err_diff"] == 0.0, rank
        assert c["bf16"]["loss"] == pytest.approx(recs[0]["compressed"][
            "bf16"]["loss"], rel=1e-6)
    c = recs[0]["compressed"]
    # one process's per-shard gradients against the reference's
    for mine, ref in zip(c["shard_grads"], run["shard_grads"]):
        for a, b in zip(tree_leaves(mine), jax.tree_util.tree_leaves(ref)):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    # g_hat against the reference's reduction of the reference's gradients:
    # each q_i may sit a bf16 ulp (an int8 step) away, and the reference's
    # bf16 psum may round each of its three partial sums (half an ulp of
    # at most sum |q_i| each)
    mags = [sum(np.abs(np.asarray(leaves[i])) for leaves in
                (jax.tree_util.tree_leaves(g) for g in run["shard_grads"]))
            for i in range(len(tree_leaves(c["bf16"]["g_hat"])))]
    for i, (got, want) in enumerate(zip(
            tree_leaves(c["bf16"]["g_hat"]),
            jax.tree_util.tree_leaves(run["ref_hat"]["bf16"]))):
        tol = 5 * 2.0 ** -8 * mags[i] / 4 + 2.0 ** -7 * np.abs(want)
        assert np.all(np.abs(got - want) <= tol + 1e-30), i
    for i, (got, want) in enumerate(zip(
            tree_leaves(c["int8"]["g_hat"]),
            jax.tree_util.tree_leaves(run["ref_hat"]["int8"]))):
        scale = mags[i].max() / 127.0
        assert np.abs(got - want).max() <= 2 * scale, i


def test_moe_tensor_parallel_against_the_reference_per_shard(run):
    m = run["moe"]
    top = max(np.abs(v).max() for v in m["local"].values())
    for rank, rec in enumerate(run["recs"]):
        t = rec["moe_tp"]
        r0, n = t["rows"]
        want = m["local"][r0 // n]
        assert np.abs(t["out"] - want).max() <= 1e-5 * top, rank
        assert t["one_out"] <= 1e-5 * top, rank
        for key in ("gx_err", "w_err", "router_err"):
            assert t[key] <= 1e-5, (rank, key, t[key])


def test_moe_expert_parallel_against_the_reference(run):
    m = run["moe"]
    router = 0.0
    for rank, rec in enumerate(run["recs"]):
        t = rec["moe_ep"]
        r0, n = t["rows"]
        assert t["experts"][0] == 1, rank           # one expert a rank
        assert np.abs(t["out"] - m["out"][r0:r0 + n]).max() < 1e-4, rank
        assert np.abs(t["gx"] - m["gx"][r0:r0 + n]).max() < 1e-4, rank
        for key in ("w_gate", "w_up", "w_down"):
            want = m["gp"][key][rank:rank + 1]
            assert np.abs(t["grads"][key] - want).max() <= \
                1e-4 * np.abs(want).max(), (rank, key)
        router = router + t["grads"]["router"]
    want = m["gp"]["router"]
    assert np.abs(router - want).max() <= 1e-4 * np.abs(want).max()


def _losses(text):
    return [float(v) for v in re.findall(r"\[train\] step \d+ loss ([\d.]+)",
                                         text)]


def test_train_cli_on_a_mesh_prints_one_ranks_losses():
    args = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "8",
            "--seq", "32"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args, "--data",
         "2", "--model", "2"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[train] mesh 2x2 (data x model): 4 gloo ranks on cpu" in \
        proc.stdout
    mesh = _losses(proc.stdout)
    assert len(mesh) == 3, proc.stdout       # rank 0 alone prints
    assert "collectives" in proc.stdout
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert train_cli.main(args) == 0
    one = _losses(out.getvalue())
    # bf16 (the CLI's dtype): TRAIN_TOL["loss_bf16"]
    np.testing.assert_allclose(mesh, one, rtol=1e-2)
