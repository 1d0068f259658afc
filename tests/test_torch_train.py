"""The port's training stack against the reference on the shared reference
draw (``torch_parity.reference_model``, seed 3, f32):

* ``loss_fn``'s value (relative 1e-5) and every leaf's gradient against
  ``jax.value_and_grad`` (max |diff| at most 1e-4 of the leaf's largest
  |g|) on reduced Qwen3-0.6B, and the loss alone (relative 1e-5) on one
  config of every other family: Phi-3.5-MoE, RWKV-6, Jamba, SeamlessM4T
  (with ``src_embeds``) and InternVL2 (with frontend embeddings);
* one ``make_train_step`` step, with and without ``microbatch=2``:
  params, ``m``, ``v``, ``lr`` and ``grad_norm`` against the reference's
  jitted step;
* ``lr_schedule``, ``global_norm`` and ``adamw_step`` on numpy inputs,
  and ``adamw_step`` keeping a column-major leaf column-major;
* ``compress_and_reduce`` in both schemes, error feedback carried over two
  calls, against the reference's under ``jax.vmap`` over a size-1
  ``"dp"`` axis (its ``psum`` / ``pmax`` then need no mesh), and
  ``make_compressed_grads`` over one process;
* ``iterate`` against the reference's; ``abstract_params`` and
  ``abstract_opt_state`` against the reference's shapes and dtypes;
* the dense kernel's autograd wrapper (``DenseMatmulGrad``) against
  autograd of the plain product, and the ops layer calling it only under
  autograd.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JaxData
from repro.data import host_batch as jax_batch
from repro.data.pipeline import iterate as jax_iterate
from repro.distributed import NULL_CTX
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jcompress
from repro.train import step as jstep

from repro_torch.data.pipeline import DataConfig, iterate
from repro_torch.kernels import ops
from repro_torch.kernels.dense_matmul import (DenseMatmulGrad,
                                              dense_matmul_plain)
from repro_torch.models.module import tree_map
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import grad_compress as tcompress
from repro_torch.train import step as tstep

from torch_parity import as_np, rand, reference_model, to_numpy

B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, b=B, s=S):
    """(reference batch, port batch) of the same numpy arrays: the data
    pipeline's tokens, plus ``src_embeds`` / ``frontend_embeds`` where the
    config takes them."""
    nb = jax_batch(JaxData(vocab=cfg.vocab, seq_len=s, global_batch=b), 0)
    if cfg.family == "encdec":
        nb["src_embeds"] = rand((b, 12, cfg.d_model), 1)
    if cfg.frontend:
        nb["frontend_embeds"] = rand((b, cfg.frontend_tokens, cfg.d_model),
                                     2)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.as_tensor(v) for k, v in nb.items()})


def _assert_tree_close(got, want, rel, what):
    """Every leaf of ``got`` (port) within ``rel`` of ``want``'s
    (reference, numpy) largest magnitude."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_tree_close(got[k], want[k], rel, f"{what}/{k}")
        return
    g, w = as_np(got), np.asarray(want, np.float64)
    assert g.shape == w.shape, what
    bar = rel * max(np.abs(w).max(), 1e-30)
    assert np.abs(g - w).max() <= bar, (what, np.abs(g - w).max(), bar)


def test_loss_and_every_gradient_match_the_reference():
    jcfg, tcfg, jp, tp = reference_model("qwen3-0.6b")
    jb, tb = _batch(jcfg)
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(p, jb, jcfg, NULL_CTX)))(jp)
    got_l, got_g = tstep.value_and_grad(tp, tb, tcfg)
    assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(float(want_l))
    _assert_tree_close(got_g, to_numpy(want_g), 1e-4, "grad")
    # the params were read, not written, and hold no autograd state
    assert not any(t.requires_grad for t in
                   tp["blocks"]["l0"]["mixer"].values())


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b", "rwkv6-7b",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-medium", "internvl2-1b"])
def test_every_family_loss_matches_the_reference(name):
    jcfg, tcfg, jp, tp = reference_model(name)
    jb, tb = _batch(jcfg)
    want = float(jax.jit(lambda p: jstep.loss_fn(p, jb, jcfg, NULL_CTX))(jp))
    with torch.no_grad():
        got = float(tstep.loss_fn(tp, tb, tcfg))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.fixture(scope="module")
def stepped():
    """One step of the reference and of the port from the same params and
    opt state, without and with ``microbatch=2`` (batch 4)."""
    jcfg, tcfg, jp, tp = reference_model("qwen3-0.6b")
    jb, tb = _batch(jcfg, b=4)
    optc = jadamw.OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
    toptc = tadamw.OptConfig(**dataclasses.asdict(optc))
    out = {}
    for mb in (None, 2):
        want = jax.jit(jstep.make_train_step(jcfg, NULL_CTX, optc,
                                             microbatch=mb))(
            jp, jadamw.init_opt_state(jp), jb)
        got = tstep.make_train_step(tcfg, toptc, microbatch=mb)(
            tp, tadamw.init_opt_state(tp), tb)
        out[mb] = (want, got)
    return out


@pytest.mark.parametrize("mb", [None, 2], ids=["full", "microbatch2"])
def test_train_step_matches_the_reference(stepped, mb):
    (wp, wo, wm), (gp, go, gm) = stepped[mb]
    for key in ("loss", "grad_norm"):
        assert abs(float(gm[key]) - float(wm[key])) <= \
            1e-5 * abs(float(wm[key])), key
    assert float(gm["lr"]) == pytest.approx(float(wm["lr"]), rel=1e-7)
    assert int(go["step"]) == int(wo["step"]) == 1
    # moments to 1e-4 of each leaf's range (gradient rounding).  A first
    # step moves each weight by lr * g / (|g| + eps) (plus the decay): by
    # about lr, the sign of its gradient, wherever |g| is well above eps.
    # There the new params and master agree to 1e-3 of lr; where |g| is
    # within 100 eps of zero the step is a steep function of g's last bits
    # (measured up to 1.7e-2 of lr), held to 5e-2 of lr
    _assert_tree_close(go["m"], to_numpy(wo["m"]), 1e-4, "m")
    _assert_tree_close(go["v"], to_numpy(wo["v"]), 1e-4, "v")
    lr = float(wm["lr"])
    g_ref = [np.abs(m) / (1 - 0.9) for m in
             jax.tree_util.tree_leaves(to_numpy(wo["m"]))]
    for got, want in ((gp, wp), (go["master"], wo["master"])):
        leaves = zip(jax.tree_util.tree_leaves(to_numpy(want)),
                     jax.tree_util.tree_leaves(tree_map(as_np, got)), g_ref)
        for w, g, gr in leaves:
            d = np.abs(g - w)
            assert d[gr > 100 * 1e-8].max(initial=0) <= 1e-3 * lr
            assert d.max() <= 5e-2 * lr


def test_microbatches_equal_the_full_batch(stepped):
    (_, _, _), (gp, go, gm) = stepped[None]
    (_, _, _), (mp, mo, mm) = stepped[2]
    assert abs(float(gm["loss"]) - float(mm["loss"])) < 1e-5
    for a, b in zip(jax.tree_util.tree_leaves(tree_map(as_np, go["m"])),
                    jax.tree_util.tree_leaves(tree_map(as_np, mo["m"]))):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max())


def test_lr_schedule_global_norm_and_adamw_match_the_reference():
    optc = jadamw.OptConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100,
                            weight_decay=0.1, clip_norm=1.0)
    toptc = tadamw.OptConfig(**dataclasses.asdict(optc))
    for s in (0, 3, 10, 11, 57, 100, 140):
        assert float(tadamw.lr_schedule(toptc, s)) == pytest.approx(
            float(jadamw.lr_schedule(optc, jnp.asarray(s))), rel=1e-7,
            abs=1e-12)
    params = {"a": rand((3, 5), 0), "b": {"c": rand((7,), 1)}}
    grads = {"a": 3 * rand((3, 5), 2), "b": {"c": rand((7,), 3)}}
    tp = tree_map(torch.tensor, params)
    tg = tree_map(torch.tensor, grads)
    assert float(tadamw.global_norm(tg)) == pytest.approx(
        float(jadamw.global_norm(grads)), rel=1e-6)
    js, ts = jadamw.init_opt_state(params), tadamw.init_opt_state(tp)
    for _ in range(3):          # state carried: step, moments, master
        jparams, js, jm = jadamw.adamw_step(grads, js, optc, params)
        tparams, ts, tm = tadamw.adamw_step(tg, ts, toptc, tp)
    assert int(ts["step"]) == 3
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    for key in ("m", "v", "master"):
        _assert_tree_close(ts[key], to_numpy(js[key]), 1e-6, key)
    _assert_tree_close(tparams, to_numpy(jparams), 1e-6, "params")


def test_adamw_keeps_each_leaf_dtype_and_layout():
    """A column-major bf16 leaf (a dense linear as ``params_to`` stores it
    for the kernel) stays column-major bf16; an f32 norm scale stays f32;
    nothing the step was given is written."""
    w = torch.randn(4, 8, 6).to(torch.bfloat16).transpose(1, 2).contiguous(
        ).transpose(1, 2)                               # [4, 8, 6], K-major
    params = {"w": w, "ln": torch.ones(6)}
    grads = {"w": torch.randn(4, 8, 6).to(torch.bfloat16),
             "ln": torch.randn(6)}
    state = tadamw.init_opt_state(params)
    before = w.clone()
    for _ in range(2):
        params, state, _ = tadamw.adamw_step(grads, state,
                                             tadamw.OptConfig(), params)
        assert params["w"].dtype == torch.bfloat16
        assert params["w"].stride() == w.stride()
        assert params["ln"].dtype == torch.float32
    assert torch.equal(w, before)
    assert state["master"]["w"].stride() == w.stride()


@pytest.mark.parametrize("scheme", ["bf16", "int8"])
def test_compress_and_reduce_matches_the_reference(scheme):
    grads = {"a": rand((6, 10), 0), "b": {"c": 1e-3 * rand((33,), 1)}}
    err0 = jcompress.init_error_state(grads)

    def ref(g, e):
        return jcompress.compress_and_reduce(g, e, ("dp",), scheme)
    over_dp = jax.vmap(ref, axis_name="dp")
    lift = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None],
                                            t)
    j_err, t_err = err0, tcompress.init_error_state(
        tree_map(torch.tensor, grads))
    for i in range(2):                        # error feedback carried over
        g = tree_map(lambda a: a * (1.0 + i), grads)
        j_hat, j_err = over_dp(lift(g), lift(j_err))
        j_hat, j_err = (jax.tree_util.tree_map(lambda a: a[0], t)
                        for t in (j_hat, j_err))
        t_hat, t_err = tcompress.compress_and_reduce(
            tree_map(torch.tensor, g), t_err, (), scheme)
        _assert_tree_close(t_hat, to_numpy(j_hat), 1e-6, "g_hat")
        _assert_tree_close(t_err, to_numpy(j_err), 1e-6, "err")
    with pytest.raises(NotImplementedError, match="item 3"):
        tcompress.compress_and_reduce(t_hat, t_err, ("dp",), scheme)


def test_compressed_grads_over_one_process():
    jcfg, tcfg, jp, tp = reference_model("qwen3-0.6b")
    _, tb = _batch(jcfg)
    fn = tstep.make_compressed_grads(tcfg, "bf16")
    err = tstep.init_dp_error_state(tp)
    loss, g_hat, new_err = fn(tp, err, tb)
    want_l, want_g = tstep.value_and_grad(tp, tb, tcfg)
    assert float(loss) == float(want_l)
    q = tree_map(lambda g: g.float().to(torch.bfloat16).float(), want_g)
    _assert_tree_close(g_hat, tree_map(as_np, q), 0.0, "g_hat")
    _assert_tree_close(tree_map(lambda e: e[0], new_err),
                       tree_map(lambda g, h: as_np(g.float() - h), want_g,
                                q), 0.0, "err")
    assert tree_map(lambda e: e.shape[0], new_err)["final_norm"] == 1
    with pytest.raises(ValueError, match="DP-replicated"):
        tstep.make_compressed_grads(dataclasses.replace(tcfg, fsdp=True))
    with pytest.raises(NotImplementedError, match="item 3"):
        tstep.make_compressed_grads(tcfg, mesh=object())


def test_abstract_params_and_opt_state_match_the_reference():
    """Meta tensors of the reference's shapes and dtypes, leaf for leaf."""
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm
    jcfg, tcfg, _, _ = reference_model("jamba-1.5-large-398b")
    jp = jlm.abstract_params(jcfg)
    tp = tlm.abstract_params(tcfg)
    want = {"params": jp, **jadamw.abstract_opt_state(jp)}
    got = {"params": tp, **tadamw.abstract_opt_state(tp)}
    # jax flattens both trees in sorted key order
    pairs = zip(jax.tree_util.tree_leaves(want),
                jax.tree_util.tree_leaves(got))
    for w, g in pairs:
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert len(jax.tree_util.tree_leaves(want)) == \
        len(jax.tree_util.tree_leaves(got))


def test_iterate_matches_the_reference():
    jdc = JaxData(vocab=512, seq_len=24, global_batch=3)
    tdc = DataConfig(vocab=512, seq_len=24, global_batch=3)
    for a, b, _ in zip(jax_iterate(jdc, 5), iterate(tdc, 5), range(3)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_dense_kernel_under_autograd():
    """``DenseMatmulGrad`` (here on the kernel's plain version, as on the
    CPU) gives autograd's gradients of the plain product, each in its
    operand's dtype; ``dw`` comes back as ``[N, K]`` rows, the column-major
    layout of the ``[K, N]`` weight.  The ops layer takes it only under
    autograd, f32 and bf16, with an f32 output (the head)."""
    for dt, out_dt in ((torch.float32, None), (torch.bfloat16, None),
                       (torch.bfloat16, torch.float32)):
        x = torch.randn(5, 16).to(dt).requires_grad_()
        w = torch.randn(16, 24).to(dt).t().contiguous().t().requires_grad_()
        dy = torch.randn(5, 24).to(out_dt or dt)
        out = ops.dense_matmul(x, w, out_dt)
        # the output is a view (the leading dims restored) of the Function's
        assert "DenseMatmulGrad" in type(
            out.grad_fn.next_functions[0][0]).__name__
        gx, gw = torch.autograd.grad(out, (x, w), dy)
        x2, w2 = (t.detach().clone().requires_grad_() for t in (x, w))
        ref = dense_matmul_plain(x2, w2.t(), out_dt)
        rx, rw = torch.autograd.grad(ref, (x2, w2), dy)
        assert gx.dtype == dt and gw.dtype == dt
        assert gw.stride() == w.stride()
        tol = 1e-5 if dt == torch.float32 else 2e-2
        for g, r in ((gx, rx), (gw, rw)):
            np.testing.assert_allclose(as_np(g), as_np(r), rtol=tol,
                                       atol=tol)
        with torch.no_grad():
            assert ops.dense_matmul(x, w, out_dt).grad_fn is None
