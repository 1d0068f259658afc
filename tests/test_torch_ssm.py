"""The port's recurrent mixers (``repro_torch/models/ssm.py``: Mamba, as in
Jamba, and RWKV-6) against the reference's ``repro/models/ssm.py``, on the
reduced configs' layer-0 weights drawn by the reference and carried over
by the bridge, with inputs from a numpy seed.

* every function of the module at f32: outputs and states within 1e-5 of
  the reference output's range (the states of their own range);
* the same at bf16 weights and activations, within 2e-2 of the range (the
  two frameworks round the bf16 products and casts at different points);
* the reference's ``_chunked_scan`` takes its plain branch at S = 24 and
  its chunked one at S = 32 (``scan_chunk`` 16): the port's loop equals
  both;
* a prefill of S and one decode step from its state equals a prefill of
  S + 1 at its last row, for each mixer and for the whole RWKV-6 and
  Jamba models through ``forward_prefill`` / ``forward_decode``;
* the helpers (``_shift``, ``_lerp``, the conv, both step functions) and
  the init states equal the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import NULL_CTX
from repro.models import ssm as jssm

from repro_torch import configs as tconfigs
from repro_torch.models import lm, ssm

from torch_parity import as_np, reference_model

TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # of the reference's range
B = 2


def _model(name, dtype):
    """(jax cfg, port cfg, jax params, port params) of a reduced config,
    the reference's draw bridged; drawn once per process
    (``torch_parity.reference_model``)."""
    return reference_model(name, dtype)


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _mixer(name, dtype):
    """Layer 0's mixer params (RWKV's ``tmix``, Jamba's Mamba ``mixer``)."""
    jcfg, tcfg, jp, tp = _model(name, dtype)
    key = "tmix" if name == "rwkv6-7b" else "mixer"
    return (jcfg, tcfg, _layer0(jp["blocks"]["l0"][key]),
            _layer0(tp["blocks"]["l0"][key]))


def _x(shape, seed, dtype):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(got, want, tol, what):
    g, w = as_np(got), as_np(want)
    assert g.shape == w.shape, what
    span = max(w.max() - w.min(), 1e-12)
    err = np.abs(g - w).max() / span
    assert err <= tol, f"{what}: {err:.3e} of the range > {tol}"


def _close_tree(got, want, tol, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close_tree(got[k], want[k], tol, f"{what}/{k}")
    else:
        _close(got, want, tol, what)


# ---------------------------------------------------------------------------
# the full-sequence mixers and the decode steps, f32 and bf16
# ---------------------------------------------------------------------------

_REFS = {}


def _ref(name, jcfg):
    """The reference's ``jssm.<name>`` with ``jcfg`` closed over, jitted
    once per config: one XLA program a shape instead of an eager dispatch
    of every op."""
    if (name, jcfg) not in _REFS:
        fn = getattr(jssm, name)
        if name in ("mamba_apply", "rwkv_time_mix"):
            def call(p, x):
                return fn(p, x, jcfg, NULL_CTX, return_state=True)
        elif name == "rwkv_channel_mix":
            def call(p, x):
                return fn(p, x, jcfg)
        else:                               # the decode steps
            def call(p, x, st):
                return fn(p, x, st, jcfg)
        _REFS[name, jcfg] = jax.jit(call)
    return _REFS[name, jcfg]


def _prefill_mamba(jcfg, tcfg, jp, tp, jx, tx):
    want = _ref("mamba_apply", jcfg)(jp, jx)
    got = ssm.mamba_apply(tp, tx, tcfg, return_state=True)
    return got, want


def _prefill_rwkv(jcfg, tcfg, jp, tp, jx, tx):
    jo, jst = _ref("rwkv_time_mix", jcfg)(jp, jx)
    to, tst = ssm.rwkv_time_mix(tp, tx, tcfg, return_state=True)
    return ((to, ssm.rwkv_channel_mix(tp, tx, tcfg), tst),
            (jo, _ref("rwkv_channel_mix", jcfg)(jp, jx), jst))


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_prefill_mixers_equal_the_reference(name, dtype):
    """``mamba_apply`` (with ``return_state``) or ``rwkv_time_mix`` (with
    ``return_state``) and ``rwkv_channel_mix`` over ``[2, 20, d]``: the
    outputs and the states (Mamba's conv window and SSM state; RWKV's WKV
    state and time-shift row)."""
    jcfg, tcfg, jp, tp = _mixer(name, dtype)
    jx, tx = _x((B, 20, tcfg.d_model), 1, dtype)
    fn = _prefill_rwkv if name == "rwkv6-7b" else _prefill_mamba
    got, want = fn(jcfg, tcfg, jp, tp, jx, tx)
    tol = TOL[dtype]
    if name == "rwkv6-7b":
        _close(got[0], want[0], tol, "time-mix out")
        _close(got[1], want[1], tol, "channel-mix out")
        _close_tree(got[2], want[2], tol, "state")
    else:
        _close(got[0], want[0], tol, "out")
        _close_tree(got[1], want[1], tol, "state")


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_decode_steps_equal_the_reference(name, dtype):
    """``mamba_decode`` or ``rwkv_time_mix_decode`` then
    ``rwkv_channel_mix_decode`` from a seeded (non-zero) state, three steps
    chained: every output and every new state."""
    jcfg, tcfg, jp, tp = _mixer(name, dtype)
    rng = np.random.default_rng(2)
    init = (ssm.rwkv_init_state if name == "rwkv6-7b"
            else ssm.mamba_init_state)(tcfg, B)
    st_np = {k: (rng.normal(size=v.shape) * 0.1).astype(np.float32)
             for k, v in init.items()}
    jst = {k: jnp.asarray(v) for k, v in st_np.items()}
    tst = {k: torch.from_numpy(v) for k, v in st_np.items()}
    for step in range(3):
        jx, tx = _x((B, tcfg.d_model), 10 + step, dtype)
        if name == "rwkv6-7b":
            jo, jst = _ref("rwkv_time_mix_decode", jcfg)(jp, jx, jst)
            to, tst = ssm.rwkv_time_mix_decode(tp, tx, tst, tcfg)
            jo2, jst = _ref("rwkv_channel_mix_decode", jcfg)(jp, jx, jst)
            to2, tst = ssm.rwkv_channel_mix_decode(tp, tx, tst, tcfg)
            _close(to2, jo2, TOL[dtype], f"step {step} channel-mix out")
        else:
            jo, jst = _ref("mamba_decode", jcfg)(jp, jx, jst)
            to, tst = ssm.mamba_decode(tp, tx, tst, tcfg)
        _close(to, jo, TOL[dtype], f"step {step} out")
        _close_tree(tst, jst, TOL[dtype], f"step {step} state")


@pytest.mark.parametrize("s", [24, 32], ids=["plain-scan", "chunked-scan"])
@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_both_branches_of_the_chunked_scan(name, s):
    """``scan_chunk`` is 16 in the reduced configs: the reference scans
    S = 24 plainly (``t % chunk != 0``) and S = 32 in two remat'd chunks;
    the port's one loop equals either, f32, state included."""
    jcfg, tcfg, jp, tp = _mixer(name, "float32")
    assert tcfg.scan_chunk == jcfg.scan_chunk == 16
    jx, tx = _x((B, s, tcfg.d_model), 3, "float32")
    fn = _prefill_rwkv if name == "rwkv6-7b" else _prefill_mamba
    got, want = fn(jcfg, tcfg, jp, tp, jx, tx)
    _close(got[0], want[0], TOL["float32"], "out")
    _close_tree(got[-1], want[-1], TOL["float32"], "state")


# ---------------------------------------------------------------------------
# state carry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_state_carries_a_prefill_into_the_decode(name):
    """The port alone, f32: a prefill of S = 12 (S >= d_conv) and one
    decode step of token S from its state equal a prefill of S + 1 at its
    last row (1e-5 of the range), for the mixers (RWKV: time-mix, then the
    channel mix on the same input)."""
    _, tcfg, _, tp = _mixer(name, "float32")
    _, tx = _x((B, 13, tcfg.d_model), 4, "float32")
    s = 12
    if name == "rwkv6-7b":
        full = ssm.rwkv_time_mix(tp, tx, tcfg)[:, s]
        full_c = ssm.rwkv_channel_mix(tp, tx, tcfg)[:, s]
        _, st = ssm.rwkv_time_mix(tp, tx[:, :s], tcfg, return_state=True)
        st = {**st, "cm_x": tx[:, s - 1].float()}
        step, st = ssm.rwkv_time_mix_decode(tp, tx[:, s], st, tcfg)
        step_c, _ = ssm.rwkv_channel_mix_decode(tp, tx[:, s], st, tcfg)
        _close(step_c, full_c, TOL["float32"], "channel mix")
    else:
        full = ssm.mamba_apply(tp, tx, tcfg)[:, s]
        _, st = ssm.mamba_apply(tp, tx[:, :s], tcfg, return_state=True)
        step, _ = ssm.mamba_decode(tp, tx[:, s], st, tcfg)
    _close(step, full, TOL["float32"], "mixer")


@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_model_decode_continues_the_prefill(name):
    """The whole model, f32, KV sparsity 0 and the dense KV cache: the
    one-shot prefill of S tokens and one ``forward_decode`` of token S
    (the states written in place into the cache) give the logits of a
    prefill of S + 1 at its last row, within 1e-5 of their range."""
    from repro_torch.serving import Engine
    _, tcfg, _, tp = _model(name, "float32")
    cfg = dataclasses.replace(tcfg, kv_k_sparsity=0.0, kv_v_sparsity=0.0)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, 17)))
    eng = Engine(tp, cfg, kv_mode="dense", device="cpu")
    cache, _ = eng.prefill({"tokens": toks[:, :16]})
    state0 = {n: {k: v.clone() for k, v in leaf["state"].items()}
              for n, leaf in cache["layers"].items() if "state" in leaf}
    got, cache = lm.forward_decode(eng.params, cache, toks[:, 16:], cfg)
    h, _ = lm.forward_prefill(eng.params, {"tokens": toks}, cfg)
    want = lm.logits_fn(eng.params, h[:, -1:], cfg)[:, 0]
    _close(got, want, TOL["float32"], "logits")
    assert int(cache["pos"]) == 17
    for n, st in state0.items():
        assert any(not torch.equal(st[k], cache["layers"][n]["state"][k])
                   for k in st), f"{n}'s state was not written in place"


# ---------------------------------------------------------------------------
# helpers and init states
# ---------------------------------------------------------------------------

def test_helpers_equal_the_reference():
    """``_shift``, ``_lerp``, ``_mamba_conv_train``, ``_mamba_step`` and
    ``_rwkv_step`` on seeded f32 inputs, within 1e-6 of the range."""
    rng = np.random.default_rng(6)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    x, w, b = r(2, 9, 16), r(4, 16), r(16)
    pairs = [(ssm._shift(torch.from_numpy(x)), jssm._shift(jnp.asarray(x))),
             (ssm._lerp(torch.from_numpy(x), torch.from_numpy(x[::-1].copy()),
                        torch.from_numpy(b)),
              jssm._lerp(jnp.asarray(x), jnp.asarray(x[::-1]),
                         jnp.asarray(b))),
             (ssm._mamba_conv_train(*map(torch.from_numpy, (x, w, b))),
              jssm._mamba_conv_train(*map(jnp.asarray, (x, w, b))))]
    h, xs, a, d = r(2, 16, 4), (r(2, 16), r(2, 16), r(2, 4), r(2, 4)), \
        r(16, 4), r(16)
    pairs += list(zip(
        ssm._mamba_step(torch.from_numpy(h), tuple(map(torch.from_numpy, xs)),
                        torch.from_numpy(a), torch.from_numpy(d)),
        jssm._mamba_step(jnp.asarray(h), tuple(map(jnp.asarray, xs)),
                         jnp.asarray(a), jnp.asarray(d))))
    st, xs, u = r(2, 3, 8, 8), tuple(r(2, 3, 8) for _ in range(4)), r(3, 8)
    pairs += list(zip(
        ssm._rwkv_step(torch.from_numpy(st), tuple(map(torch.from_numpy, xs)),
                       torch.from_numpy(u)),
        jssm._rwkv_step(jnp.asarray(st), tuple(map(jnp.asarray, xs)),
                        jnp.asarray(u))))
    for i, (got, want) in enumerate(pairs):
        _close(got, want, 1e-6, f"helper {i}")


@pytest.mark.parametrize("name", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_specs_and_init_states_equal_the_reference(name):
    """At full width (nothing allocated) the mixer's specs have the
    reference's shapes and dtypes; the init states at the reduced width
    are zeros of the reference's shapes and dtypes."""
    j, t = jconfigs.get_config(name), tconfigs.get_config(name)
    jf, tf = ((jssm.rwkv_specs, ssm.rwkv_specs) if name == "rwkv6-7b"
              else (jssm.mamba_specs, ssm.mamba_specs))
    js, ts = jf(j), tf(t)
    assert list(ts) == list(js)
    for k in js:
        assert tuple(ts[k].shape) == tuple(js[k].shape), k
        assert str(ts[k].dtype).split(".")[-1] == np.dtype(js[k].dtype).name, k
        assert ts[k].init == js[k].init and ts[k].axes == tuple(js[k].axes)
    jr, tr = j.reduced(), t.reduced()
    ji, ti = ((jssm.rwkv_init_state(jr, 3), ssm.rwkv_init_state(tr, 3))
              if name == "rwkv6-7b" else
              (jssm.mamba_init_state(jr, 3), ssm.mamba_init_state(tr, 3)))
    assert set(ti) == set(ji)
    for k in ji:
        assert tuple(ti[k].shape) == tuple(ji[k].shape)
        assert ti[k].dtype == torch.float32 and not ti[k].any()


def test_attention_free_engine_decodes_past_the_tail():
    """RWKV-6 holds no KV cache, so its one-shot engine decodes past
    ``kv_tail`` in either KV mode (a dense cache's length limit binds
    attention layers only): 24 greedy tokens at a 16-token tail, f32, the
    same in both modes."""
    from repro_torch.serving import Engine, SamplingParams
    _, tcfg, _, tp = _model("rwkv6-7b", "float32")
    tcfg = dataclasses.replace(tcfg, kv_tail=16)
    toks = np.random.default_rng(9).integers(0, tcfg.vocab, (B, 8))
    got = [Engine(tp, tcfg, kv_mode=mode, device="cpu").generate(
        {"tokens": toks}, SamplingParams(max_new_tokens=24))[0]
        for mode in ("dense", "sparse")]
    assert got[0].shape == (B, 24) and torch.equal(got[0], got[1])
