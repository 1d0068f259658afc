"""The port's sanitized pool (``CachePool(checkify=True)``) against the
reference's ``checkify`` mode (``tests/test_paged_pool.py`` and
``tests/test_faults.py``): the clean refcount walk passes (state for
state the reference's), a copy-on-write violation and a device double free
raise naming their check, a double release stays a no-op; with the flag
off every transition dispatches the same aten ops as a pool built without
it (and none of the checks' ops), a checked transition dispatches no host
read (``aten::_local_scalar_dense``); an engine with ``checkify=True``
gives the same tokens as one without, and a planted violation raises at
the next token read."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_config
from repro.serving import CachePool as JaxPool
from repro.serving.cache_pool import checkified_raw as jax_checkified_raw

from repro_torch.configs import get_config as torch_config
from repro_torch.core.sparse_kv import CHECKS
from repro_torch.serving import ContinuousEngine, SamplingParams
from repro_torch.serving.cache_pool import (CachePool, PoolCheckError,
                                            checkified, checkified_raw)

from torch_parity import configs, sparse_params


def _cfgs():
    kw = dict(kv_k_sparsity=0.0, kv_v_sparsity=0.0, kv_tail=16)
    return (dataclasses.replace(jax_config("qwen3-0.6b").reduced(), **kw),
            dataclasses.replace(torch_config("qwen3-0.6b").reduced(), **kw))


def _pools(checkify=True):
    jcfg, tcfg = _cfgs()
    kw = dict(slots=3, max_tokens=64, bs=16, paged=True, checkify=checkify)
    return (JaxPool.build(jcfg, **kw),
            CachePool.build(tcfg, device="cpu", **kw))


def _jax_checked(fn):
    checked = jax.jit(jax_checkified_raw(fn))

    def run(*args):
        err, out = checked(*args)
        err.throw()
        return dict(out)
    return run


def _fill(state, fill):
    """Set the tail lengths (and advance ``pos``) of a port state."""
    fill = torch.tensor(fill, dtype=torch.int32)
    state["tail_len"].copy_(fill)
    state["pos"] += fill


def test_checkify_clean_refcount_walk():
    """Freeze twice, admit on a hit, diverge copy-on-write, batched
    release: every check is live and none fires; refcounts and tables
    follow the reference's sanitized pool step for step."""
    jpool, pool = _pools()
    assert pool.checkify and jpool.checkify
    tb = pool.tail // pool.bs
    jstate, state = jpool.init_state(), pool.init_state()
    assert state["err"].tolist() == [0]
    jref, jass, jrel = (_jax_checked(jpool.refreeze),
                        _jax_checked(jpool.assign_blocks),
                        _jax_checked(jpool.release))
    ref, ass, rel = (checkified(pool.refreeze), checkified(pool.assign_blocks),
                     checkified(pool.release))

    def same():
        for k in ("refcount", "table", "pos", "prefix_blocks", "tail_len"):
            assert state[k].tolist() == np.asarray(jstate[k]).tolist(), k

    for newpage in range(2):
        fill = jnp.asarray([16, 0, 0], jnp.int32)
        jstate = dict(jstate, tail_len=fill, pos=jstate["pos"] + fill)
        _fill(state, [16, 0, 0])
        ids = np.zeros((pool.slots, tb), np.int32)
        ids[0] = [newpage]
        jstate = jref(jstate, jnp.asarray(ids))
        ref(state, ids.astype(np.int64))
        same()
    pad = np.zeros(pool.max_blocks, np.int32)
    pad[:2] = [0, 1]
    jstate = jass(jstate, jnp.int32(1), jnp.asarray(pad), jnp.int32(2))
    ass(state, [1], pad.astype(np.int64), [2])
    same()
    fill = jnp.asarray([0, 16, 0], jnp.int32)
    jstate = dict(jstate, tail_len=fill, pos=jstate["pos"] + fill)
    _fill(state, [0, 16, 0])
    ids = np.zeros((pool.slots, tb), np.int32)
    ids[1] = [2]
    jstate = jref(jstate, jnp.asarray(ids))
    ref(state, ids.astype(np.int64))
    same()
    vec = np.full(pool.slots, -1, np.int32)
    vec[:2] = [0, 1]
    jstate = jrel(jstate, jnp.asarray(vec))
    rel(state, vec)
    same()
    assert int(state["refcount"].sum()) == 0
    assert state["err"].tolist() == [0]


def test_geometry_and_nbytes_match_the_reference():
    """The snapshot geometry and the pool's bytes are the reference's (the
    sanitized pool adds its 4-byte error word)."""
    for chk in (False, True):
        jpool, pool = _pools(checkify=chk)
        assert pool.geometry() == jpool.geometry()
        assert pool.nbytes() == jpool.nbytes() + 4 * chk


def test_checkify_catches_cow_violation():
    """Refreezing onto a page another slot still references is the
    copy-on-write violation the sanitized mode exists to catch."""
    _, pool = _pools()
    tb = pool.tail // pool.bs
    state = pool.init_state()
    ref = checkified(pool.refreeze)
    _fill(state, [16, 0, 0])
    ref(state, np.zeros((pool.slots, tb), np.int64))   # slot 0 -> page 0
    _fill(state, [0, 16, 0])
    with pytest.raises(PoolCheckError, match="already referenced") as ei:
        ref(state, np.zeros((pool.slots, tb), np.int64))  # page 0 again
    assert "underflow" not in str(ei.value)
    assert state["err"].tolist() == [0]          # raised once, then cleared


def test_checkify_catches_release_underflow():
    _, pool = _pools()
    state = pool.init_state()
    state["prefix_blocks"].copy_(torch.tensor([1, 0, 0]))
    state["table"][0, 0] = 3
    state["pos"].copy_(torch.tensor([16, 0, 0]))
    # refcount[3] left at 0: a device-side double free
    with pytest.raises(PoolCheckError, match="underflow"):
        checkified(pool.release)(state, 0)


@pytest.mark.parametrize("what", ["range", "n", "overflow"])
def test_checkify_names_each_check(what):
    """The other checks, each with its reference message."""
    _, pool = _pools()
    tb = pool.tail // pool.bs
    state = pool.init_state()
    if what == "range":
        _fill(state, [16, 0, 0])
        ids = np.zeros((pool.slots, tb), np.int64)
        ids[0] = [pool.n_phys]
        call, msg = (lambda: checkified(pool.refreeze)(state, ids),
                     CHECKS[0])
    elif what == "n":
        call, msg = (lambda: checkified(pool.assign_blocks)(
            state, [0], np.zeros(pool.max_blocks, np.int64),
            [pool.max_blocks + 1]), CHECKS[3])
    else:
        state["prefix_blocks"].copy_(torch.tensor([pool.max_blocks, 0, 0]))
        _fill(state, [16, 0, 0])
        call, msg = (lambda: checkified(pool.refreeze)(
            state, np.full((pool.slots, tb), 5, np.int64)), CHECKS[2])
    with pytest.raises(PoolCheckError) as ei:
        call()
    assert msg in str(ei.value)


def test_checkify_flags_nan_written_into_the_pool():
    _, pool = _pools()
    tb = pool.tail // pool.bs
    state = pool.init_state()
    _fill(state, [16, 0, 0])
    state["layers"]["l0"]["kv"]["v_tail"][0, 0, 0, 3, 1] = float("nan")
    with pytest.raises(PoolCheckError, match="NaN was written"):
        checkified(pool.refreeze)(state, np.zeros((pool.slots, tb),
                                                  np.int64))


def test_release_idempotent_under_checkify():
    """Releasing a slot twice does not fire the underflow check: the live
    mask is gated on ``prefix_blocks``, so the second release decrements
    nothing (the device half of the double-release fault site)."""
    _, pool = _pools()
    tb = pool.tail // pool.bs
    state = pool.init_state()
    _fill(state, [16, 0, 0])
    err, _ = checkified_raw(pool.refreeze)(state, np.zeros((pool.slots, tb),
                                                           np.int64))
    assert err is state["err"] and err.tolist() == [0]
    assert int(state["refcount"].sum()) == 1
    vec = np.full(pool.slots, -1, np.int32)
    vec[0] = 0
    release = checkified(pool.release)
    release(state, vec)
    assert int(state["refcount"].sum()) == 0
    release(state, vec)                          # masked no-op, no error
    assert int(state["refcount"].sum()) == 0
    assert state["prefix_blocks"].tolist() == [0, 0, 0]


class _Ops(TorchDispatchMode):
    """Records the aten ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _dispatched(pool):
    """The aten ops of a refreeze, an assignment and a release."""
    tb = pool.tail // pool.bs
    state = pool.init_state()
    _fill(state, [16, 0, 0])
    ids = torch.zeros((pool.slots, tb), dtype=torch.long)
    pad = torch.zeros(pool.max_blocks, dtype=torch.long)
    one = torch.ones(1, dtype=torch.long)
    vec = torch.tensor([0, -1, -1], dtype=torch.int32)
    out = []
    for fn in (lambda: pool.refreeze(state, ids),
               lambda: pool.assign_blocks(state, one, pad, one),
               lambda: pool.release(state, vec)):
        with _Ops() as rec:
            fn()
        out.append(rec.ops)
    return out


def test_checkify_off_dispatches_no_check_ops(monkeypatch):
    """Sanitized mode is opt-in, not a tax: with the flag off every
    transition dispatches exactly the ops of a pool built without it (the
    environment unset), and none of the ops only the checks use."""
    monkeypatch.delenv("REPRO_CHECKIFY", raising=False)
    jcfg, tcfg = _cfgs()
    kw = dict(slots=3, max_tokens=64, bs=16, paged=True, device="cpu")
    default = CachePool.build(tcfg, **kw)
    off = CachePool.build(tcfg, checkify=False, **kw)
    on = CachePool.build(tcfg, checkify=True, **kw)
    assert not default.checkify and not off.checkify and on.checkify
    assert "err" not in off.init_state()
    got, want, checked = _dispatched(off), _dispatched(default), \
        _dispatched(on)
    assert got == want
    for plain, chk in zip(got, checked):
        assert not any("bitwise_or" in op for op in plain)
        assert any("bitwise_or" in op for op in chk)
        assert len(chk) > len(plain)
    assert any("isnan" in op for op in checked[0])
    monkeypatch.setenv("REPRO_CHECKIFY", "1")
    assert CachePool.build(tcfg, **kw).checkify
    monkeypatch.setenv("REPRO_CHECKIFY", "0")
    assert not CachePool.build(tcfg, **kw).checkify


def test_checked_transitions_never_read_the_device():
    """A checked transition ORs its bits on the device: no host read
    (``aten::_local_scalar_dense``) anywhere, so it captures into a graph
    like any other."""
    _, pool = _pools()
    for ops in _dispatched(pool):
        assert not any("_local_scalar_dense" in op for op in ops), ops


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs("float32", kv_k_sparsity=0.3, kv_v_sparsity=0.5,
                         kv_tail=16)
    _, tparams = sparse_params(jcfg, tcfg)
    return tcfg, tparams


def _engine(params, cfg, **kw):
    return ContinuousEngine(params, cfg, slots=2, max_tokens=96, bs=16,
                            prefill_chunk=32, paged=True, device="cpu", **kw)


def _prompts(cfg, n=3):
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.vocab, (48,)).tolist()
    return [shared + rng.integers(0, cfg.vocab, (4 + i,)).tolist()
            for i in range(n)]


@pytest.mark.parametrize("overlap", [False, True])
def test_checked_engine_same_tokens(setup, overlap):
    cfg, params = setup
    sp = SamplingParams(max_new_tokens=20)
    outs = []
    for chk in (False, True):
        eng = _engine(params, cfg, checkify=chk, overlap=overlap)
        assert eng.pool.checkify == chk
        rids = [eng.submit(p, sp) for p in _prompts(cfg)]
        res = eng.run()
        outs.append([list(res[r].token_ids) for r in rids])
        if chk:
            assert eng.state["err"].tolist() == [0]
            assert eng.trace_counts()["refreeze"] == 1
    assert outs[0] == outs[1]


def test_later_guard_names_only_ctx_and_mesh(setup):
    cfg, params = setup
    for kw, name in ((dict(ctx=object()), "ctx"), (dict(mesh=object()),
                                                    "mesh")):
        with pytest.raises(NotImplementedError) as ei:
            _engine(params, cfg, **kw)
        assert name in str(ei.value) and "checkify" not in str(ei.value)


@pytest.mark.parametrize("overlap", [False, True])
def test_planted_violation_raises_at_the_token_read(setup, overlap):
    """Zero the device refcount of a live slot's pages and cancel its
    request: the release underflows on the device, and the next tick's
    token read raises naming the check."""
    cfg, params = setup
    eng = _engine(params, cfg, checkify=True, overlap=overlap)
    sp = SamplingParams(max_new_tokens=30)
    rids = [eng.submit(p, sp) for p in _prompts(cfg, 2)]
    while len([r for r in eng.scheduler.active.values()
               if len(r.generated) > 1]) < 2:
        eng.step()
    victim = eng.scheduler.active[0]
    assert eng._blocks[0]
    eng.state["refcount"][torch.tensor(eng._blocks[0])] = 0
    assert eng.cancel(victim.rid)                # the release runs now
    with pytest.raises(PoolCheckError, match="underflow"):
        for _ in range(4):
            eng.step()
    assert rids
