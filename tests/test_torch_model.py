"""The port's pooled forwards against the reference on reduced Qwen3 at
f32 with bridged weights (reference init and packing): chunked prefill
with freeze and tail remainder, then decode ticks and a query panel over
the same pool state.  Logits within 1e-4 of the reference (XLA backend)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.distributed import NULL_CTX
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.serving.cache_pool import CachePool as JaxPool

from repro_torch import bridge
from repro_torch.models import lm as tlm

from torch_parity import as_np, configs, sparse_params, to_numpy

BS = 16
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = configs("float32", kv_tail=16)
    jparams, tparams = sparse_params(jcfg, tcfg)
    prefill = jax.jit(lambda p, st, t, s: jlm.forward_prefill_chunk(
        p, st, t, s, jcfg, NULL_CTX, BS))
    panel = jax.jit(lambda p, st, t, m: jlm.forward_panel_pooled(
        p, st, t, m, jcfg, NULL_CTX, BS))
    return jcfg, tcfg, jparams, tparams, prefill, panel


def _bridge(state):
    return bridge.state_from_numpy(to_numpy(state), "cpu")


def _compare_states(ref, got):
    """Lengths exact; tails and compressed storage equal to f32 rounding
    (bitmap words exactly)."""
    for key in ("pos", "prefix_blocks", "tail_len"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    for name, leaf in ref["layers"].items():
        for key, a in leaf["kv"].items():
            g = got["layers"][name]["kv"][key]
            if key.endswith("bitmap"):
                np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                              np.asarray(a))
            else:
                np.testing.assert_allclose(as_np(g), as_np(a), **TOL)


def _prefilled(model, compare):
    """Two slots prefilled chunk by chunk (block-aligned chunks, then a
    remainder); with ``compare`` each chunk is held against the reference
    on the same state."""
    jcfg, tcfg, jparams, tparams, prefill, _ = model
    state = JaxPool.build(jcfg, slots=2, max_tokens=96, bs=BS).init_state()
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 45))
    plan = [(0, 0, 32), (1, 0, 16), (0, 32, 37), (1, 16, 45)]
    for slot, lo, hi in plan:
        chunk = toks[slot:slot + 1, lo:hi]
        ref_logits, new = prefill(jparams, state, jnp.asarray(chunk, jnp.int32),
                                  jnp.int32(slot))
        if not compare:
            state = new
            continue
        got_logits, got = tlm.forward_prefill_chunk(
            tparams, _bridge(state), torch.from_numpy(chunk), slot, tcfg, BS)
        np.testing.assert_allclose(as_np(got_logits), as_np(ref_logits),
                                   **TOL)
        _compare_states(new, got)
        state = new
    return state


@pytest.fixture(scope="module")
def prefilled(model):
    return _prefilled(model, compare=False)


def test_prefill_chunks_match_reference(model):
    state = _prefilled(model, compare=True)
    np.testing.assert_array_equal(np.asarray(state["prefix_blocks"]), [2, 2])
    np.testing.assert_array_equal(np.asarray(state["tail_len"]), [5, 13])


@pytest.mark.parametrize("qn,mask", [(1, [True, True]), (1, [True, False]),
                                     (2, [True, True])],
                         ids=["decode", "masked_slot", "panel_q2"])
def test_panel_forward_matches_reference(model, prefilled, qn, mask):
    jcfg, tcfg, jparams, tparams, _, panel = model
    state = prefilled
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, qn))
    m = np.asarray(mask)
    for _ in range(3):             # consecutive ticks grow the tails
        ref_logits, new = panel(jparams, state, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(m))
        got_logits, got = tlm.forward_panel_pooled(
            tparams, _bridge(state), torch.from_numpy(toks),
            torch.from_numpy(m), tcfg, BS)
        assert got_logits.shape == (2, qn, tcfg.vocab)
        np.testing.assert_allclose(as_np(got_logits)[m], as_np(ref_logits)[m],
                                   **TOL)
        _compare_states(new, got)
        state = new
        toks = np.asarray(jnp.argmax(ref_logits, -1), np.int64)


def test_decode_through_the_pallas_path(model, prefilled):
    """The same comparison with the reference on its Pallas kernels
    (interpret mode) for one decode tick."""
    jcfg, tcfg, jparams, tparams, _, _ = model
    state = prefilled
    toks = np.asarray([[3], [7]])
    m = np.asarray([True, True])
    with jops.backend("interpret"):
        ref_logits, _ = jlm.forward_panel_pooled(
            jparams, state, jnp.asarray(toks, jnp.int32), jnp.asarray(m),
            jcfg, NULL_CTX, BS)
    got_logits, _ = tlm.forward_panel_pooled(
        tparams, _bridge(state), torch.from_numpy(toks), torch.from_numpy(m),
        tcfg, BS)
    np.testing.assert_allclose(as_np(got_logits), as_np(ref_logits), **TOL)


def test_cache_pool_transitions_match_reference(model, prefilled):
    """``append_many`` (masked, past the ring end dropped), ``rollback``
    (clamped to the tail), ``refreeze`` of the slots whose ring is full,
    and a padded ``release``: the port's in-place transitions against the
    reference's pure ones, state for state."""
    from repro_torch.serving.cache_pool import CachePool as TorchPool
    jcfg, tcfg = model[0], model[1]
    jpool = JaxPool.build(jcfg, slots=2, max_tokens=96, bs=BS)
    tpool = TorchPool.build(tcfg, slots=2, max_tokens=96, bs=BS,
                            device="cpu")
    geometry = ("max_blocks", "bs", "tail", "cap_k", "cap_v")
    assert [getattr(tpool, g) for g in geometry] == \
        [getattr(jpool, g) for g in geometry]
    rng = np.random.default_rng(2)
    p = jcfg.n_layers
    shape = (p, 2, jcfg.n_kv, 16, jcfg.hd)

    def panels():
        return {"l0": {"k": rng.normal(size=shape).astype(np.float32),
                       "v": rng.normal(size=shape).astype(np.float32)}}

    state = prefilled                       # tail_len [5, 13]
    steps = [("append_many", (panels(), np.asarray([3, 16], np.int32))),
             ("rollback", (np.asarray([2, 40], np.int32),)),
             ("append_many", (panels(), np.asarray([12, 16], np.int32))),
             ("refreeze", ()),
             ("release", (np.asarray([0, -1], np.int32),))]
    for name, args in steps:
        new = jax.jit(getattr(jpool, name))(state, *(
            jax.tree_util.tree_map(jnp.asarray, a) for a in args))
        got = getattr(tpool, name)(_bridge(state), *(
            jax.tree_util.tree_map(torch.from_numpy, a) for a in args))
        _compare_states(new, got)
        state = new
    # both rings were full after the second append: refreeze folded them,
    # and the release zeroed slot 0
    np.testing.assert_array_equal(np.asarray(state["prefix_blocks"]), [0, 3])
