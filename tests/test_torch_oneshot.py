"""The port's one-shot path (the legacy static-batch ``Engine``, the
``SparseKVCache`` / ``DenseKVCache`` and ``lm.forward_prefill``,
``init_cache`` and ``forward_decode``) against the reference's, mirroring
``tests/test_serving.py`` (Qwen3 only, the port's one config) and
``tests/test_refreeze.py`` at the reduced config: the decode agrees with
the full forward, the sparse and dense caches agree at zero KV sparsity,
the paper's KV sparsity drifts little, sparse and int8 weights stay close;
the legacy freeze, append and refreeze are the reference's bit for bit and
keep attention; ``repack_capacity`` grows and shrinks consistently;
greedy tokens are identical to the JAX ``Engine.generate`` on the bridged
weights at f32, sparse and dense KV, through a refreeze; and the launcher
runs ``--one-shot`` and ``--dense``.  Tolerances are stated at each
check."""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import append_token as jax_append
from repro.core import freeze_prefix as jax_freeze
from repro.core import refreeze as jax_refreeze
from repro.core.sparse_format import pack as jax_pack
from repro.core.sparse_format import repack_capacity as jax_repack
from repro.distributed import NULL_CTX
from repro.models import lm as jlm
from repro.serving import Engine as JaxEngine
from repro.serving import SamplingParams as JaxParams

from repro_torch import bridge
from repro_torch.core.convert import convert_concrete
from repro_torch.core.sparse_format import pack, repack_capacity, unpack
from repro_torch.core.sparse_kv import (SparseKVCache, append_token,
                                        freeze_prefix, maybe_refreeze,
                                        refreeze)
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.attention import DenseKVCache, init_dense_cache
from repro_torch.serving import Engine, SamplingParams

from torch_parity import as_np, configs, rand, sparse_params, to_numpy


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense_params(jcfg, tcfg, seed=0):
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, bridge.params_from_numpy(to_numpy(jparams), tcfg, "cpu")


def _tokens(cfg, seed=0, b=2, s=64):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _engine(params, cfg, mode="sparse"):
    return Engine(params, cfg, kv_mode=mode, device="cpu")


def _logits_at_end(params, cfg, toks):
    """The port's full forward (teacher forcing): last position's logits."""
    h, _ = lm.forward_prefill(params, {"tokens": torch.as_tensor(toks)}, cfg)
    return lm.logits_fn(params, h[:, -1:], cfg)[:, 0]


def test_decode_matches_teacher_forcing():
    """prefill + decode(token t) logits == the full forward's at position
    t, in the port and in the reference (f32, zero KV sparsity): within
    1e-4 of each other and of the JAX full forward."""
    jcfg, tcfg = configs("float32", kv_k_sparsity=0.0, kv_v_sparsity=0.0)
    jparams, params = _dense_params(jcfg, tcfg)
    toks = _tokens(tcfg)
    eng = _engine(params, tcfg)
    cache, logits = eng.prefill({"tokens": toks})
    h = jlm.forward_train(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                          NULL_CTX)
    ref = jlm.logits_fn(jparams, h, jcfg, NULL_CTX)[:, -1]
    np.testing.assert_allclose(as_np(logits), as_np(ref), atol=1e-4)
    np.testing.assert_allclose(as_np(logits),
                               as_np(_logits_at_end(params, tcfg, toks)),
                               atol=1e-5)
    toks2 = np.concatenate([toks, toks[:, -1:]], axis=1)
    dec, _ = lm.forward_decode(eng.params, cache,
                               torch.as_tensor(toks[:, -1:]), tcfg)
    h2 = jlm.forward_train(jparams, {"tokens": jnp.asarray(toks2)}, jcfg,
                           NULL_CTX)
    ref2 = jlm.logits_fn(jparams, h2, jcfg, NULL_CTX)[:, -1]
    np.testing.assert_allclose(as_np(dec), as_np(ref2), atol=1e-4)
    assert int(cache["pos"]) == toks.shape[1] + 1


def test_sparse_vs_dense_cache_agree_at_zero_sparsity():
    """At f32 the two caches hold the same K/V: prefill and decode logits
    agree within 1e-3 of the logit range, and on the argmax."""
    _, tcfg = configs("float32", kv_k_sparsity=0.0, kv_v_sparsity=0.0)
    params = lm.init_params(tcfg, seed=1, device="cpu")
    toks = _tokens(tcfg, seed=1)
    e_s, e_d = _engine(params, tcfg), _engine(params, tcfg, "dense")
    cs, ls = e_s.prefill({"tokens": toks})
    cd, ld = e_d.prefill({"tokens": toks})
    assert isinstance(cs["layers"]["l0"]["kv"], SparseKVCache)
    assert isinstance(cd["layers"]["l0"]["kv"], DenseKVCache)
    rng = float(ls.max() - ls.min())
    assert float((ls - ld).abs().max()) <= 1e-3 * rng
    nxt = torch.as_tensor(toks[:, -1:])
    l1, _ = lm.forward_decode(e_s.params, cs, nxt, tcfg)
    l2, _ = lm.forward_decode(e_d.params, cd, nxt, tcfg)
    assert float((l1 - l2).abs().max()) <= 1e-3 * float(l1.max() - l1.min())
    assert torch.equal(l1.argmax(-1), l2.argmax(-1))


def test_paper_kv_sparsity_small_logit_drift():
    """At 30% K / 50% V sparsity the decode logits stay close to the
    unpruned cache's (cosine > 0.85, the reference's bar)."""
    _, tcfg = configs("bfloat16")
    params = lm.init_params(tcfg, seed=2, device="cpu")
    toks = _tokens(tcfg, seed=2)
    out = []
    for ks, vs in ((0.0, 0.0), (0.3, 0.5)):
        cfg = dataclasses.replace(tcfg, kv_k_sparsity=ks, kv_v_sparsity=vs)
        eng = _engine(params, cfg)
        cache, _ = eng.prefill({"tokens": toks})
        logits, _ = lm.forward_decode(eng.params, cache,
                                      torch.as_tensor(toks[:, -1:]), cfg)
        out.append(logits.double().numpy())
    ld, ls = out
    cos = (ld * ls).sum() / (np.linalg.norm(ld) * np.linalg.norm(ls))
    assert cos > 0.85, cos


def test_sparse_weights_zero_sparsity_exact():
    """Packing at sparsity 0 changes nothing: the full forward's hidden
    states agree within 1e-3 (bf16)."""
    _, tcfg = configs("bfloat16", sparsity=0.0)
    params = lm.init_params(tcfg, seed=3, device="cpu")
    sp = convert_concrete(params, lm.model_specs(tcfg), tcfg, device="cpu")
    batch = {"tokens": torch.ones((2, 16), dtype=torch.long)}
    h1, _ = lm.forward_prefill(params, batch, tcfg)
    h2, _ = lm.forward_prefill(sp, batch, tcfg)
    np.testing.assert_allclose(as_np(h1), as_np(h2), rtol=1e-3, atol=1e-3)


def test_int8_sparse_weights_close():
    """int8 against bf16 sparse weights: mean relative deviation of the
    hidden states below 0.1 (the reference's bar)."""
    _, tcfg = configs("bfloat16", sparsity=0.5)
    params = lm.init_params(tcfg, seed=4, device="cpu")
    specs = lm.model_specs(tcfg)
    sp = convert_concrete(params, specs, tcfg, device="cpu")
    s8 = convert_concrete(params, specs, tcfg, mode="int8", device="cpu")
    batch = {"tokens": torch.ones((2, 16), dtype=torch.long)}
    h1 = as_np(lm.forward_prefill(sp, batch, tcfg)[0])
    h2 = as_np(lm.forward_prefill(s8, batch, tcfg)[0])
    assert np.abs(h1 - h2).mean() / (np.abs(h1).mean() + 1e-9) < 0.1


def test_generate_multi_step_cache_consistency():
    _, tcfg = configs("bfloat16", kv_k_sparsity=0.0, kv_v_sparsity=0.0)
    params = lm.init_params(tcfg, seed=5, device="cpu")
    out, cache = _engine(params, tcfg).generate(
        {"tokens": _tokens(tcfg, seed=5, s=32)},
        SamplingParams(max_new_tokens=9))
    assert out.shape == (2, 9) and out.dtype == torch.int32
    assert int(cache["pos"]) == 32 + 8
    with pytest.raises(ValueError, match="eos_id"):
        _engine(params, tcfg).generate(
            {"tokens": _tokens(tcfg, s=32)},
            SamplingParams(max_new_tokens=3, eos_id=1))


def test_init_cache_matches_the_reference_shapes():
    jcfg, tcfg = configs("bfloat16")
    for mode in ("sparse", "dense"):
        ours = lm.init_cache(tcfg, 2, 256, mode=mode, abstract=True)
        theirs = jlm.init_cache(jcfg, 2, 256, mode=mode, abstract=True)
        kv, jkv = ours["layers"]["l0"]["kv"], theirs["layers"]["l0"]["kv"]
        if mode == "sparse":
            pairs = [(kv.k_sp.bitmap, jkv.k_sp.bitmap),
                     (kv.v_sp.values, jkv.v_sp.values),
                     (kv.k_tail, jkv.k_tail), (kv.tail_len, jkv.tail_len)]
            assert kv.k_sp.shape == jkv.k_sp.shape
        else:
            pairs = [(kv.k, jkv.k), (kv.length, jkv.length)]
        for a, b in pairs:
            assert tuple(a.shape) == tuple(b.shape)
            assert a.device.type == "meta"
        real = lm.init_cache(tcfg, 2, 256, mode=mode, device="cpu")
        assert int(real["pos"]) == 0
    c = init_dense_cache(2, 2, 16, 32, device="cpu")
    assert c.k.shape == (2, 2, 16, 32) and int(c.length) == 0


# ---------------------------------------------------------------------------
# refreeze (twins of tests/test_refreeze.py)
# ---------------------------------------------------------------------------

def _t(a):
    return torch.as_tensor(np.asarray(a))


def _same_sw(sw, jsw):
    np.testing.assert_array_equal(sw.bitmap.numpy(),
                                  np.asarray(jsw.bitmap).view(np.int32))
    np.testing.assert_array_equal(sw.values.numpy(), np.asarray(jsw.values))
    assert tuple(sw.shape) == tuple(jsw.shape)


def test_refreeze_preserves_attention():
    """Freeze, append a full tail, refreeze: the decode attention is the
    same before and after (1e-4), and every step's cache is the
    reference's bit for bit (f32)."""
    b, hkv, s, d, t = 2, 4, 256, 64, 128
    k, v = rand((b, hkv, s, d), 1), rand((b, hkv, s, d), 2)
    cache = freeze_prefix(_t(k), _t(v), 0.0, 0.0, tail_size=t, bs=128)
    jcache = jax_freeze(jnp.asarray(k), jnp.asarray(v), 0.0, 0.0,
                        tail_size=t, bs=128)
    _same_sw(cache.k_sp, jcache.k_sp)
    for i in range(t):
        kn, vn = rand((b, hkv, d), 10 + i) * 0.5, rand((b, hkv, d), 500 + i)
        cache = append_token(cache, _t(kn), _t(vn * 0.5))
        jcache = jax_append(jcache, jnp.asarray(kn), jnp.asarray(vn * 0.5))
    assert int(cache.tail_len) == t
    np.testing.assert_array_equal(cache.v_tail.numpy(),
                                  np.asarray(jcache.v_tail))
    q = _t(rand((b, 8, d), 3))
    sm = 1.0 / d ** 0.5
    o_before = ops.sparse_decode_attention(q, cache.k_sp, cache.v_sp, hkv,
                                           sm, cache.k_tail, cache.v_tail,
                                           cache.tail_len)
    cache2 = refreeze(cache, 0.0, 0.0)
    jcache2 = jax_refreeze(jcache, 0.0, 0.0)
    _same_sw(cache2.k_sp, jcache2.k_sp)
    _same_sw(cache2.v_sp, jcache2.v_sp)
    assert int(cache2.tail_len) == 0
    assert cache2.k_sp.bitmap.shape[2] == (s + t) // 128
    o_after = ops.sparse_decode_attention(q, cache2.k_sp, cache2.v_sp, hkv,
                                          sm, cache2.k_tail, cache2.v_tail,
                                          cache2.tail_len)
    np.testing.assert_allclose(o_after.numpy(), o_before.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert maybe_refreeze(cache2, 0.0, 0.0) is cache2


def test_refreeze_prunes_new_tokens():
    b, hkv, s, d, t = 1, 2, 128, 64, 128
    k, v = rand((b, hkv, s, d), 4), rand((b, hkv, s, d), 5)
    cache = freeze_prefix(_t(k), _t(v), 0.3, 0.5, tail_size=t, bs=128)
    jcache = jax_freeze(jnp.asarray(k), jnp.asarray(v), 0.3, 0.5,
                        tail_size=t, bs=128)
    for i in range(t):
        kn, vn = rand((b, hkv, d), 20 + i), rand((b, hkv, d), 700 + i)
        cache = append_token(cache, _t(kn), _t(vn))
        jcache = jax_append(jcache, jnp.asarray(kn), jnp.asarray(vn))
    cache2 = maybe_refreeze(cache, 0.3, 0.5)
    _same_sw(cache2.k_sp, jax_refreeze(jcache, 0.3, 0.5).k_sp)
    frac_zero = (unpack(cache2.k_sp) == 0).double().mean().item()
    assert 0.2 < frac_zero < 0.45


def test_pack_capacity_truncation_keeps_bitmap_consistent():
    w = rand((128, 64), 7)
    mask = np.abs(w) > 0.5                       # nnz >> capacity
    sw = pack(_t(w), _t(mask), block=(128, 64), capacity=2048)
    _same_sw(sw, jax_pack(jnp.asarray(w), jnp.asarray(mask),
                          block=(128, 64), capacity=2048))
    nnz = int(np.unpackbits(sw.bitmap.numpy().view(np.uint8)).sum())
    assert nnz == 2048
    back = unpack(sw).numpy()
    kept = back != 0
    np.testing.assert_array_equal(back[kept], w[kept])
    assert np.abs(w)[mask & ~kept].max() <= np.abs(back[kept]).min() + 1e-7


def test_repack_capacity_roundtrip_grow_and_shrink():
    """Growing pads bit-exactly; shrinking re-ranks and keeps the bitmap and
    the values consistent; both equal the reference's bit for bit."""
    w = rand((256, 64), 8)
    mask = np.abs(w) > 0.9
    sw = pack(_t(w), _t(mask), block=(128, 64))
    jsw = jax_pack(jnp.asarray(w), jnp.asarray(mask), block=(128, 64))
    grown = repack_capacity(sw, sw.capacity + 256)
    _same_sw(grown, jax_repack(jsw, sw.capacity + 256))
    assert torch.equal(unpack(grown), unpack(sw))
    shrunk = repack_capacity(sw, 128)
    _same_sw(shrunk, jax_repack(jsw, 128))
    back = unpack(shrunk).numpy()
    kept = back != 0
    np.testing.assert_array_equal(back[kept], w[kept])
    nnz = int(np.unpackbits(shrunk.bitmap.numpy().view(np.uint8)).sum())
    assert nnz == kept.sum() and nnz <= 2 * 128
    assert repack_capacity(sw, sw.capacity) is sw
    assert abs(sw.compression_ratio() - jsw.compression_ratio()) < 1e-12


def test_engine_repack_preserves_decode_attention():
    """The stacked periods' repack at a common capacity changes no
    period's decode attention (1e-5)."""
    b, hkv, s, d = 1, 2, 128, 64
    caches = [freeze_prefix(_t(rand((b, hkv, s, d), 30 + i) * (1.0 + i)),
                            _t(rand((b, hkv, s, d), 40 + i)), 0.3, 0.5,
                            tail_size=128, bs=128) for i in range(2)]
    cap_k = max(c.k_sp.capacity for c in caches)
    cap_v = max(c.v_sp.capacity for c in caches)
    eng = Engine.__new__(Engine)                 # repack without a model
    q = _t(rand((b, 4, d), 9))
    sm = 1.0 / d ** 0.5
    for c in caches:
        r = eng._repack(c, cap_k, cap_v)
        assert r.k_sp.capacity == cap_k and r.v_sp.capacity == cap_v
        o1 = ops.sparse_decode_attention(q, c.k_sp, c.v_sp, hkv, sm,
                                         c.k_tail, c.v_tail, c.tail_len)
        o2 = ops.sparse_decode_attention(q, r.k_sp, r.v_sp, hkv, sm,
                                         r.k_tail, r.v_tail, r.tail_len)
        np.testing.assert_allclose(o2.numpy(), o1.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_engine_generates_past_tail_capacity():
    _, tcfg = configs("bfloat16", kv_tail=64)
    params = lm.init_params(tcfg, seed=0, device="cpu")
    steps = 64 + 8                       # decode steps exceed the tail
    out, cache = _engine(params, tcfg).generate(
        {"tokens": _tokens(tcfg)}, SamplingParams(max_new_tokens=steps + 1))
    assert out.shape == (2, steps + 1)
    assert int(cache["pos"]) == 64 + steps
    kv = cache["layers"]["l0"]["kv"]
    assert kv.k_sp.bitmap.shape[3] * kv.k_sp.block[0] >= 128
    assert int(kv.tail_len[0]) < 64


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,n_new", [("sparse", 40), ("dense", 30)])
def test_greedy_tokens_equal_the_jax_engine(mode, n_new):
    """f32, the bridged sparse weights, KV sparsity 30% / 50%, 32-token
    prompts and a 32-token tail: the port's greedy tokens are the JAX
    ``Engine``'s.  Sparse KV decodes 40 tokens (one refreeze grows the
    prefix from 1 to 2 blocks); the dense cache holds prompt + tail, so
    30."""
    jcfg, tcfg = configs("float32", kv_tail=32)
    jparams, params = sparse_params(jcfg, tcfg, seed=6)
    toks = _tokens(tcfg, seed=6, b=3, s=32)
    want, jcache = JaxEngine(jparams, jcfg, kv_mode=mode).generate(
        {"tokens": jnp.asarray(toks, jnp.int32)},
        JaxParams(max_new_tokens=n_new))
    got, cache = _engine(params, tcfg, mode).generate(
        {"tokens": toks}, SamplingParams(max_new_tokens=n_new))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(cache["pos"]) == int(jcache["pos"])
    if mode == "sparse":
        kv, jkv = cache["layers"]["l0"]["kv"], jcache["layers"]["l0"]["kv"]
        assert kv.k_sp.bitmap.shape == jkv.k_sp.bitmap.shape
        assert kv.k_sp.bitmap.shape[3] == 2
        np.testing.assert_array_equal(kv.tail_len.numpy(),
                                      np.asarray(jkv.tail_len))
    else:
        with pytest.raises(ValueError, match="dense cache holds"):
            _engine(params, tcfg, mode).generate(
                {"tokens": toks}, SamplingParams(max_new_tokens=34))


def _serve(args):
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve.main(args) == 0
    return buf.getvalue()


def test_serve_cli_one_shot_and_dense():
    base = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "32", "--steps", "4"]
    out = _serve(base + ["--one-shot"])
    assert "[serve] one-shot: 4 tokens x 2 reqs" in out
    assert "[serve] sparse-converted" in out
    out = _serve(base + ["--one-shot", "--dense"])
    assert "[serve] one-shot: 4 tokens x 2 reqs" in out
    assert "sparse-converted" not in out
    out = _serve(base + ["--dense", "--prefill-chunk", "16"])
    assert "[serve] stream: 2 requests" in out
    from repro_torch.launch import serve
    for bad in (["--one-shot", "--server"], ["--one-shot", "--log-json"],
                ["--snapshot-dir", "x"]):
        with pytest.raises(SystemExit), \
                contextlib.redirect_stderr(io.StringIO()):
            serve.main(base + bad)
