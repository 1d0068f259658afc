"""The serving mesh on ``torch.distributed`` ranks, held against the
reference's unsharded engine.

One spawn of four gloo CPU ranks (``tests/torch_mesh_worker.py``: no JAX,
the reference's params read from a file this process wrote) runs the
reference worker's setup (``tests/workers/sharded_serving_worker.py``:
reduced Qwen3-0.6B at f32, KV sparsity 0, ``kv_tail`` 16, 4 slots,
``max_tokens`` 96, ``bs`` 16, its lockstep and staggered waves):

* meshes (4, 1) and (2, 2) give the greedy tokens of the reference's
  unsharded ``ContinuousEngine``, computed once here;
* under (2, 2), ``SpecConfig(k=3)`` gives them too, with drafts accepted;
* the append / rollback / refreeze round trip on a rank's shard of the pool
  (at KV sparsity 0.3 / 0.5: the freeze's threshold spans the heads)
  equals its block of the same transitions on the full pool, bit for bit;
* under (2, 2), the paged pool with chunked prefill on a shared prefix
  gives the tokens of the reference's unsharded paged engine, and every
  rank's refcount and arena agree;
* context-parallel decode over the model axis lies within 1e-5 of
  ``ref.sparse_decode_attention_ref`` with a tail, an empty tail and a slot
  with no valid block, and the one-shot ``Engine(ctx=)`` decodes the
  tokens it decodes alone;
* the refusals hold: ``graphs=True`` under gloo, ``checkify``, snapshots,
  ``ctx=`` with ``mesh=``.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core.sparse_kv import freeze_prefix as jax_freeze
from repro.kernels import ref
from repro.models import lm as jlm
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import SamplingParams as JaxParams

from repro_torch.launch.mesh import (make_production_mesh, make_test_mesh,
                                     spawn)

import torch_mesh_worker
from torch_parity import to_numpy

CFG = dict(kv_k_sparsity=0.0, kv_v_sparsity=0.0, kv_tail=16,
           compute_dtype="float32", param_dtype="float32")
PAGED_NEW = 12


def _waves(eng, toks):
    out1 = np.asarray(eng.generate_batch(toks, JaxParams(
        max_new_tokens=24))).tolist()
    rids = [eng.submit(np.asarray(toks[i % 4][:7 + 3 * i]),
                       JaxParams(max_new_tokens=20 - 2 * i))
            for i in range(6)]
    res = eng.run()
    return out1, [list(res[r].token_ids) for r in rids]


def _paged_prompts(vocab):
    rng = np.random.default_rng(1)
    shared = rng.integers(0, vocab, (32,)).tolist()
    return [shared + rng.integers(0, vocab, (n,)).tolist()
            for n in (5, 9, 12, 3, 7, 20)]


def _cp_cases():
    """Frozen caches of the reference (B = 2, Hkv = 2, G = 2, D = 32, four
    16-token blocks, a 16-token ring) and the reference oracle's output:
    a tail, an empty tail, a slot with no valid block."""
    rng = np.random.default_rng(5)
    b, hkv, g, s, d, t = 2, 2, 2, 64, 32, 16
    sm = 1.0 / np.sqrt(d)
    cases = []
    for tail_len, prefix_len in ((5, None), (0, None), (4, [0, 48])):
        f = lambda *shape: rng.normal(size=shape).astype(np.float32)
        cache = jax_freeze(jnp.asarray(f(b, hkv, s, d)),
                           jnp.asarray(f(b, hkv, s, d)), 0.3, 0.5,
                           tail_size=t, bs=16)
        q, k_tail, v_tail = f(b, hkv * g, d), f(b, hkv, t, d), f(b, hkv, t, d)
        want = ref.sparse_decode_attention_ref(
            jnp.asarray(q), cache.k_sp, cache.v_sp, sm, jnp.asarray(k_tail),
            jnp.asarray(v_tail), jnp.int32(tail_len),
            None if prefix_len is None else jnp.asarray(prefix_len,
                                                        jnp.int32))
        cases.append({"q": q, "k_sp": to_numpy(cache.k_sp),
                      "v_sp": to_numpy(cache.v_sp), "k_tail": k_tail,
                      "v_tail": v_tail, "tail_len": tail_len,
                      "prefix_len": prefix_len, "hkv": hkv, "sm": sm,
                      "want": np.asarray(want, np.float64)})
    return cases


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg = dataclasses.replace(jax_config("qwen3-0.6b").reduced(), **CFG)
    params = jax.jit(lambda k: jlm.init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (4, 16))
    base = _waves(JaxEngine(params, jcfg, slots=4, max_tokens=96, bs=16),
                  jnp.asarray(toks, jnp.int32))
    prompts = _paged_prompts(jcfg.vocab)
    peng = JaxEngine(params, jcfg, slots=4, max_tokens=96, bs=16,
                     paged=True, prefill_chunk=16)
    rids = [peng.submit(np.asarray(p), JaxParams(max_new_tokens=PAGED_NEW))
            for p in prompts]
    res = peng.run()
    paged = [list(res[r].token_ids) for r in rids]
    path = tmp_path_factory.mktemp("mesh") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump({"cfg": CFG, "params": to_numpy(params), "toks": toks,
                     "paged_prompts": prompts, "paged_new": PAGED_NEW,
                     "cp_cases": _cp_cases(),
                     "oneshot_toks": np.random.default_rng(2).integers(
                         0, jcfg.vocab, (2, 256))}, f)
    recs = spawn(torch_mesh_worker.run, 4, (str(path),), backend="gloo",
                 device="cpu", timeout=600)
    return {"base": base, "paged": paged, "recs": recs}


@pytest.mark.parametrize("label", ["dp4", "dp2tp2"])
def test_mesh_engine_greedy_tokens_equal_the_reference(run, label):
    want = [list(map(list, w)) for w in run["base"]]
    for rank, rec in enumerate(run["recs"]):
        row = rec["engine"][label]
        got = [list(map(list, w)) for w in row["waves"]]
        assert got == want, (label, rank)
    rows = [tuple(r["engine"][label]["rows"]) for r in run["recs"]]
    heads = [r["engine"][label]["kv_heads"] for r in run["recs"]]
    if label == "dp4":           # one slot a rank, every head
        assert rows == [(0,), (1,), (2,), (3,)] and heads == [2] * 4
    else:                        # two slots a data shard, a head a rank
        assert rows == [(0, 1), (0, 1), (2, 3), (2, 3)] and heads == [1] * 4


def test_mesh_spec_engine_tokens_and_accepts(run):
    want = [list(map(list, w)) for w in run["base"]]
    for rank, rec in enumerate(run["recs"]):
        got = [list(map(list, w)) for w in rec["spec"]["waves"]]
        assert got == want, rank
        assert rec["spec"]["accepted"] > 0, rank


def test_mesh_pool_roundtrip_equals_the_full_pool(run):
    for rank, rec in enumerate(run["recs"]):
        pool = rec["pool"]
        assert pool["roundtrip_match"], (rank, pool["mismatched"])
        assert pool["prefix_blocks"] == [1, 1, 1, 1]
        assert pool["tail_len"] == [0, 0, 0, 0]


def test_mesh_paged_engine_tokens_equal_the_reference(run):
    recs = run["recs"]
    for rank, rec in enumerate(recs):
        assert rec["paged"]["tokens"] == run["paged"], rank
        assert rec["paged"]["trie"] > 0, rank
    # the refcount replicates over every rank; the arena over the data
    # axis (ranks 0 and 2 hold head 0, ranks 1 and 3 head 1)
    assert all(r["paged"]["refcount"] == recs[0]["paged"]["refcount"]
               for r in recs)
    assert recs[0]["paged"]["arena"] == recs[2]["paged"]["arena"]
    assert recs[1]["paged"]["arena"] == recs[3]["paged"]["arena"]


def test_context_parallel_decode_matches_the_reference_oracle(run):
    for rank, rec in enumerate(run["recs"]):
        assert len(rec["cp"]) == 3
        assert max(rec["cp"]) < 1e-5, (rank, rec["cp"])
        assert rec["oneshot_cp"]["match"], rank


def test_mesh_refusals(run):
    for rank, rec in enumerate(run["recs"]):
        got = rec["refusals"]
        assert "gloo" in got["graphs"], got
        assert "unsharded-only" in got["checkify"], got
        assert "ctx= or mesh=" in got["ctx"], got
        assert "unsharded-only" in got["snapshot"], got


def test_meshes_need_their_world():
    """Without a process group the test mesh is None and the production
    mesh refuses; a rank of an unknown backend is refused."""
    assert make_test_mesh(2, 2) is None
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="backend"):
        spawn(torch_mesh_worker.run, 1, backend="mpi")
    with pytest.raises(ValueError, match="card for each rank"):
        spawn(torch_mesh_worker.run, 2, backend="nccl", device="cuda")
