"""The port's sharding derivation (``repro_torch/distributed``) against the
reference's, in process, on the reference tests' fake ``{"data": 4,
"model": 2}`` mesh (only ``mesh.shape`` is read): ``ShardCtx.spec``'s
divisibility fallback and first-use rule, ``default_rules`` under
``seq_shard`` / ``fsdp`` / ``ep_moe``, ``tree_param_specs`` on packed trees,
``zero1_specs``, the pool's and the lanes' axes, the serving context and
its token and vector specs, ``_plan_leaf`` on every leaf of every
registered config, and ``convert_abstract``'s shapes."""
import dataclasses

import jax
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.core.sparse_format import BlockSparseWeight as JaxSparse
from repro.distributed import convert_plan as jplan
from repro.distributed import serving_sharding as jserve
from repro.distributed.sharding import ShardCtx as JaxCtx
from repro.distributed.sharding import default_rules as jax_rules
from repro.distributed.sharding import tree_param_specs as jax_param_specs
from repro.distributed.sharding import zero1_specs as jax_zero1
from repro.models import lm as jlm
from repro.models import module as jmod
from repro.serving import CachePool as JaxPool
from repro.serving import sampling as jsampling

from repro_torch.configs import get_config as torch_config
from repro_torch.core.sparse_format import BlockSparseWeight
from repro_torch.distributed import (NULL_CTX, PartitionSpec, ShardCtx,
                                     default_rules, tree_param_specs,
                                     zero1_specs)
from repro_torch.distributed import convert_plan as tplan
from repro_torch.distributed import serving_sharding as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import module as tmod
from repro_torch.serving import CachePool, sampling

# one intra-op torch thread: the port's tests run tiny tensors, which many
# threads only slow down, and the suite's workers share the cores
torch.set_num_threads(1)


class FakeMesh:
    shape = {"data": 4, "model": 2}
    axis_names = ("data", "model")


def _ctxs(name="qwen3-0.6b", multi_pod=False, **edits):
    jcfg = dataclasses.replace(jax_config(name), **edits)
    tcfg = dataclasses.replace(torch_config(name), **edits)
    return (JaxCtx(FakeMesh(), jax_rules(multi_pod, jcfg)),
            ShardCtx(FakeMesh(), default_rules(multi_pod, tcfg)),
            jcfg, tcfg)


def _same(port, ref):
    """A port spec (or tree of them) equal to the reference's, element for
    element."""
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _same(port[k], ref[k])
    elif isinstance(port, BlockSparseWeight):
        _same(port.bitmap, ref.bitmap)
        _same(port.values, ref.values)
        assert (port.scale is None) == (ref.scale is None)
        if port.scale is not None:
            _same(port.scale, ref.scale)
    else:
        assert isinstance(port, PartitionSpec)
        assert tuple(port) == tuple(ref), (port, ref)


@pytest.mark.parametrize("axes,sizes", [
    (("batch", "kv_heads"), (128, 8)),          # 8 heads on model = 2
    (("batch", "kv_heads"), (128, 3)),          # 3 heads: replicate
    (("batch", "heads"), (6, 32)),              # 6 rows on data = 4
    (("batch", "ctx", None), (256, 4096, 64)),  # data used first by batch
    (("ctx", "batch"), (4096, 256)),            # ctx takes data and model
    ((None, "slots", "kv_heads", None, None), (2, 4, 2, 4, 64)),
    ((None, "slots", "kv_heads", None, None), (2, 3, 1, 4, 64)),
    (("layers", "embed", "ffn"), (4, 128, 256)),
])
def test_spec_rules_match_the_reference(axes, sizes):
    jctx, tctx, _, _ = _ctxs("llama3-8b")
    _same(tctx.spec(axes, sizes), jctx.spec(axes, sizes))
    _same(tctx.spec(axes), jctx.spec(axes))
    assert tctx.tp_axis == jctx.tp_axis
    assert tctx.dp_axes == jctx.dp_axes
    for logical in ("batch", "ctx", "heads", "experts"):
        assert tctx.axis_size(logical) == jctx.axis_size(logical)


@pytest.mark.parametrize("edits", [
    {}, {"seq_shard": True}, {"fsdp": True}, {"ep_moe": True},
    {"seq_shard": True, "fsdp": True, "ep_moe": True}],
    ids=lambda e: "+".join(e) or "default")
@pytest.mark.parametrize("multi_pod", [False, True])
def test_default_rules_match_the_reference(edits, multi_pod):
    jctx, tctx, jcfg, tcfg = _ctxs("phi3.5-moe-42b-a6.6b", multi_pod,
                                   **edits)
    assert default_rules(multi_pod, tcfg) == jax_rules(multi_pod, jcfg)
    assert default_rules(multi_pod) == jax_rules(multi_pod)


@pytest.mark.parametrize("name", ["llama3-8b", "deepseek-67b",
                                  "qwen3-0.6b"])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_param_specs_and_zero1_on_packed_trees(name, mode):
    """``tree_param_specs`` on a dense tree and on ``convert_abstract``'s
    packed tree, and ``zero1_specs`` on both, at full size (shapes only),
    equal to the reference's."""
    jctx, tctx, jcfg, tcfg = _ctxs(name)
    jspecs, tspecs = jlm.model_specs(jcfg), tlm.model_specs(tcfg)
    jabs, tabs = jmod.abstract(jspecs), tmod.abstract(tspecs)
    _same(tree_param_specs(tctx, tspecs, tabs),
          jax_param_specs(jctx, jspecs, jabs))
    jpk = jplan.convert_abstract(jabs, jspecs, jcfg, jctx, mode)
    tpk = tplan.convert_abstract(tabs, tspecs, tcfg, tctx, mode)
    jps = jax_param_specs(jctx, jspecs, jpk)
    tps = tree_param_specs(tctx, tspecs, tpk)
    _same(tps, jps)
    _same(zero1_specs(tps, tpk, tcfg, tctx), jax_zero1(jps, jpk, jcfg, jctx))


@pytest.mark.parametrize("name", ARCH_IDS)
def test_plan_leaf_and_abstract_shapes_match_the_reference(name):
    """Every leaf of every registered config: the same sparsifiable
    leaves, the same ``_plan_leaf`` (block, padding) under the fake mesh
    and ``NULL_CTX``, and ``convert_abstract``'s shapes leaf for leaf."""
    jctx, tctx, jcfg, tcfg = _ctxs(name)
    jspecs, tspecs = jlm.model_specs(jcfg), tlm.model_specs(tcfg)
    jflat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=jmod.is_spec)[0]
    tflat = {}
    tmod.map_with_path(lambda p, s: tflat.setdefault(p, s), tspecs)
    n_sparse = 0
    for path, jspec in jflat:
        p = "/".join(str(getattr(k, "key", k)) for k in path)
        tspec = tflat[p]
        assert tuple(tspec.shape) == tuple(jspec.shape), p
        sp = tplan._is_sparsifiable(p, tspec)
        assert sp == jplan._is_sparsifiable(p, jspec), p
        if sp:
            n_sparse += 1
            for jc, tc in ((jctx, tctx), (jax_serving_null(), NULL_CTX)):
                assert tplan._plan_leaf(tspec, tc) == \
                    jplan._plan_leaf(jspec, jc), p
    assert n_sparse > 0
    jabs = jplan.convert_abstract(jmod.abstract(jspecs), jspecs, jcfg, jctx)
    tabs = tplan.convert_abstract(tmod.abstract(tspecs), tspecs, tcfg, tctx)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jabs, is_leaf=lambda x: isinstance(x, JaxSparse))[0]
    tleaves = {}
    tmod.map_with_path(lambda p, t: tleaves.setdefault(p, t), tabs,
                       is_leaf=lambda x: torch.is_tensor(x)
                       or isinstance(x, BlockSparseWeight))
    assert len(tleaves) == len(jleaves)

    def arrays(w):
        if isinstance(w, (JaxSparse, BlockSparseWeight)):
            return [tuple(a.shape) if a is not None else None
                    for a in (w.bitmap, w.values, w.scale)]
        return [tuple(w.shape)]
    for path, jleaf in jleaves:
        p = "/".join(str(getattr(k, "key", k)) for k in path)
        tleaf = tleaves[p]
        assert isinstance(tleaf, BlockSparseWeight) == \
            isinstance(jleaf, JaxSparse), p
        assert arrays(tleaf) == arrays(jleaf), p
        if isinstance(tleaf, BlockSparseWeight):
            assert tleaf.bitmap.device.type == "meta"
            assert (tleaf.shape, tleaf.block, tleaf.packed4) == \
                (tuple(jleaf.shape), tuple(jleaf.block), jleaf.packed4), p


def _meta_pool(cfg, paged):
    """A 4-slot pool whose state allocates nothing."""
    return dataclasses.replace(CachePool.build(cfg, 4, 64, bs=16, paged=paged,
                                               device="cpu"),
                               device=torch.device("meta"))


def jax_serving_null():
    from repro.distributed import NULL_CTX as JAX_NULL
    return JAX_NULL


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_state_axes_match_the_reference_and_cover_every_leaf(paged):
    cfg = torch_config("qwen3-0.6b").reduced()
    jcfg = jax_config("qwen3-0.6b").reduced()
    pool = _meta_pool(cfg, paged)
    jpool = JaxPool.build(jcfg, 4, 64, bs=16, paged=paged)
    assert pool.state_axes() == jpool.state_axes()
    state = pool.init_state()
    axes = pool.state_axes()

    def walk(a, s):
        assert set(a) == set(s)
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], s[k])
            else:
                assert len(a[k]) == s[k].dim(), (k, a[k], s[k].shape)
    walk(axes, state)
    lanes = sampling.init_lanes(4, "meta")
    assert set(sampling.lane_axes()) == set(lanes)
    assert {k: v for k, v in jsampling.lane_axes().items() if k in lanes} \
        == sampling.lane_axes()


def test_serving_ctx_and_the_token_and_vec_specs():
    cfg = torch_config("qwen3-0.6b").reduced()
    jcfg = jax_config("qwen3-0.6b").reduced()
    tctx = tserve.serving_ctx(FakeMesh(), cfg)
    jctx = jserve.serving_ctx(FakeMesh(), jcfg)
    assert tctx.rules == jctx.rules
    assert tserve.serving_ctx(None, cfg).mesh is None
    # the reference's token / vec shardings wrap these specs (a
    # NamedSharding needs a real mesh)
    for slots in (4, 3, 8):
        _same(tserve.token_sharding(tctx, slots),
              jctx.spec(("slots", None), (slots, 1)))
        _same(tserve.vec_sharding(tctx, slots),
              jctx.spec(("slots",), (slots,)))
    assert tuple(tserve.replicated(tctx)) == ()
    pool = _meta_pool(cfg, paged=False)
    specs = tserve.state_shardings(tctx, pool.init_state(),
                                   pool.state_axes())
    assert specs["pos"] == ("data",)
    assert specs["layers"]["l0"]["kv"]["k_values"] == \
        (None, "data", "model", None, None)
    place = tserve.describe(tctx, pool.init_state(), pool.state_axes())
    assert place["layers/l0/kv/k_tail"] == \
        "PartitionSpec(None, 'data', 'model', None, None)"
