"""The port's Wanda pruning and ``convert_to_sparse`` against the
reference's (``repro.core.pruning`` / ``repro.core.convert``), on the same
numpy inputs: Wanda masks bit-equal with planted ties, per output channel
and over the whole tensor, and through ``make_mask``; every packing of
``convert_to_sparse`` (``bf16``, ``keep`` and ``int8`` values, balanced
and global masks, a stacked ``[E, K, N]`` expert leaf folded to
``[E*K, N]``, ``pad_to_blocks``, a fixed ``capacity``, a ``predicate``)
bit-equal in bitmaps, values and scales, leaf for leaf; ``sparsity_report``
equal, ``ratio`` included."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import convert as jconvert
from repro.core import pruning as jpruning

from repro_torch import bridge
from repro_torch.core import convert as tconvert
from repro_torch.core import pruning as tpruning
from repro_torch.core.sparse_format import BlockSparseWeight

from torch_parity import to_numpy


def _tied(shape, seed, levels=7):
    """Weights drawn from a few values (signs mixed), so that magnitudes,
    and the Wanda scores built on them, tie often."""
    rng = np.random.default_rng(seed)
    mag = rng.integers(1, levels + 1, shape).astype(np.float32) / levels
    return mag * rng.choice([-1.0, 1.0], shape).astype(np.float32)


def _norms(k, seed):
    """Per-input-channel activation norms, repeated values included."""
    rng = np.random.default_rng(seed)
    return rng.choice([0.5, 1.0, 2.0, 3.0], k).astype(np.float32)


@pytest.mark.parametrize("per_output", [True, False])
@pytest.mark.parametrize("sparsity", [0.25, 0.5, 0.7])
@pytest.mark.parametrize("shape", [(64, 48), (37, 20)])
def test_wanda_masks_equal_the_reference(shape, sparsity, per_output):
    w, a = _tied(shape, 1), _norms(shape[0], 2)
    want = np.asarray(jpruning.prune_wanda(jnp.asarray(w), jnp.asarray(a),
                                           sparsity, per_output))
    got = tpruning.prune_wanda(torch.from_numpy(w), torch.from_numpy(a),
                               sparsity, per_output).numpy()
    np.testing.assert_array_equal(got, want)
    # ties are planted: some threshold is shared by more entries than it
    # keeps, so a top-k rule would keep a different set
    assert 0 < got.sum() < got.size


def test_wanda_through_make_mask():
    w, a = _tied((96, 40), 3), _norms(96, 4)
    want = np.asarray(jpruning.make_mask(jnp.asarray(w), 0.5, "wanda",
                                         act_norm=jnp.asarray(a)))
    got = tpruning.make_mask(torch.from_numpy(w), 0.5, "wanda",
                             act_norm=torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)
    for make, arr in ((jpruning.make_mask, jnp.asarray(w)),
                      (tpruning.make_mask, torch.from_numpy(w))):
        with pytest.raises(ValueError, match="act norms"):
            make(arr, 0.5, "wanda")


def _tree(seed=0):
    """A params tree with every kind of leaf the converter meets: linear
    weights (ragged K and N), a stacked expert leaf, and leaves the default
    predicate leaves dense (the embedding, a norm scale, a 1-D bias)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"embed": {"tok": f(40, 24), "lm_head": f(24, 40)},
            "blocks": {"mixer": {"wq": f(200, 100)},
                       "ffn": {"w1": f(2, 128, 64), "bias": f(64)}},
            "final_norm": f(24)}


def _convert_both(tree, **kw):
    jtree = {k: _jax(v) for k, v in tree.items()}
    ttree = bridge.params_from_numpy(tree, None, "cpu")
    return (jconvert.convert_to_sparse(jtree, **kw),
            tconvert.convert_to_sparse(ttree, **kw))


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _assert_trees_equal(got, want):
    """``want`` (the reference's) bridged into torch as the port holds it:
    every leaf of ``got`` the same bits, sparse leaves field by field."""
    _assert_same(got, bridge.params_from_numpy(to_numpy(want), None, "cpu"))


def _assert_same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    else:
        _assert_leaf_equal(got, want)


def _assert_leaf_equal(a, b):
    if isinstance(b, BlockSparseWeight):
        assert isinstance(a, BlockSparseWeight)
        assert (a.shape, tuple(a.block), a.packed4) == \
            (b.shape, tuple(b.block), b.packed4)
        assert a.values.dtype == b.values.dtype
        assert torch.equal(a.bitmap, b.bitmap)
        assert torch.equal(a.values, b.values)
        assert (a.scale is None) == (b.scale is None)
        if b.scale is not None:
            assert torch.equal(a.scale, b.scale)
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["balanced", "global"])
@pytest.mark.parametrize("mode", ["bf16", "keep", "int8"])
def test_convert_to_sparse_equals_the_reference(mode, policy):
    """Every linear leaf packed as the reference packs it (ragged K and N,
    a stacked expert leaf), the rest left as it was."""
    want, got = _convert_both(_tree(), mode=mode, policy=policy,
                              block=(64, 32))
    _assert_trees_equal(got, want)
    assert isinstance(got["blocks"]["ffn"]["w1"], BlockSparseWeight)
    assert got["blocks"]["ffn"]["w1"].shape == (256, 64)
    for dense in (got["embed"]["tok"], got["embed"]["lm_head"],
                  got["blocks"]["ffn"]["bias"], got["final_norm"]):
        assert torch.is_tensor(dense)
    assert tconvert.sparsity_report(got) == jconvert.sparsity_report(want)


@pytest.mark.parametrize("kw", [
    {"pad_to_blocks": (2, 4)},
    {"capacity": 512},
    {"capacity": 256, "mode": "int8", "pad_to_blocks": (4, 2)},
    {"sparsity": 0.75, "block": (32, 32)},
], ids=["pad", "capacity", "int8_capacity_pad", "sparsity"])
def test_convert_options_equal_the_reference(kw):
    kw = {"block": (64, 32), **kw}
    want, got = _convert_both(_tree(1), **kw)
    _assert_trees_equal(got, want)
    report = tconvert.sparsity_report(got)
    assert report == jconvert.sparsity_report(want)
    assert all(0 < r["ratio"] for r in report.values())


def test_predicate_selects_the_leaves():
    only_wq = lambda path, leaf: path.endswith("/wq")
    want, got = _convert_both(_tree(2), block=(64, 32), predicate=only_wq)
    _assert_trees_equal(got, want)
    assert list(tconvert.sparsity_report(got)) == ["blocks/mixer/wq"]


def test_expert_leaf_needs_whole_blocks_of_k():
    tree = {"w1": np.zeros((2, 48, 32), np.float32)}
    for conv, t in ((jconvert.convert_to_sparse, _jax(tree)),
                    (tconvert.convert_to_sparse,
                     bridge.params_from_numpy(tree, None, "cpu"))):
        with pytest.raises(ValueError, match="multiple of bk=64"):
            conv(t, block=(64, 32))


def test_sparsity_report_of_the_served_conversion_has_the_ratio():
    """``convert_concrete``'s report (the launcher's "sparse-converted"
    line) carries the reference's keys, ``ratio`` included."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("llama3-8b").reduced()
    params = tconvert.convert_concrete(lm.init_params(cfg, device="cpu"),
                                       lm.model_specs(cfg), cfg,
                                       device="cpu")
    report = tconvert.sparsity_report(params)
    assert len(report) == 7
    for r in report.values():
        assert set(r) == {"dense_bytes", "compressed_bytes", "ratio",
                          "capacity"}
        # layer-stacked leaves count every layer on both sides
        assert r["ratio"] == r["compressed_bytes"] / r["dense_bytes"]
