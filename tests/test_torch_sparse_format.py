"""The port's sparse format, pruning and conversion against the reference,
bit for bit: the same numpy inputs go through ``repro.core`` and
``repro_torch.core``, and every bitmap word and packed value must agree
(f32 and bf16 values, tie-heavy magnitudes, capped capacity included)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import pruning as jpruning
from repro.core import sparse_format as jsf
from repro.core.sparse_kv import freeze_chunk_blocks as jfreeze
from repro.distributed import NULL_CTX
from repro.distributed.convert_plan import convert_concrete as jconvert
from repro.models import lm as jlm

from repro_torch import bridge
from repro_torch.core import pruning as tpruning
from repro_torch.core import sparse_format as tsf
from repro_torch.core.convert import convert_concrete as tconvert
from repro_torch.core.sparse_kv import freeze_chunk_blocks as tfreeze
from repro_torch.models import lm as tlm

from torch_parity import configs, to_numpy


def _weights(shape, seed, dtype, ties):
    rng = np.random.default_rng(seed)
    if ties:        # few distinct magnitudes: most comparisons are ties
        w = rng.integers(-4, 5, size=shape).astype(np.float32) / 4
    else:
        w = rng.normal(size=shape).astype(np.float32)
    jw = jnp.asarray(w)
    tw = torch.from_numpy(w)
    if dtype == "bfloat16":
        jw, tw = jw.astype(jnp.bfloat16), tw.to(torch.bfloat16)
    return jw, tw


def _bits(a):
    """Raw bits of a reference or port array (uint32 words, bf16 as u16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        if a.dtype == torch.int32:
            return a.numpy().view(np.uint32)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same(ref, got):
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_pack_bits_round_trip_and_sign_bit():
    mask = np.random.default_rng(0).integers(0, 2, (3, 5, 64))
    mask[..., 31] = 1                        # the sign bit of word 0
    ref = jsf.pack_bits(jnp.asarray(mask))
    got = tsf.pack_bits(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    _same(ref, got)
    np.testing.assert_array_equal(tsf.unpack_bits(got, 64).numpy(), mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("capacity", [None, 3072],
                         ids=["data_capacity", "capped"])
def test_pack_bit_exact(dtype, ties, capacity):
    """Balanced mask + pack at a (300, 200) shape that pads both axes; the
    capped capacity forces the magnitude re-rank of ``_cap_mask``."""
    jw, tw = _weights((300, 200), 1, dtype, ties)
    block = (128, 128)
    jmask = jpruning.prune_balanced(jw.astype(jnp.float32), 0.5, block)
    tmask = tpruning.prune_balanced(tw.to(torch.float32), 0.5, block)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    # a mask denser than the capacity: the cap must drop entries
    dense_mask = np.asarray(jmask) | (np.arange(200)[None] % 3 == 0)
    ref = jsf.pack(jw, jnp.asarray(dense_mask), block, capacity=capacity)
    got = tsf.pack(tw, torch.from_numpy(dense_mask), block,
                   capacity=capacity)
    assert got.capacity == ref.capacity and got.shape == ref.shape
    _same(ref.bitmap, got.bitmap)
    _same(ref.values, got.values)
    _same(jsf.unpack(ref), tsf.unpack(got))
    _same(jsf.unpack(ref, trim=False), tsf.unpack(got, trim=False))
    mask_r, idx_r = jsf.block_gather_indices(ref.bitmap, block)
    mask_g, idx_g = tsf.block_gather_indices(got.bitmap, block)
    np.testing.assert_array_equal(mask_g.numpy(), np.asarray(mask_r))
    np.testing.assert_array_equal(idx_g.numpy(), np.asarray(idx_r))


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.5])
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
def test_prune_kv_and_global_masks(sparsity, ties):
    jw, tw = _weights((4, 16, 32), 2, "bfloat16", ties)
    np.testing.assert_array_equal(
        tpruning.prune_kv(tw, sparsity).numpy(),
        np.asarray(jpruning.prune_kv(jw, sparsity)))
    np.testing.assert_array_equal(
        tpruning.make_mask(tw, sparsity, "global").numpy(),
        np.asarray(jpruning.make_mask(jw, sparsity, "global")))


@pytest.mark.parametrize("ks,vs,cap", [(0.3, 0.5, 384), (0.0, 0.0, 512),
                                       (0.5, 0.5, 128)])
def test_freeze_chunk_blocks_bit_exact(ks, vs, cap):
    """Per-(slot, block) KV thresholds over (Hkv, bs, D), packed at the
    pool's static capacity (the smallest one truncates)."""
    rng = np.random.default_rng(3)
    k = rng.normal(size=(2, 2, 32, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 32, 16)).astype(np.float32)
    jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k, v))
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    ref = jfreeze(jk, jv, ks, vs, 16, cap, cap)
    got = tfreeze(tk, tv, ks, vs, 16, cap, cap)
    for r, g in zip(ref, got):
        _same(r, g)


@pytest.mark.parametrize("density", [0.5, 0.7, 0.013])
def test_balanced_capacity(density):
    for block in ((256, 128), (128, 64), (8, 16)):
        assert tsf.balanced_capacity(density, block) == \
            jsf.balanced_capacity(density, block)


def test_convert_concrete_bit_exact():
    """The same dense params (reference init, bridged) converted by both
    packages: per-leaf blocks, capacities and layer-stacked packing."""
    # d_ff=200 fits both block edges; two layers keep the stacking
    jcfg, tcfg = configs("float32", d_ff=200, n_layers=2)
    dense = jax.jit(lambda k: jlm.init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    ref = jax.jit(lambda d: jconvert(d, jlm.model_specs(jcfg), jcfg,
                                     NULL_CTX))(dense)
    got = tconvert(bridge.params_from_numpy(to_numpy(dense), tcfg, "cpu"),
                   tlm.model_specs(tcfg), tcfg, device="cpu")

    def walk(r, g, path=""):
        if isinstance(r, jsf.BlockSparseWeight):
            assert isinstance(g, tsf.BlockSparseWeight), path
            assert (g.shape, g.block) == (r.shape, r.block), path
            _same(r.bitmap, g.bitmap)
            _same(r.values, g.values)
        elif isinstance(r, dict):
            assert set(r) == set(g), path
            for key in r:
                walk(r[key], g[key], f"{path}/{key}")
        else:
            _same(r, g)
    walk(ref, got)
    ffn = got["blocks"]["l0"]["ffn"]
    assert ffn["w_up"].block == (128, 128)
    assert ffn["w_down"].block == (200, 128)
    assert ffn["w_up"].values.dtype == torch.bfloat16   # even in f32
