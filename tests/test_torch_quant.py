"""int8 and int4 weights in the port against the reference: the quantisers,
nibble packing and ``convert_concrete(mode="int8"|"int4")`` bit-identical
(bitmap, values, scale); the int kernels' plain versions exactly equal to
``sparse_matmul_int8_pallas`` / ``sparse_matmul_int4_pallas`` in interpret
mode over the reference's own sweeps; the ``linear`` dispatch and the
bridge on int weights."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import make_mask, pack
from repro.core import quant as jquant
from repro.core import sparse_format as jsf
from repro.distributed import NULL_CTX
from repro.distributed.convert_plan import _to_int4
from repro.distributed.convert_plan import convert_concrete as jax_convert
from repro.kernels import ops as jops
from repro.kernels.sparse_matmul_int4 import sparse_matmul_int4_pallas
from repro.kernels.sparse_matmul_int8 import sparse_matmul_int8_pallas
from repro.models import lm as jlm

from repro_torch import bridge
from repro_torch.core import quant as tquant
from repro_torch.core import sparse_format as tsf
from repro_torch.core.convert import convert_concrete
from repro_torch.core.sparse_format import BlockSparseWeight
from repro_torch.kernels import ops as tops
from repro_torch.kernels.sparse_matmul_int4 import (sparse_matmul_int4,
                                                    sparse_matmul_int4_plain)
from repro_torch.kernels.sparse_matmul_int8 import (sparse_matmul_int8,
                                                    sparse_matmul_int8_plain)
from repro_torch.models import lm as tlm

from torch_parity import configs, rand, to_numpy


def _same(got: torch.Tensor, ref) -> None:
    """Bit-identical: same values of the same dtype (int32 bit-views of the
    reference's uint32 words included; bf16 compared exactly through f32)."""
    ref = np.asarray(ref)
    if got.dtype == torch.bfloat16:
        assert ref.dtype.name == "bfloat16", ref.dtype
        got, ref = got.float(), ref.astype(np.float32)
    got = got.numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if ref.dtype == np.uint32:
        ref = ref.view(np.int32)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# quantisers and nibbles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["quantize_weight_int8", "quantize_weight_int4",
                                "quantize_act_int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantisers_bit_identical(fn, dtype):
    # scaled so that many values land near .5 of a step: the rounding rule
    # (half to even on both sides) is exercised, not just the easy cases
    a = rand((96, 80), 1) * 3
    a[0, :8] = 0.0                                 # an all-zero channel/row
    a[:, 3] = 0.0
    ja = jnp.asarray(a).astype(jnp.dtype(dtype))
    ta = bridge.tensor_from_numpy(np.asarray(ja), "cpu")
    jq, js = getattr(jquant, fn)(ja)
    tq, ts = getattr(tquant, fn)(ta)
    _same(tq, jq)
    _same(ts, js)
    axis = 0 if fn == "quantize_act_int8" else -1     # the scale's axis
    _same(tquant.dequantize(tq, ts, axis=axis),
          jquant.dequantize(jq, js, axis=axis))


def test_nibbles_bit_identical_and_round_trip():
    v = np.random.default_rng(0).integers(-8, 8, (6, 256)).astype(np.int8)
    packed = tsf.pack_nibbles(torch.from_numpy(v))
    _same(packed, jsf.pack_nibbles(jnp.asarray(v)))
    _same(tsf.unpack_nibbles(packed), v)
    with pytest.raises(ValueError, match="even"):
        tsf.pack_nibbles(torch.zeros((3,), dtype=torch.int8))


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_concrete_bit_identical(mode, dtype):
    """The same dense params, packed by each package: every leaf's bitmap,
    values and scale agree byte for byte."""
    jcfg, tcfg = configs(dtype)
    dense = jax.jit(lambda key: jlm.init_params(jcfg, key))(
        jax.random.PRNGKey(3))
    jpacked = jax_convert(dense, jlm.model_specs(jcfg), jcfg, NULL_CTX,
                          mode=mode)
    tdense = bridge.params_from_numpy(to_numpy(dense), tcfg, "cpu")
    tpacked = convert_concrete(tdense, tlm.model_specs(tcfg), tcfg,
                               mode=mode, device="cpu")
    ref = dict(_leaves(bridge.params_from_numpy(to_numpy(jpacked), tcfg,
                                                "cpu")))
    n_sparse = 0
    for path, leaf in _leaves(tpacked):
        want = ref[path]
        if isinstance(leaf, BlockSparseWeight):
            n_sparse += 1
            assert leaf.packed4 == want.packed4 == (mode == "int4")
            assert (leaf.shape, leaf.block) == (want.shape, want.block)
            for key in ("bitmap", "values", "scale"):
                a, b = getattr(leaf, key), getattr(want, key)
                assert a.dtype == b.dtype, (path, key)
                assert torch.equal(a, b), (path, key)
        else:
            assert torch.equal(leaf, want), path
    assert n_sparse == 7


def test_convert_rejects_unknown_mode():
    _, tcfg = configs("float32")
    params = tlm.init_params(tcfg, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        convert_concrete(params, tlm.model_specs(tcfg), tcfg, mode="fp8",
                         device="cpu")


# ---------------------------------------------------------------------------
# the int kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _int_weight(k, n, sparsity, seed, int4, block=(128, 128)):
    """(reference weight, the port's bridged copy of the same bytes), as
    ``tests/test_kernels_matmul.py`` / ``tests/test_int4.py`` build them."""
    w = jnp.asarray(rand((k, n), seed))
    mask = make_mask(w, sparsity, "balanced", block)
    quant = jquant.quantize_weight_int4 if int4 else \
        jquant.quantize_weight_int8
    q, scale = quant(jnp.where(mask, w, 0))
    jsw = pack(q, mask, block, scale=scale)
    if int4:
        jsw = _to_int4(jsw)
    return jsw, bridge.params_from_numpy({"w": to_numpy(jsw)}, None)["w"]


SWEEP = [pytest.param(m, k, n, sp, False, id=f"int8-{m}x{k}x{n}-{sp}")
         for m, k, n in [(16, 128, 128), (64, 256, 384)] for sp in (0.0, 0.5)]
SWEEP += [pytest.param(m, k, n, sp, True, id=f"int4-{m}x{k}x{n}-{sp}")
          for m, k, n in [(16, 128, 128), (32, 256, 384)] for sp in (0.0, 0.5)]
# decode-tick row counts, below one 16-row Pallas tile
SWEEP += [pytest.param(m, 256, 384, 0.5, int4,
                       id=f"{'int4' if int4 else 'int8'}-{m}x256x384-0.5")
          for m in (1, 4) for int4 in (False, True)]


@pytest.mark.parametrize("m,k,n,sparsity,int4", SWEEP)
def test_int_plain_equals_pallas_exactly(m, k, n, sparsity, int4):
    jsw, tsw = _int_weight(k, n, sparsity, seed=10 + m, int4=int4)
    x = rand((m, k), 9)
    xq, sx = jquant.quantize_act_int8(jnp.asarray(x))
    txq, tsx = tquant.quantize_act_int8(torch.from_numpy(x))
    _same(txq, xq)
    _same(tsx, sx)
    pallas = sparse_matmul_int4_pallas if int4 else sparse_matmul_int8_pallas
    ref = pallas(xq, sx, jsw, tm=16, interpret=True)
    plain = sparse_matmul_int4_plain if int4 else sparse_matmul_int8_plain
    _same(plain(txq, tsx, tsw), ref)
    # the wrapper takes the plain version for CPU tensors, counting nothing
    kernel = sparse_matmul_int4 if int4 else sparse_matmul_int8
    before = kernel.launches
    _same(kernel(txq, tsx, tsw), ref)
    assert kernel.launches == before


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_dispatch_matches_reference(int4, dtype):
    """``ops.linear`` on int weights (leading batch dims, the activation's
    dtype out) equals the reference dispatch on its XLA backend exactly."""
    jsw, tsw = _int_weight(256, 384, 0.5, seed=4, int4=int4)
    x = jnp.asarray(rand((2, 3, 256), 5)).astype(jnp.dtype(dtype))
    with jops.backend("xla"):
        ref = jops.linear(x, jsw)
    got = tops.linear(bridge.tensor_from_numpy(np.asarray(x), "cpu"), tsw)
    assert got.shape == (2, 3, 384)
    _same(got, ref)


def test_int4_unpack_and_bridge():
    """Nibble-packed weights unpack to the int8 the reference unpacks and
    to the int8 layout they were packed from, at half the value bytes."""
    w = jnp.asarray(rand((256, 128), 6))
    mask = make_mask(w, 0.5, "balanced", (128, 128))
    q, scale = jquant.quantize_weight_int4(jnp.where(mask, w, 0))
    jsw8 = pack(q, mask, (128, 128), scale=scale)
    jsw4 = _to_int4(jsw8)
    tsw8, tsw4 = (bridge.params_from_numpy({"w": to_numpy(a)}, None)["w"]
                  for a in (jsw8, jsw4))
    assert tsw4.packed4 and tsw4.values.dtype == torch.uint8
    assert tsw4.capacity == tsw8.capacity == tsw8.values.shape[-1]
    assert tsw4.values.numel() * 2 == tsw8.values.numel()
    _same(tsf.unpack(tsw4), jsf.unpack(jsw4))
    assert torch.equal(tsf.unpack(tsw4), tsf.unpack(tsw8))
    assert torch.equal(tsw4.values, tsf.pack_nibbles(tsw8.values))


def test_int_weight_without_scale_raises():
    jsw, tsw = _int_weight(128, 128, 0.5, seed=7, int4=False)
    bare = BlockSparseWeight(tsw.bitmap, tsw.values, None, tsw.shape,
                             tsw.block)
    xq = torch.zeros((2, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="scale"):
        sparse_matmul_int8_plain(xq, torch.ones(2), bare)
    with pytest.raises(ValueError, match="nibble"):
        sparse_matmul_int4_plain(xq, torch.ones(2), tsw)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_int_mlp_matches_reference(mode):
    """One layer's SwiGLU MLP (three int linears, the quantised activations
    of the second product depending on the first two) through the port's
    plain versions against the reference's XLA path on the same packed
    params, f32 activations."""
    jcfg, tcfg = configs("float32")
    jparams = jax.jit(lambda key: jax_convert(
        jlm.init_params(jcfg, key), jlm.model_specs(jcfg), jcfg, NULL_CTX,
        mode=mode))(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(to_numpy(jparams), tcfg, "cpu")
    from repro.models.layers import mlp_apply as jmlp
    from repro_torch.models.layers import mlp_apply as tmlp
    x = rand((2, 5, tcfg.d_model), 8)
    layer0 = jax.tree_util.tree_map(lambda a: a[0],
                                    jparams["blocks"]["l0"]["ffn"])
    with jops.backend("xla"):
        ref = jmlp(layer0, jnp.asarray(x))
    got = tmlp(tlm._layer(tparams["blocks"], 0)["l0"]["ffn"],
               torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
