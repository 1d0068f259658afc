"""The launch plan of the sparse gemv (``csrc/sparse_gemv.cu``) and of the
dense unembedding (``csrc/dense_matmul.cu``), read through the wrappers'
own launch path: the wrappers run on meta tensors with the C call recorded
instead of made, so every argument the card would get is checked here.

The gemv's splits must depend on (K, N, block) alone, never on M (a verify
row must equal the decode row of the same token), it must launch no fewer
thread blocks than the first design's grid, two of its blocks must fit an
SM, and its partial scratch and tickets, allocated once per device, must
cover every linear.  The unembedding must tile the vocabulary exactly, fit
shared memory at every serving M, and take one launch (one pass over the
table) per call up to 64 rows.  CPU tensors still take the plain versions
and count no launch."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.pruning import make_mask
from repro_torch.core.sparse_format import (BlockSparseWeight,
                                            DEFAULT_BLOCK, pack)
from repro_torch.kernels import build
from repro_torch.kernels import dense_matmul as dm
from repro_torch.kernels import sparse_gemv as gv
from repro_torch.models import lm

CFG = get_config("qwen3-0.6b")
SMEM_LIMIT = 232448         # bytes of shared memory a Hopper block may use
SM_SMEM = 233472            # bytes of shared memory on one SM
BLOCK_RESERVED = 1024       # of which each resident block takes
MIN_BLOCKS = 128            # about one per SM of the H100's 132
FIRST_ROWS_PER_CTA = 64     # the first design's rows per thread block
UNEMBED_M = (1, 4, 16, 20, 36)  # prefill, decode, paged / flat / f32 verify
# (x dtype, values dtype): serving, the f32 engine, and the other two
GEMV_DTYPES = {"bf16": (torch.bfloat16, torch.bfloat16),
               "f32 x": (torch.float32, torch.bfloat16),
               "f32": (torch.float32, torch.float32),
               "bf16 x, f32 values": (torch.bfloat16, torch.float32)}
WEIGHT_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _linears(cfg):
    blk = lm.model_specs(cfg)["blocks"]["l0"]
    return [(name, s.shape[-2], s.shape[-1])
            for part in ("mixer", "ffn") for name, s in blk[part].items()
            if len(s.shape) == 3]


LINEARS = _linears(CFG)
REDUCED_LINEARS = [(f"reduced {name}", k, n)
                   for name, k, n in _linears(CFG.reduced())]


def _meta_weight(k, n, v_dtype, block=DEFAULT_BLOCK):
    bk, bn = block
    kb, nb = -(-k // bk), -(-n // bn)
    return BlockSparseWeight(
        torch.empty((kb, nb, bk * bn // 32), dtype=torch.int32,
                    device="meta"),
        torch.empty((kb, nb, bk * bn // 2), dtype=v_dtype, device="meta"),
        None, (k, n), block)


def _record(monkeypatch, fn):
    """Patch the build layer so ``fn``'s C calls are recorded; returns the
    list of (source, entry, int arguments, tensors handed over)."""
    seen = []
    tensors = []
    monkeypatch.setattr(build, "require_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(build, "ptr", lambda t: tensors.append(t) or t)
    monkeypatch.setattr(build, "stream", lambda: None)

    def call(src, name, argtypes, *a):
        assert len(argtypes) == len(a)
        seen.append((src, name, tuple(v for v in a if isinstance(v, int)),
                     list(tensors)))
        tensors.clear()
    monkeypatch.setattr(build, "call", call)
    monkeypatch.setattr(fn, "launches", 0)
    return seen


def _gemv_launch(monkeypatch, m, k, n, dtypes):
    x_dtype, v_dtype = dtypes
    sw = _meta_weight(k, n, v_dtype)
    seen = _record(monkeypatch, gv.sparse_gemv)
    x = torch.empty((m, k), dtype=x_dtype, device="meta")
    out = gv.sparse_gemv(x, sw)
    assert gv.sparse_gemv.launches == 1 and len(seen) == 1
    src, entry, ints, tensors = seen[0]
    assert (src, entry) == ("sparse_gemv.cu", "sparse_gemv_launch")
    assert out.shape == (m, n) and out.dtype == x_dtype
    # x, bitmap, values, partial, tickets, out
    return ints, tensors[3], tensors[4], tensors[5]


@pytest.mark.parametrize("dtypes", list(GEMV_DTYPES))
@pytest.mark.parametrize("name,k,n", LINEARS + REDUCED_LINEARS)
def test_gemv_plan_does_not_depend_on_m(monkeypatch, dtypes, name, k, n):
    """Splits, their boundaries and order, the grid and the shared memory
    are the same at every M = 1 .. 8; M (the launch's int after x's
    dtype code) sizes only the part of the scratch a call uses."""
    x_dtype, v_dtype = GEMV_DTYPES[dtypes]
    plan = gv.gemv_plan(k, n, DEFAULT_BLOCK, x_dtype.itemsize,
                        v_dtype.itemsize)
    launches = set()
    for m in range(1, gv.MAX_ROWS + 1):
        ints, partial, tickets, y = _gemv_launch(
            monkeypatch, m, k, n, GEMV_DTYPES[dtypes])
        assert ints[:2] == (build.DTYPE_CODE[x_dtype], m)
        assert partial.dtype == torch.float32 and tickets.dtype == torch.int32
        assert partial.numel() >= len(plan.splits) * m * plan.nb * \
            DEFAULT_BLOCK[1]
        assert y.shape == (m, plan.nb * DEFAULT_BLOCK[1])
        launches.add(ints[2:])
    assert len(launches) == 1, launches
    # ... rows per split, splits, shared memory at the end of the launch
    assert launches.pop()[-3:] == (plan.rows_per_split, len(plan.splits),
                                   plan.smem)
    # the splits tile the padded K in ascending order, one summation order
    bk = DEFAULT_BLOCK[0]
    flat = [(b * bk + r0, b * bk + r1) for b, r0, r1 in plan.splits]
    assert flat[0][0] == 0 and flat[-1][1] == plan.kb * bk
    assert all(a[1] == b[0] for a, b in zip(flat, flat[1:]))


@pytest.mark.parametrize("name,k,n", LINEARS)
def test_gemv_launches_no_fewer_blocks_than_the_first_grid(name, k, n):
    """One block per (column block, split): at least the first design's
    grid (Nb x Kb x bk / 64, 128-384 blocks a linear) and 128."""
    plan = gv.gemv_plan(k, n, DEFAULT_BLOCK)
    bk, bn = DEFAULT_BLOCK
    first = -(-n // bn) * -(-k // bk) * -(-bk // FIRST_ROWS_PER_CTA)
    assert plan.blocks == plan.nb * len(plan.splits)
    assert plan.blocks >= max(first, MIN_BLOCKS)


@pytest.mark.parametrize("dtypes", list(GEMV_DTYPES))
@pytest.mark.parametrize("name,k,n", LINEARS + REDUCED_LINEARS)
def test_gemv_shared_memory_fits_two_blocks_an_sm(dtypes, name, k, n):
    x_dtype, v_dtype = GEMV_DTYPES[dtypes]
    plan = gv.gemv_plan(k, n, DEFAULT_BLOCK, x_dtype.itemsize,
                        v_dtype.itemsize)
    assert 0 < plan.smem <= SMEM_LIMIT
    assert 2 * (plan.smem + BLOCK_RESERVED) <= SM_SMEM


def test_gemv_scratch_covers_every_linear_and_is_kept(monkeypatch):
    """The partials and the tickets are allocated once per device and
    grown to the largest plan; a second pass over the layer at M = 8
    allocates nothing and reuses the same buffers."""
    monkeypatch.setattr(gv, "_SCRATCH", {})
    held = []
    for _ in range(2):
        for _, k, n in LINEARS:
            _, partial, tickets, _ = _gemv_launch(
                monkeypatch, gv.MAX_ROWS, k, n, GEMV_DTYPES["bf16"])
            held.append((partial, tickets))
    plans = [gv.gemv_plan(k, n, DEFAULT_BLOCK) for _, k, n in LINEARS]
    partial, tickets = held[-1]
    assert partial.numel() >= max(p.scratch for p in plans)
    assert tickets.numel() >= max(p.nb for p in plans)
    assert all(p.scratch == len(p.splits) * gv.MAX_ROWS * p.nb *
               DEFAULT_BLOCK[1] for p in plans)
    second = held[len(LINEARS):]
    assert all(a is partial and b is tickets for a, b in second)


def test_gemv_refuses_more_rows_and_odd_blocks(monkeypatch):
    _record(monkeypatch, gv.sparse_gemv)
    sw = _meta_weight(1024, 1024, torch.bfloat16)
    with pytest.raises(ValueError, match="m<=8"):
        gv.sparse_gemv(torch.empty((9, 1024), dtype=torch.bfloat16,
                                   device="meta"), sw)
    odd = _meta_weight(1024, 1024, torch.bfloat16, block=(200, 100))
    with pytest.raises(ValueError, match="16-aligned"):
        gv.sparse_gemv(torch.empty((4, 1024), dtype=torch.bfloat16,
                                   device="meta"), odd)
    assert gv.sparse_gemv.launches == 0


@pytest.mark.parametrize("dtype", list(WEIGHT_DTYPES))
@pytest.mark.parametrize("m", UNEMBED_M)
def test_unembed_plan_covers_the_vocab_and_fits(monkeypatch, dtype, m):
    """151936 = 1187 x 128 table rows in whole tiles, x's rows padded to
    16 (bf16) or to the f32 bucket, shared memory within 227 KB, and one
    launch carrying the plan's M and bytes."""
    dt = WEIGHT_DTYPES[dtype]
    plan = dm.dense_plan(m, CFG.d_model, CFG.vocab, dt.itemsize)
    assert plan.tiles * dm.TILE == CFG.vocab == 151936
    assert plan.rows >= m and (plan.rows % 16 == 0 or dtype == "f32")
    assert 0 < plan.smem <= SMEM_LIMIT
    seen = _record(monkeypatch, dm.dense_matmul)
    x = torch.empty((m, CFG.d_model), dtype=dt, device="meta")
    tok = torch.empty((CFG.vocab, CFG.d_model), dtype=dt, device="meta")
    out = dm.dense_matmul(x, tok, torch.float32)
    assert out.shape == (m, CFG.vocab) and out.dtype == torch.float32
    assert dm.dense_matmul.launches == 1 and len(seen) == 1
    src, entry, ints, _ = seen[0]
    assert (src, entry) == ("dense_matmul.cu", "dense_matmul_launch")
    assert ints == (build.DTYPE_CODE[dt], m, CFG.d_model, CFG.vocab,
                    CFG.d_model, plan.smem)


@pytest.mark.parametrize("dtype", list(WEIGHT_DTYPES))
def test_unembed_plan_fits_every_row_count_of_a_launch(dtype):
    dt = WEIGHT_DTYPES[dtype]
    for m in range(1, dm.MAX_ROWS + 1):
        assert dm.dense_plan(m, CFG.d_model, CFG.vocab,
                             dt.itemsize).smem <= SMEM_LIMIT


def test_unembed_takes_one_launch_per_64_rows(monkeypatch):
    """A 100-row call is two launches (rows 0-63 and 64-99), the second on
    x and the output from row 64."""
    seen = _record(monkeypatch, dm.dense_matmul)
    x = torch.empty((100, CFG.d_model), dtype=torch.bfloat16, device="meta")
    tok = torch.empty((CFG.vocab, CFG.d_model), dtype=torch.bfloat16,
                      device="meta")
    dm.dense_matmul(x, tok, torch.float32)
    assert dm.dense_matmul.launches == 2
    assert [s[2][1] for s in seen] == [64, 36]
    assert seen[1][3][0].shape == (36, CFG.d_model)


@pytest.mark.parametrize("dtype", list(WEIGHT_DTYPES))
def test_dense_linears_take_the_rows_that_fit(monkeypatch, dtype):
    """Dense weights (``--dense``) run every linear through this kernel: at
    Qwen3-0.6B's K = 1024, 2048 and 3072 a bf16 launch takes 64, 32 and 16
    rows (x staged whole must fit shared memory), f32 64; a 100-row call
    at K = 3072 is launches of 16 rows, each plan within 227 KB."""
    dt = WEIGHT_DTYPES[dtype]
    want = {1024: 64, 2048: 32, 3072: 16} if dtype == "bf16" else \
        dict.fromkeys((1024, 2048, 3072), 64)
    for k, rows in want.items():
        assert dm.launch_rows(k, dt.itemsize) == rows
        assert dm.dense_plan(rows, k, 1024, dt.itemsize).smem <= SMEM_LIMIT
    seen = _record(monkeypatch, dm.dense_matmul)
    x = torch.empty((100, 3072), dtype=dt, device="meta")
    w = torch.empty((1024, 3072), dtype=dt, device="meta")
    out = dm.dense_matmul(x, w, torch.float32)
    assert out.shape == (100, 1024)
    step = want[3072]
    assert [s[2][1] for s in seen] == [min(step, 100 - r)
                                       for r in range(0, 100, step)]
    with pytest.raises(ValueError, match="do not fit"):
        dm.launch_rows(8192, 2)


def test_unembed_refuses_what_16_byte_copies_cannot_take(monkeypatch):
    _record(monkeypatch, dm.dense_matmul)
    tok = torch.empty((512, 100), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="multiples of 8"):
        dm.dense_matmul(torch.empty((4, 100), dtype=torch.bfloat16,
                                    device="meta"), tok)
    tok = torch.empty((512, 1024), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unit column stride"):
        dm.dense_matmul(torch.empty((4, 512), dtype=torch.bfloat16,
                                    device="meta"), tok.t())
    assert dm.dense_matmul.launches == 0


def _cpu_weight(k, n, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k))
                         .astype(np.float32)).to(torch.bfloat16)
    return pack(w, make_mask(w, 0.5, "balanced", DEFAULT_BLOCK),
                DEFAULT_BLOCK)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", range(1, 9))
def test_cpu_gemv_takes_the_plain_version(m, x_dtype):
    sw = _cpu_weight(512, 384, seed=m)
    rng = np.random.default_rng(200 + m)
    x = torch.from_numpy(rng.standard_normal((m, 512)).astype(
        np.float32)).to(x_dtype)
    before = gv.sparse_gemv.launches
    got = gv.sparse_gemv(x, sw)
    assert got.dtype == x_dtype and got.shape == (m, 384)
    assert torch.equal(got, gv.sparse_gemv_plain(x, sw))
    assert gv.sparse_gemv.launches == before


@pytest.mark.parametrize("dtype", list(WEIGHT_DTYPES))
@pytest.mark.parametrize("m", UNEMBED_M)
def test_cpu_unembed_takes_the_plain_version(m, dtype):
    dt = WEIGHT_DTYPES[dtype]
    rng = np.random.default_rng(300 + m)
    tok = torch.from_numpy((rng.standard_normal((1000, 128)) * 0.02)
                           .astype(np.float32)).to(dt)
    x = torch.from_numpy(rng.standard_normal((m, 128)).astype(
        np.float32)).to(dt)
    before = dm.dense_matmul.launches
    got = dm.dense_matmul(x, tok, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, 1000)
    assert torch.equal(got, dm.dense_matmul_plain(x, tok, torch.float32))
    assert dm.dense_matmul.launches == before
