"""The launch plan of the sparse matmul kernels (``csrc/sparse_matmul.cu``)
and of the int8 / int4 kernels (``csrc/sparse_matmul_int8.cu``) at the
seven Qwen3-0.6B linears, read through the wrappers' own launch path: the
wrappers run on meta tensors with the C call recorded instead of made, so
every argument the card would get is checked here.

The plan must not depend on M (a speculative verify row must equal the
decode row of the same token), must put at least 128 thread blocks on the
132 SMs at a 20-row verify panel (the int kernels: at a 4-row decode
tick), and must fit Hopper's shared memory.  CPU tensors still take the
plain version and count no launch."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.convert import _to_int4
from repro_torch.core.pruning import make_mask
from repro_torch.core.quant import quantize_act_int8, quantize_weight_int8
from repro_torch.core.sparse_format import (BlockSparseWeight,
                                            DEFAULT_BLOCK, pack)
from repro_torch.kernels import build
from repro_torch.kernels import sparse_matmul as mm
from repro_torch.kernels import sparse_matmul_int4 as mm4
from repro_torch.kernels import sparse_matmul_int8 as mm8
from repro_torch.models import lm

# one intra-op torch thread: the port's tests run tiny tensors, which many
# threads only slow down, and the suite's workers share the cores
torch.set_num_threads(1)

M_VALUES = (9, 16, 20, 256, 300)
INT_M_VALUES = (1, 4, 8) + M_VALUES     # the int kernels serve every M
VERIFY_ROWS = 20            # 4 slots x (k = 4 drafts + 1)
DECODE_ROWS = 4             # 4 slots, one token each
MIN_BLOCKS = 128            # about one per SM of the H100's 132
SMEM_LIMIT = 232448         # bytes of shared memory a Hopper block may use
# (wrapper, x dtype, values dtype); int kernels take int8 xq and f32 sx
KERNELS = {"bf16": (mm.sparse_matmul, torch.bfloat16, torch.bfloat16),
           "f32": (mm.sparse_matmul_f32, torch.float32, torch.bfloat16),
           "f32, f32 values": (mm.sparse_matmul_f32, torch.float32,
                               torch.float32),
           "int8": (mm8.sparse_matmul_int8, torch.int8, torch.int8),
           "int4": (mm4.sparse_matmul_int4, torch.int8, torch.uint8)}
INT_KERNELS = ("int8", "int4")


def _linears():
    blk = lm.model_specs(get_config("qwen3-0.6b"))["blocks"]["l0"]
    return [(name, s.shape[-2], s.shape[-1])
            for part in ("mixer", "ffn") for name, s in blk[part].items()
            if len(s.shape) == 3]


LINEARS = _linears()


def _meta_weight(k, n, v_dtype, block=DEFAULT_BLOCK):
    """A weight on meta tensors; uint8 values are nibble pairs (int4) and
    int values carry a per-column scale."""
    bk, bn = block
    kb, nb = -(-k // bk), -(-n // bn)
    int4 = v_dtype == torch.uint8
    scale = (torch.empty((n,), dtype=torch.float32, device="meta")
             if v_dtype in (torch.int8, torch.uint8) else None)
    return BlockSparseWeight(
        torch.empty((kb, nb, bk * bn // 32), dtype=torch.int32,
                    device="meta"),
        torch.empty((kb, nb, bk * bn // (4 if int4 else 2)), dtype=v_dtype,
                    device="meta"),
        scale, (k, n), block, packed4=int4)


def _plan(kernel, k, n, block=DEFAULT_BLOCK):
    _, x_dtype, v_dtype = KERNELS[kernel]
    if kernel in INT_KERNELS:
        return mm8.int_launch_plan(k, n, block, kernel == "int4")
    return mm.launch_plan(k, n, block, x_dtype.itemsize, v_dtype.itemsize)


def _call(kernel, m, k, sw):
    """The wrapper's arguments for an ``m``-row input, on meta tensors."""
    _, x_dtype, _ = KERNELS[kernel]
    x = torch.empty((m, k), dtype=x_dtype, device="meta")
    if kernel in INT_KERNELS:
        return (x, torch.empty((m,), dtype=torch.float32, device="meta"), sw)
    return (x, sw)


def _recorded_launch(monkeypatch, kernel, args):
    """Run the wrapper on meta tensors; returns (C entry, its int
    arguments, the scratch)."""
    fn = KERNELS[kernel][0]
    sw = args[-1]
    seen, tensors = [], []
    monkeypatch.setattr(build, "require_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(build, "ptr", lambda t: tensors.append(t))
    monkeypatch.setattr(build, "stream", lambda: None)
    monkeypatch.setattr(build, "call",
                        lambda src, name, argtypes, *a: seen.append(
                            (src, name, len(argtypes), a)))
    monkeypatch.setattr(fn, "launches", 0)
    out = fn(*args)
    assert fn.launches == 1 and len(seen) == 1
    src, name, n_args, c_args = seen[0]
    assert n_args == len(c_args)
    m = args[0].shape[0]
    if kernel in INT_KERNELS:
        # xq, bitmap, values, sx, scale, partial, out: [M, N] written once
        assert src == "sparse_matmul_int8.cu"
        partial, y = tensors[5], tensors[6]
        assert partial.dtype == torch.int32 and y.shape == (m, sw.shape[1])
    else:
        # x, bitmap, values, partial, out: [M, padded N], cut after
        assert src == "sparse_matmul.cu"
        partial, y = tensors[3], tensors[4]
        assert partial.dtype == torch.float32 \
            and y.shape == (m, sw.padded_shape[1])
    assert out.shape == (m, sw.shape[1])
    ints = tuple(a for a in c_args if isinstance(a, int))
    return name, ints, partial


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("name,k,n", LINEARS)
def test_plan_does_not_depend_on_m(monkeypatch, kernel, name, k, n):
    """Splits, their boundaries and their order, the grid and the shared
    memory are the same at every M; M sizes only the scratch's rows."""
    _, _, v_dtype = KERNELS[kernel]
    sw = _meta_weight(k, n, v_dtype)
    plan = _plan(kernel, k, n)
    launches = {}
    for m in INT_M_VALUES if kernel in INT_KERNELS else M_VALUES:
        entry, ints, partial = _recorded_launch(monkeypatch, kernel,
                                                _call(kernel, m, k, sw))
        assert ints[0] == m and partial.shape == (len(plan.splits), m, n)
        launches[m] = (entry, ints[1:], partial.shape[0], partial.shape[2])
    assert len(set(launches.values())) == 1, launches
    # the launch carries the plan: rows per split and the shared memory,
    # last for bf16 / f32, before N and the output dtype for int8 / int4
    ints = launches[VERIFY_ROWS][1]
    at = ints[-4:-2] if kernel in INT_KERNELS else ints[-2:]
    assert at == (plan.rows_per_split, plan.smem)
    # the splits tile the padded K in ascending order, one summation order
    bk = DEFAULT_BLOCK[0]
    flat = [(b * bk + r0, b * bk + r1) for b, r0, r1 in plan.splits]
    assert flat[0][0] == 0 and flat[-1][1] == plan.kb * bk
    assert all(a[1] == b[0] for a, b in zip(flat, flat[1:]))
    assert all(r1 - r0 == plan.rows_per_split for r0, r1 in flat)


@pytest.mark.parametrize("name,k,n", LINEARS)
def test_plan_fills_the_card_at_the_verify_panel(name, k, n):
    """At least 128 thread blocks per linear at M = 20, and the grid is
    one block per (column block, split)."""
    plan = mm.launch_plan(k, n, DEFAULT_BLOCK)
    assert plan.blocks >= MIN_BLOCKS
    assert plan.blocks == plan.nb * len(plan.splits)
    assert plan.splits == mm.launch_plan(k, n, DEFAULT_BLOCK, 4, 4).splits


@pytest.mark.parametrize("kernel", INT_KERNELS)
@pytest.mark.parametrize("name,k,n", LINEARS)
def test_int_plan_fills_the_card_at_a_decode_tick(monkeypatch, kernel, name,
                                                  k, n):
    """At a 4-row decode tick ``launch_int`` launches at least 128 thread
    blocks, one per (column block, split), allocates the plan's int32
    scratch and hands the C launcher the plan's arguments."""
    int4 = kernel == "int4"
    sw = _meta_weight(k, n, KERNELS[kernel][2])
    plan = mm8.int_launch_plan(k, n, DEFAULT_BLOCK, int4)
    assert plan.blocks >= MIN_BLOCKS
    assert plan.blocks == plan.nb * len(plan.splits)
    entry, ints, partial = _recorded_launch(
        monkeypatch, kernel, _call(kernel, DECODE_ROWS, k, sw))
    assert entry == "sparse_matmul_int_launch"
    assert partial.shape == (len(plan.splits), DECODE_ROWS,
                             plan.nb * DEFAULT_BLOCK[1])
    bk, bn = DEFAULT_BLOCK
    assert ints == (DECODE_ROWS, k, int(int4), plan.kb, plan.nb, bk, bn,
                    sw.capacity, sw.values.shape[-1], plan.rows_per_split,
                    plan.smem, n, build.DTYPE_CODE[torch.float32])


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("name,k,n", LINEARS)
def test_plan_fits_shared_memory(kernel, name, k, n):
    """The shared memory a block asks for fits in Hopper's 227 KB."""
    plan = _plan(kernel, k, n)
    assert 0 < plan.smem <= SMEM_LIMIT


def _cpu_weight(k, n, seed, kernel="bf16"):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k))
                         .astype(np.float32)).to(torch.bfloat16)
    mask = make_mask(w, 0.5, "balanced", DEFAULT_BLOCK)
    if kernel not in INT_KERNELS:
        return pack(w, mask, DEFAULT_BLOCK)
    q, scale = quantize_weight_int8(torch.where(mask, w, torch.zeros_like(w)))
    sw = pack(q, mask, DEFAULT_BLOCK, scale=scale)
    return _to_int4(sw) if kernel == "int4" else sw


@pytest.mark.parametrize("kernel", ["bf16", "f32"] + list(INT_KERNELS))
@pytest.mark.parametrize("m", M_VALUES)
def test_cpu_tensors_take_the_plain_version_at_every_m(kernel, m):
    """On CPU tensors every wrapper returns the plain version's bits and
    counts nothing, at every row count the card's gates use."""
    fn, x_dtype, _ = KERNELS[kernel]
    sw = _cpu_weight(1024, 1024, seed=m, kernel=kernel)
    rng = np.random.default_rng(100 + m)
    x = torch.from_numpy(rng.standard_normal((m, 1024)).astype(np.float32))
    counters = (mm.sparse_matmul, mm.sparse_matmul_f32,
                mm8.sparse_matmul_int8, mm4.sparse_matmul_int4)
    before = [c.launches for c in counters]
    if kernel in INT_KERNELS:
        xq, sx = quantize_act_int8(x.to(torch.bfloat16))
        got = fn(xq, sx, sw, torch.bfloat16)
        assert got.dtype == torch.bfloat16 and got.shape == (m, 1024)
        assert torch.equal(got, mm8.sparse_matmul_int8_plain(
            xq, sx, sw, torch.bfloat16))
    else:
        x = x.to(x_dtype)
        got = fn(x, sw)
        assert got.dtype == x_dtype and got.shape == (m, 1024)
        assert torch.equal(got, mm.sparse_matmul_plain(x, sw))
    assert [c.launches for c in counters] == before
