"""The launch plan of the sparse matmul kernels (``csrc/sparse_matmul.cu``)
at the seven Qwen3-0.6B linears, read through the wrappers' own launch
path: the wrappers run on meta tensors with the C call recorded instead of
made, so every argument the card would get is checked here.

The plan must not depend on M (a speculative verify row must equal the
decode row of the same token), must put at least 128 thread blocks on the
132 SMs at a 20-row verify panel, and must fit Hopper's shared memory.
CPU tensors still take the plain version and count no launch."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.pruning import make_mask
from repro_torch.core.sparse_format import (BlockSparseWeight,
                                            DEFAULT_BLOCK, pack)
from repro_torch.kernels import build
from repro_torch.kernels import sparse_matmul as mm
from repro_torch.models import lm

M_VALUES = (9, 16, 20, 256, 300)
VERIFY_ROWS = 20            # 4 slots x (k = 4 drafts + 1)
MIN_BLOCKS = 128            # about one per SM of the H100's 132
SMEM_LIMIT = 232448         # bytes of shared memory a Hopper block may use
KERNELS = {"bf16": (mm.sparse_matmul, torch.bfloat16, torch.bfloat16),
           "f32": (mm.sparse_matmul_f32, torch.float32, torch.bfloat16),
           "f32, f32 values": (mm.sparse_matmul_f32, torch.float32,
                               torch.float32)}


def _linears():
    blk = lm.model_specs(get_config("qwen3-0.6b"))["blocks"]["l0"]
    return [(name, s.shape[-2], s.shape[-1])
            for part in ("mixer", "ffn") for name, s in blk[part].items()
            if len(s.shape) == 3]


LINEARS = _linears()


def _meta_weight(k, n, v_dtype, block=DEFAULT_BLOCK):
    bk, bn = block
    kb, nb = -(-k // bk), -(-n // bn)
    return BlockSparseWeight(
        torch.empty((kb, nb, bk * bn // 32), dtype=torch.int32,
                    device="meta"),
        torch.empty((kb, nb, bk * bn // 2), dtype=v_dtype, device="meta"),
        None, (k, n), block)


def _recorded_launch(monkeypatch, fn, x, sw):
    """Run the wrapper on meta tensors; returns (C entry, its int
    arguments, the scratch's shape)."""
    seen, tensors = [], []
    monkeypatch.setattr(build, "require_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(build, "ptr", lambda t: tensors.append(t))
    monkeypatch.setattr(build, "stream", lambda: None)
    monkeypatch.setattr(build, "call",
                        lambda src, name, argtypes, *a: seen.append(
                            (src, name, len(argtypes), a)))
    monkeypatch.setattr(fn, "launches", 0)
    out = fn(x, sw)
    assert fn.launches == 1 and len(seen) == 1
    src, name, n_args, args = seen[0]
    assert src == "sparse_matmul.cu" and n_args == len(args)
    partial, y = tensors[3], tensors[4]
    assert partial.dtype == torch.float32 and y.shape == (x.shape[0],
                                                          sw.padded_shape[1])
    assert out.shape == (x.shape[0], sw.shape[1])
    ints = tuple(a for a in args if isinstance(a, int))
    return name, ints, tuple(partial.shape)


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("name,k,n", LINEARS)
def test_plan_does_not_depend_on_m(monkeypatch, kernel, name, k, n):
    """Splits, their boundaries and their order, the grid and the shared
    memory are the same at every M; M sizes only the scratch's rows."""
    fn, x_dtype, v_dtype = KERNELS[kernel]
    sw = _meta_weight(k, n, v_dtype)
    plan = mm.launch_plan(k, n, DEFAULT_BLOCK, x_dtype.itemsize,
                          v_dtype.itemsize)
    launches = {}
    for m in M_VALUES:
        x = torch.empty((m, k), dtype=x_dtype, device="meta")
        entry, ints, pshape = _recorded_launch(monkeypatch, fn, x, sw)
        assert ints[0] == m and pshape == (len(plan.splits), m, n)
        launches[m] = (entry, ints[1:], pshape[0], pshape[2])
    assert len(set(launches.values())) == 1, launches
    # the launch carries the plan: rows per split and the shared memory
    assert launches[VERIFY_ROWS][1][-2:] == (plan.rows_per_split, plan.smem)
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


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("name,k,n", LINEARS)
def test_plan_fits_shared_memory(kernel, name, k, n):
    """The shared memory a block asks for fits in Hopper's 227 KB."""
    _, x_dtype, v_dtype = KERNELS[kernel]
    plan = mm.launch_plan(k, n, DEFAULT_BLOCK, x_dtype.itemsize,
                          v_dtype.itemsize)
    assert 0 < plan.smem <= SMEM_LIMIT


def _cpu_weight(k, n, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k))
                         .astype(np.float32)).to(torch.bfloat16)
    mask = make_mask(w, 0.5, "balanced", DEFAULT_BLOCK)
    return pack(w, mask, DEFAULT_BLOCK)


@pytest.mark.parametrize("kernel", ["bf16", "f32"])
@pytest.mark.parametrize("m", M_VALUES)
def test_cpu_tensors_take_the_plain_version_at_every_m(kernel, m):
    """On CPU tensors both wrappers return the plain version's bits and
    count nothing, at every row count the card's gates use."""
    fn, x_dtype, _ = KERNELS[kernel]
    sw = _cpu_weight(1024, 1024, seed=m)
    rng = np.random.default_rng(100 + m)
    x = torch.from_numpy(rng.standard_normal((m, 1024)).astype(np.float32))
    x = x.to(x_dtype)
    before = mm.sparse_matmul.launches, mm.sparse_matmul_f32.launches
    got = fn(x, sw)
    assert got.dtype == x_dtype and got.shape == (m, 1024)
    assert torch.equal(got, mm.sparse_matmul_plain(x, sw))
    assert (mm.sparse_matmul.launches,
            mm.sparse_matmul_f32.launches) == before
