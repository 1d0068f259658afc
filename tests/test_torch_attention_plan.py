"""The launch plan of the fused decode attention (``csrc/sparse_attention.cu``,
flat and paged), read through the wrappers' own launch path: the wrappers
run on meta tensors with the C call recorded instead of made, so every
argument the card would get is checked here.

The sequence is split across thread blocks, one split per compressed
prefix block or tail panel, and the splits must depend on (Sb, Tp, bs)
alone: never on the number of slots, the panel width or the lengths (a
meta tensor holds no length to read).  The panel width sets only the
number of 16-row tiles, so a verify panel has no width cap.  At the
serving decode tick (4 slots, 8 kv heads, 7 prefix blocks, a 128-token
ring) the grid must put at least 128 blocks on the 132 SMs, and a bf16
block's shared memory must leave room for two blocks on an SM.  CPU
tensors still take the plain version and count no launch."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.sparse_kv import freeze_chunk_blocks
from repro_torch.kernels import build
from repro_torch.kernels import sparse_attention as sa
from repro_torch.serving.cache_pool import CachePool

# one intra-op torch thread: the port's tests run tiny tensors, which many
# threads only slow down, and the suite's workers share the cores
torch.set_num_threads(1)

CFG = get_config("qwen3-0.6b")
HKV, D = CFG.n_kv, CFG.hd
G = CFG.padded_heads // CFG.n_kv            # 2
BS, TP = 128, CFG.kv_tail                   # a 128-token block and ring
SB = 7                                      # the serving decode tick
MIN_BLOCKS = 128            # about one per SM of the H100's 132
SMEM_LIMIT = 232448         # bytes of shared memory a Hopper block may use
SM_SMEM = 233472            # bytes of shared memory on one SM
BLOCK_RESERVED = 1024       # of which each resident block takes
POOL = CachePool.build(CFG, 4, SB * BS, bs=BS, device="cpu")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
KERNELS = {"flat": sa.sparse_decode_attention_fused,
           "paged": sa.sparse_decode_attention_fused_paged}


def _operands(kernel, b, qn, dtype, sb=SB, n_phys=16):
    """The wrapper's arguments on meta tensors: q [B, Hkv, Q*G, D], the
    compressed prefix (flat [B, Hkv, Sb, X]; paged an arena [n_phys, Hkv,
    X] and a table [B, Sb]), the tail ring and the lengths."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    lead = (n_phys, HKV) if kernel == "paged" else (b, HKV, sb)
    words = BS * D // 32
    prefix = (meta(lead + (words,), torch.int32),
              meta(lead + (POOL.cap_k,), dtype),
              meta(lead + (words,), torch.int32),
              meta(lead + (POOL.cap_v,), dtype))
    if kernel == "paged":
        prefix = prefix + (meta((b, sb), torch.int32),)
    return (meta((b, HKV, qn * G, D), dtype), *prefix,
            meta((b, HKV, TP, D), dtype), meta((b, HKV, TP, D), dtype), BS,
            1.0 / D ** 0.5, meta((b,), torch.int32), meta((b,), torch.int32),
            G)


def _recorded_launch(monkeypatch, kernel, args):
    """Run the wrapper on meta tensors; returns (C entry, geometry, plan
    arguments, scratch, tickets, out)."""
    fn = KERNELS[kernel]
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
    assert src == "sparse_attention.cu" and n_args == len(c_args)
    # ..., B, H, QG, G, D, Sb, bs, ck, cv, Tp, sm_scale, splits, row tile,
    # tiles, smem, then scratch, tickets, out and the stream
    geometry, plan = c_args[-19:-9], c_args[-8:-4]
    scratch, tickets, y = tensors[-3:]
    assert y is out and out.shape == args[0].shape
    assert out.dtype == torch.float32
    return name, geometry, plan, scratch, tickets


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_splits_do_not_depend_on_slots_or_panel_width(monkeypatch, kernel,
                                                      dtype):
    """Splits, row tile and shared memory are the same for every B and QG;
    QG sets the row tiles, B and QG size the scratch and the tickets."""
    plan = sa.attention_plan(SB, TP, BS, D, POOL.cap_k, POOL.cap_v,
                             DTYPES[dtype].itemsize)
    assert plan.splits == SB + TP // BS and plan.row_tile == 16
    seen = set()
    for b in (1, 4, 7):
        for qn in (1, 5, 9, 17):
            qg = qn * G
            name, geometry, launch, scratch, tickets = _recorded_launch(
                monkeypatch, kernel, _operands(kernel, b, qn, DTYPES[dtype]))
            assert name == ("fused_attention_paged_launch" if kernel ==
                            "paged" else "fused_attention_launch")
            assert geometry == (b, HKV, qg, G, D, SB, BS, POOL.cap_k,
                                POOL.cap_v, TP)
            splits, row_tile, tiles, smem = launch
            assert tiles == -(-qg // row_tile) == plan.tiles(qg)
            assert scratch.shape == (b, HKV, splits, qg, D + 2)
            assert scratch.dtype == torch.float32
            assert tickets.dtype == torch.int32
            assert tickets.numel() >= b * HKV * tiles
            seen.add((splits, row_tile, smem))
    assert seen == {(plan.splits, plan.row_tile, plan.smem)}


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_grid_fills_the_card_at_the_decode_tick(monkeypatch, kernel):
    """4 slots x 8 kv heads x (7 prefix blocks + 1 tail panel) x 1 row tile
    at Q = 1: at least 128 thread blocks."""
    _, geometry, launch, _, _ = _recorded_launch(
        monkeypatch, kernel, _operands(kernel, 4, 1, torch.bfloat16))
    b, hkv = geometry[:2]
    splits, _, tiles, _ = launch
    assert hkv * b * splits * tiles >= MIN_BLOCKS


@pytest.mark.parametrize("sb", [SB, 32])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_shared_memory_fits_two_bf16_blocks_an_sm(dtype, sb):
    """Every block fits Hopper's 227 KB; at bf16 two fit on one SM (the
    f32 cache's wider values take one), at 7 and 32 prefix blocks."""
    plan = sa.attention_plan(sb, TP, BS, D, POOL.cap_k, POOL.cap_v,
                             DTYPES[dtype].itemsize)
    assert 0 < plan.smem <= SMEM_LIMIT
    if dtype == "bf16":
        assert 2 * (plan.smem + BLOCK_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_wide_panel_is_taken_and_ragged_panel_refused(monkeypatch, kernel):
    """QG = 34 (k = 16 drafts) launches three row tiles; a panel that is not
    a multiple of G raises before any launch."""
    _, _, launch, _, _ = _recorded_launch(
        monkeypatch, kernel, _operands(kernel, 4, 17, torch.bfloat16))
    assert launch[2] == 3
    args = list(_operands(kernel, 4, 17, torch.bfloat16))
    args[0] = torch.empty((4, HKV, 35, D), dtype=torch.bfloat16,
                          device="meta")
    KERNELS[kernel].launches = 0
    with pytest.raises(ValueError, match="QG=35"):
        KERNELS[kernel](*args)
    assert KERNELS[kernel].launches == 0


def _cpu_case(kernel, qn, seed):
    """A small bf16 cache on the CPU: 4 slots, 2 kv heads, bs 16, D 32,
    3 prefix blocks (paged: an arena of 8 pages), a 32-token ring."""
    rng = np.random.default_rng(seed)
    b, hkv, d, bs, sb, tp = 4, 2, 32, 16, 3, 32

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
    lead = (8, hkv) if kernel == "paged" else (b, hkv)
    k = t(*lead, sb * bs if kernel == "flat" else bs, d)
    v = t(*lead, sb * bs if kernel == "flat" else bs, d)
    kbm, kvl, vbm, vvl = freeze_chunk_blocks(k, v, 0.3, 0.5, bs, bs * d,
                                             bs * d)
    if kernel == "paged":
        kbm, kvl, vbm, vvl = (a[:, :, 0] for a in (kbm, kvl, vbm, vvl))
        prefix = (kbm, kvl, vbm, vvl,
                  torch.tensor([[0, 1, 2], [0, 3, 7], [4, 7, 7], [7] * 3],
                               dtype=torch.int32))
    else:
        prefix = (kbm, kvl, vbm, vvl)
    return (t(b, hkv, qn * 2, d), *prefix, t(b, hkv, tp, d), t(b, hkv, tp, d),
            bs, 1.0 / d ** 0.5, torch.tensor([3, 2, 1, 0], dtype=torch.int32),
            torch.tensor([5, tp, 0, 0], dtype=torch.int32), 2)


@pytest.mark.parametrize("qn", [1, 9, 17])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_cpu_tensors_take_the_plain_version(kernel, qn):
    """On CPU tensors both wrappers return the plain version's bits at any
    panel width and count nothing."""
    args = _cpu_case(kernel, qn, seed=qn)
    plain = (sa.sparse_decode_attention_fused_paged_plain
             if kernel == "paged" else sa.sparse_decode_attention_fused_plain)
    before = [fn.launches for fn in KERNELS.values()]
    got = KERNELS[kernel](*args)
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    assert torch.equal(got, plain(*args))
    assert [fn.launches for fn in KERNELS.values()] == before
