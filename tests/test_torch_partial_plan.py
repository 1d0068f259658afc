"""The launch plan of the prefix-only partial (``csrc/sparse_attention.cu``,
the split kernel in partial mode), read through the wrapper's own launch
path: the wrapper runs on meta tensors with the C call recorded instead of
made, so every argument the card would get is checked here.

The partial is the fused kernel with no tail panel: one split per
compressed prefix block (``attention_plan(Sb, 0, ...)``), the same 16-row
tiles and shared memory, and an f32 ``lse`` beside ``o``.  At the serving
shape (4 slots, 8 kv heads, 7 prefix blocks, QG = 2) the grid must put at
least 128 blocks on the 132 SMs.  QG = 34 (QG * D = 4352) takes three row
tiles: the reference takes any G, and the port no longer refuses a panel
past ``QG * D = 2048``.  CPU tensors still take the plain version and count
no launch."""
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
BS = 128
SB = 7                                      # the serving shape
LONG_SB = 32                                # 4096 tokens a slot
MIN_BLOCKS = 128            # about one per SM of the H100's 132
SMEM_LIMIT = 232448         # bytes of shared memory a Hopper block may use
POOL = CachePool.build(CFG, 4, SB * BS, bs=BS, device="cpu")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
fn = sa.sparse_decode_attention_partial


def _operands(b, qg, dtype, sb=SB, d=D):
    """The wrapper's arguments on meta tensors: q [B, Hkv, QG, D], the
    compressed prefix [B, Hkv, Sb, X], bs, sm_scale and n_blocks."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    lead = (b, HKV, sb)
    words = BS * d // 32
    return (meta((b, HKV, qg, d), dtype), meta(lead + (words,), torch.int32),
            meta(lead + (POOL.cap_k,), dtype),
            meta(lead + (words,), torch.int32),
            meta(lead + (POOL.cap_v,), dtype), BS, 1.0 / d ** 0.5,
            meta((b,), torch.int32))


def _recorded_launch(monkeypatch, args):
    """Run the wrapper on meta tensors; returns (C entry, geometry, plan
    arguments, scratch, tickets, out, lse)."""
    seen, tensors = [], []
    monkeypatch.setattr(build, "require_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(build, "ptr", lambda t: tensors.append(t))
    monkeypatch.setattr(build, "stream", lambda: None)
    monkeypatch.setattr(build, "call",
                        lambda src, name, argtypes, *a: seen.append(
                            (src, name, len(argtypes), a)))
    monkeypatch.setattr(fn, "launches", 0)
    o, lse = fn(*args)
    assert fn.launches == 1 and len(seen) == 1
    src, name, n_args, c_args = seen[0]
    assert src == "sparse_attention.cu" and n_args == len(c_args)
    # q, q dtype, 4 prefix operands, cache dtype, n_blocks; B, H, QG, D, Sb,
    # bs, ck, cv; sm_scale; splits, row tile, tiles, smem; then scratch,
    # tickets, out, lse and the stream
    geometry, plan = c_args[8:16], c_args[17:21]
    assert c_args[16] == args[6]
    scratch, tickets, out, lse_seen = tensors[-4:]
    assert out is o and lse_seen is lse
    return name, geometry, plan, scratch, tickets, o, lse


@pytest.mark.parametrize("sb", [SB, LONG_SB])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_partial_launch_has_no_tail_split(monkeypatch, dtype, sb):
    """The C entry and the geometry; splits == Sb (no tail panel), tiles ==
    ceil(QG / 16), the fused layout's shared memory; the scratch
    [B, Hkv, Sb, QG, D + 2], out [B, Hkv, QG, D] and lse [B, Hkv, QG], all
    f32; the same plan at every B and QG."""
    size = DTYPES[dtype].itemsize
    plan = sa.attention_plan(sb, 0, BS, D, POOL.cap_k, POOL.cap_v, size)
    fused = sa.attention_plan(sb, CFG.kv_tail, BS, D, POOL.cap_k, POOL.cap_v,
                              size)
    assert plan.splits == sb == fused.splits - CFG.kv_tail // BS
    assert (plan.row_tile, plan.smem) == (fused.row_tile, fused.smem)
    seen = set()
    for b in (1, 4, 7):
        for qg in (1, G, 10, 34):
            name, geometry, launch, scratch, tickets, o, lse = \
                _recorded_launch(monkeypatch,
                                 _operands(b, qg, DTYPES[dtype], sb))
            assert name == "partial_attention_launch"
            assert geometry == (b, HKV, qg, D, sb, BS, POOL.cap_k,
                                POOL.cap_v)
            splits, row_tile, tiles, smem = launch
            assert splits == sb
            assert tiles == -(-qg // 16) == plan.tiles(qg)
            assert scratch.shape == (b, HKV, sb, qg, D + 2)
            assert scratch.dtype == torch.float32
            assert tickets.dtype == torch.int32
            assert tickets.numel() >= b * HKV * tiles
            assert o.shape == (b, HKV, qg, D) and o.dtype == torch.float32
            assert lse.shape == (b, HKV, qg) and lse.dtype == torch.float32
            seen.add((splits, row_tile, smem))
    assert seen == {(plan.splits, plan.row_tile, plan.smem)}


def test_grid_fills_the_card_at_the_serving_shape(monkeypatch):
    """4 slots x 8 kv heads x 7 prefix blocks x 1 row tile at QG = 2: 224
    thread blocks, where the first design launched 32."""
    _, geometry, launch, _, _, _, _ = _recorded_launch(
        monkeypatch, _operands(4, G, torch.bfloat16))
    b, hkv = geometry[:2]
    splits, _, tiles, _ = launch
    assert hkv * b * splits * tiles == 224 >= MIN_BLOCKS


@pytest.mark.parametrize("sb", [SB, LONG_SB])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_partial_shared_memory_fits_a_block(dtype, sb):
    """Every block fits Hopper's 227 KB at 7 and 32 prefix blocks."""
    plan = sa.attention_plan(sb, 0, BS, D, POOL.cap_k, POOL.cap_v,
                             DTYPES[dtype].itemsize)
    assert 0 < plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wide_panel_is_taken(monkeypatch, dtype):
    """QG = 34 (QG * D = 4352, past the first design's 2048) launches three
    row tiles instead of raising."""
    assert 34 * D > 2048
    _, _, launch, _, _, o, lse = _recorded_launch(
        monkeypatch, _operands(4, 34, DTYPES[dtype]))
    assert launch[2] == 3
    assert o.shape == (4, HKV, 34, D) and lse.shape == (4, HKV, 34)


@pytest.mark.parametrize("case", ["no_blocks", "ragged_d", "mixed_dtype"])
def test_partial_refusals_launch_nothing(monkeypatch, case):
    """An empty prefix (Sb = 0), a head dim that is not a multiple of 32 and
    a cache dtype other than q's raise before any launch."""
    monkeypatch.setattr(build, "require_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(fn, "launches", 0)
    if case == "no_blocks":
        args, err = _operands(4, G, torch.bfloat16, sb=0), ValueError
    elif case == "ragged_d":
        args, err = _operands(4, G, torch.bfloat16, d=48), ValueError
    else:
        args = list(_operands(4, G, torch.bfloat16))
        args[2] = torch.empty(args[2].shape, dtype=torch.float32,
                              device="meta")
        err = TypeError
    with pytest.raises(err):
        fn(*args)
    assert fn.launches == 0


def _cpu_case(qg, seed):
    """A small bf16 prefix on the CPU: 4 slots, 2 kv heads, bs 16, D 32,
    3 blocks, per-slot valid counts {3, 2, 1, 0}."""
    rng = np.random.default_rng(seed)
    b, hkv, d, bs, sb = 4, 2, 32, 16, 3

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
    kbm, kvl, vbm, vvl = freeze_chunk_blocks(
        t(b, hkv, sb * bs, d), t(b, hkv, sb * bs, d), 0.3, 0.5, bs, bs * d,
        bs * d)
    return (t(b, hkv, qg, d), kbm, kvl, vbm, vvl, bs, 1.0 / d ** 0.5,
            torch.tensor([3, 2, 1, 0], dtype=torch.int32))


@pytest.mark.parametrize("qg", [2, 34])
def test_cpu_tensors_take_the_plain_version(qg):
    """On CPU tensors the wrapper returns the plain version's bits at any
    panel width and counts nothing."""
    args = _cpu_case(qg, seed=qg)
    before = fn.launches
    o, lse = fn(*args)
    po, plse = sa.sparse_decode_attention_partial_plain(*args)
    assert o.shape == args[0].shape and lse.shape == args[0].shape[:3]
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert fn.launches == before
