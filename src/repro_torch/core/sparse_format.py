"""Blocked bitmap + packed-values sparse format (twin of
``repro.core.sparse_format``).

A dense ``W[K, N]`` is cut into ``(bk, bn)`` blocks.  Each block's keep-mask
is packed into 32-bit words (bit ``b`` of word ``j`` is flat row-major
position ``32*j + b``) and its kept values are packed, in the same order,
into a fixed per-tensor capacity ``C``.

The reference stores uint32 words; here they are **int32 bit-views** of the
same bits (torch's uint32 supports few operations).  A right shift of an
int32 is arithmetic, so every bit test is written ``(w >> b) & 1``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

DEFAULT_BLOCK = (256, 128)
LANE = 128  # value capacity is rounded up to this


def _ceil_to(x: int, m: int) -> int:
    return int(-(-x // m) * m)


@dataclasses.dataclass
class BlockSparseWeight:
    """A ``[K, N]`` weight stored as bitmap + packed values.

    bitmap:  int32 ``[..., Kb, Nb, bk*bn // 32]`` bit-view words.
    values:  ``[..., Kb, Nb, C]`` packed non-zeros (row-major within block).
    scale:   optional f32 ``[N_pad]`` per-output-channel scale (int8 mode).
    shape:   logical (un-padded) ``(K, N)``.
    block:   ``(bk, bn)``.
    packed4: values hold two int4 nibbles per uint8 byte, low nibble
             first (the paper's §8 int4 extension).
    """
    bitmap: torch.Tensor
    values: torch.Tensor
    scale: Optional[torch.Tensor]
    shape: Tuple[int, int]
    block: Tuple[int, int]
    packed4: bool = False

    @property
    def capacity(self) -> int:
        c = self.values.shape[-1]
        return c * 2 if self.packed4 else c

    @property
    def padded_shape(self) -> Tuple[int, int]:
        bk, bn = self.block
        return self.bitmap.shape[-3] * bk, self.bitmap.shape[-2] * bn

    @property
    def lead_shape(self) -> Tuple[int, ...]:
        return tuple(self.bitmap.shape[:-3])

    def layer(self, i: int) -> "BlockSparseWeight":
        """Slice one entry off the leading (layer-stacked) axis."""
        return BlockSparseWeight(
            self.bitmap[i], self.values[i],
            None if self.scale is None else self.scale[i],
            self.shape, self.block, self.packed4)

    def to(self, device) -> "BlockSparseWeight":
        return BlockSparseWeight(
            self.bitmap.to(device), self.values.to(device),
            None if self.scale is None else self.scale.to(device),
            self.shape, self.block, self.packed4)

    def nbytes_compressed(self) -> int:
        n = self.bitmap.numel() * 4 + \
            self.values.numel() * self.values.element_size()
        if self.scale is not None:
            n += self.scale.numel() * self.scale.element_size()
        return n

    def nbytes_dense(self) -> int:
        k, n = self.shape
        lead = 1
        for d in self.lead_shape:
            lead *= d
        return lead * k * n * self.values.element_size()

    def compression_ratio(self) -> float:
        """compressed bytes / dense bytes (lower is better)."""
        return self.nbytes_compressed() / self.nbytes_dense()


# ---------------------------------------------------------------------------
# int4 nibble packing (paper §8: int4 values are dequantised to int8 before
# the product)
# ---------------------------------------------------------------------------

def pack_nibbles(v: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., C]`` in ``[-8, 7]`` -> uint8 ``[..., C//2]`` (lo | hi<<4)."""
    if v.shape[-1] % 2 != 0:
        raise ValueError(f"nibble packing needs an even channel dim, got "
                         f"{v.shape[-1]}")
    u = v.to(torch.uint8) & 0xF
    lo, hi = u[..., 0::2], u[..., 1::2]
    return lo | (hi << 4)


def unpack_nibbles(b: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles` -> int8 ``[..., 2C]``, each nibble
    sign-extended by ``(x ^ 8) - 8``."""
    lo = (b & 0xF).to(torch.int8)
    hi = (b >> 4).to(torch.int8)
    sext = lambda x: (x ^ 8) - 8
    out = torch.stack([sext(lo), sext(hi)], dim=-1)
    return out.reshape(*b.shape[:-1], b.shape[-1] * 2)


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------

def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """``[..., L]`` 0/1 mask -> ``[..., L//32]`` int32 bit-view words."""
    l = mask.shape[-1]
    if l % 32 != 0:
        raise ValueError(f"mask length {l} not a multiple of 32")
    m = mask.to(torch.int64).reshape(*mask.shape[:-1], l // 32, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (m << shifts).sum(-1)                      # in [0, 2**32)
    # two's-complement wrap into int32 (same bits as the uint32 word)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_bits(words: torch.Tensor, length: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits` -> int32 0/1 mask ``[..., length]``."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1            # arithmetic >>, masked
    out = bits.reshape(*words.shape[:-1], words.shape[-1] * 32)
    return out[..., :length].to(torch.int32)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def _to_blocks(w: torch.Tensor, block: Tuple[int, int],
               pad_to_blocks: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """``[K, N]`` -> ``[Kb, Nb, bk*bn]`` (row-major within block), padding."""
    bk, bn = block
    k, n = w.shape
    kp = _ceil_to(_ceil_to(k, bk) // bk, pad_to_blocks[0]) * bk
    np_ = _ceil_to(_ceil_to(n, bn) // bn, pad_to_blocks[1]) * bn
    w = F.pad(w, (0, np_ - n, 0, kp - k))
    kb, nb = kp // bk, np_ // bn
    w = w.reshape(kb, bk, nb, bn).permute(0, 2, 1, 3)
    return w.reshape(kb, nb, bk * bn)


def _from_blocks(blocks: torch.Tensor, block: Tuple[int, int],
                 shape: Tuple[int, int]) -> torch.Tensor:
    """``[..., Kb, Nb, bk*bn]`` -> ``[..., K, N]`` (strips padding)."""
    bk, bn = block
    *lead, kb, nb, _ = blocks.shape
    w = blocks.reshape(*lead, kb, nb, bk, bn)
    w = torch.movedim(w, -2, -3)                       # [..., Kb, bk, Nb, bn]
    w = w.reshape(*lead, kb * bk, nb * bn)
    return w[..., : shape[0], : shape[1]]


def _topk_stable(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, ties broken
    toward the lower index — the order ``lax.top_k`` guarantees (a plain
    ``torch.topk`` promises none)."""
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


def _cap_mask(wb: torch.Tensor, mb: torch.Tensor, cap: int) -> torch.Tensor:
    """Drop the smallest-|.| overflow entries of any block whose nnz exceeds
    ``cap`` — from the mask, so bitmap and packed values never disagree."""
    score = torch.where(mb, wb.abs().to(torch.float32),
                        torch.full((), float("-inf"), device=wb.device))
    idx = _topk_stable(score, cap)
    sel = torch.zeros_like(mb)
    sel.scatter_(-1, idx, True)
    return mb & sel


def pack_blocks(wb: torch.Tensor, mb: torch.Tensor, cap: int,
                cap_may_truncate: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack pre-blocked values ``wb [..., L]`` under bool mask ``mb`` at a
    static per-block capacity -> (int32 bitmap ``[..., L//32]``, values
    ``[..., cap]``).  Overflow past ``cap`` is dropped from bitmap and values
    together (magnitude order) unless ``cap_may_truncate=False``."""
    l = wb.shape[-1]
    cap = min(int(cap), l)
    mb = mb.to(torch.bool)
    if cap < l and cap_may_truncate:
        mb = _cap_mask(wb, mb, cap)
    mb_i = mb.to(torch.int64)
    excl = torch.cumsum(mb_i, dim=-1) - mb_i           # rank among kept
    # kept entries land at their rank; everything else at a dump slot
    dest = torch.where(mb & (excl < cap), excl, torch.full_like(excl, cap))
    vals = torch.zeros(*wb.shape[:-1], cap + 1, dtype=wb.dtype,
                       device=wb.device)
    vals.scatter_(-1, dest, wb)
    return pack_bits(mb), vals[..., :cap].contiguous()


def pack(w: torch.Tensor, mask: torch.Tensor,
         block: Tuple[int, int] = DEFAULT_BLOCK,
         capacity: Optional[int] = None,
         pad_to_blocks: Tuple[int, int] = (1, 1),
         scale: Optional[torch.Tensor] = None) -> BlockSparseWeight:
    """Pack ``w`` (zeroed outside ``mask``) into the blocked sparse format.

    ``capacity`` defaults to the max block nnz rounded up to ``LANE``."""
    bk, bn = block
    if (bk * bn) % 32 != 0:
        raise ValueError(f"block {block} must cover a multiple of 32 entries")
    wb = _to_blocks(w, block, pad_to_blocks)
    mb = _to_blocks(mask.to(w.dtype), block, pad_to_blocks) > 0
    if capacity is None:
        nnz = mb.to(torch.int64).sum(-1)
        cap = _ceil_to(max(int(nnz.max()), 1), LANE)
    else:
        cap = int(capacity)
    cap = min(cap, bk * bn)
    bitmap, vals = pack_blocks(wb, mb, cap,
                               cap_may_truncate=capacity is not None)
    if scale is not None:
        n_pad = wb.shape[1] * bn
        scale = F.pad(scale.to(torch.float32), (0, n_pad - scale.shape[0]))
    return BlockSparseWeight(bitmap=bitmap, values=vals, scale=scale,
                             shape=(int(w.shape[0]), int(w.shape[1])),
                             block=tuple(block))


def repack_capacity(sw: BlockSparseWeight, capacity: int
                    ) -> BlockSparseWeight:
    """Re-store ``sw`` at exactly ``capacity`` packed values per block.

    Growing pads the values (a bit-exact round trip).  Shrinking re-ranks
    each block's kept entries by magnitude and drops the overflow from the
    bitmap and the values together, so :func:`unpack` of the result always
    equals the dense weight its own bitmap describes."""
    if sw.packed4:
        raise ValueError("repack of nibble-packed int4 not supported")
    cap = int(capacity)
    if cap == sw.capacity:
        return sw
    if cap > sw.capacity:
        vals = F.pad(sw.values, (0, cap - sw.values.shape[-1]))
        return BlockSparseWeight(sw.bitmap, vals, sw.scale, sw.shape,
                                 sw.block, sw.packed4)
    # shrink: decompress block-locally, re-pack at the smaller capacity
    mask, idx = block_gather_indices(sw.bitmap, sw.block)
    idx = idx.clamp(max=sw.capacity - 1)
    dense_flat = torch.gather(sw.values, -1, idx)
    dense_flat = torch.where(mask > 0, dense_flat,
                             torch.zeros((), dtype=sw.values.dtype,
                                         device=sw.values.device))
    bitmap, vals = pack_blocks(dense_flat, mask > 0, cap)
    return BlockSparseWeight(bitmap, vals, sw.scale, sw.shape, sw.block,
                             sw.packed4)


def block_gather_indices(bitmap: torch.Tensor, block: Tuple[int, int]):
    """Bitmap -> (mask int32 ``[..., L]``, exclusive-prefix gather index
    int64 ``[..., L]``): the popcount + prefix-sum half of decompression."""
    bk, bn = block
    mask = unpack_bits(bitmap, bk * bn)
    idx = torch.cumsum(mask, dim=-1) - mask
    return mask, idx.to(torch.int64)


def unpack(sw: BlockSparseWeight, trim: bool = True) -> torch.Tensor:
    """Decompress to a dense ``[..., K, N]`` weight (leading dims broadcast);
    nibble-packed int4 values come back as int8."""
    mask, idx = block_gather_indices(sw.bitmap, sw.block)
    idx = idx.clamp(max=sw.capacity - 1)
    values = unpack_nibbles(sw.values) if sw.packed4 else sw.values
    dense_flat = torch.gather(values, -1, idx)
    dense_flat = torch.where(mask > 0, dense_flat,
                             torch.zeros((), dtype=values.dtype,
                                         device=values.device))
    shape = sw.shape if trim else sw.padded_shape
    return _from_blocks(dense_flat, sw.block, shape)


# decompressed CPU weights (:func:`unpack_padded`, which only the plain
# matmuls call: their weights persist), least recently used first out;
# each entry holds its packed arrays' storages, so no other tensor can take
# their addresses while it lives
_DENSE: "OrderedDict[tuple, tuple]" = OrderedDict()
_DENSE_MAX = 256


def _storage_key(t: torch.Tensor) -> tuple:
    return (t.untyped_storage().data_ptr(), t.storage_offset(),
            tuple(t.shape), t.stride(), t.dtype, t._version)


def unpack_padded(sw: BlockSparseWeight) -> torch.Tensor:
    """``unpack(sw, trim=False)``: the padded dense weight the plain
    matmuls multiply by.  On the CPU the result is kept for the same packed
    arrays (same storage, offset, shape, strides and version counter), so
    the weights a serving loop runs every tick decompress once; the values
    are those :func:`unpack` returns, bit for bit.  Device tensors
    decompress at every call."""
    if sw.values.device.type != "cpu":
        return unpack(sw, trim=False)
    key = (_storage_key(sw.bitmap), _storage_key(sw.values), sw.block,
           sw.shape, sw.packed4)
    hit = _DENSE.get(key)
    if hit is not None:
        _DENSE.move_to_end(key)
        return hit[0]
    w = unpack(sw, trim=False)
    _DENSE[key] = (w, sw.bitmap.untyped_storage(),
                   sw.values.untyped_storage())
    if len(_DENSE) > _DENSE_MAX:
        _DENSE.popitem(last=False)
    return w


def balanced_capacity(density: float,
                      block: Tuple[int, int] = DEFAULT_BLOCK) -> int:
    bk, bn = block
    return min(_ceil_to(max(int(round(density * bk * bn)), 1), LANE), bk * bn)
