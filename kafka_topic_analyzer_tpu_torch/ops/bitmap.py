"""Packed-bit alive-key bitmap (port of the reference's ``ops/bitmap.py``,
the host-deduped apply paths).

Same observable semantics as the reference's fnv32-indexed ``BitSet``: a
key is alive iff its latest record has a non-null value, and hash
collisions conflate keys exactly as the 32-bit hash does.  The host has
already resolved last-writer-wins per slot (packing.pack_pair_table), so
the device only applies (slot, alive) pairs or set/clear word masks.

Words are ``int32[W]`` bit patterns (`_torch_support`): bit 31 of a word is
``INT32_MIN``.  Masks are built, ORed, ANDed and negated bitwise; the one
add — the plain pair apply's per-word sum — adds or takes away *distinct*
bits of one word, which in two's complement (wrapping modulo 2^32) equals
setting or clearing them.

The pair form goes through the hand-written CUDA kernel
(``csrc/bitmap_pairs.cu``: one atomic OR or AND-NOT a pair, straight on the
words) on a card, and through `bitmap_apply_pairs_plain` only for CPU
tensors; neither holds a bitmap-sized temporary.  Updates are in place:
the state owns its words (the reference's step is pure; its buffers are
donated instead).

Under a space-sharded mesh (``space_shards`` S > 1) each space shard owns
the contiguous slot range ``[idx·W·32, (idx+1)·W·32)`` of the bitmap,
``W = bitmap_num_words(bits, S)`` words: the pair form masks every pair
to that range, the mask form slices its word range out of the
full-bitmap masks.
"""

from __future__ import annotations

import struct

import torch

from kafka_topic_analyzer_tpu_torch import _build
from kafka_topic_analyzer_tpu_torch._torch_support import bit_i32, u32_low_bits

_I32 = torch.int32
_U8 = torch.uint8
#: The C entry's argument record (``KtaPairsArgs`` in the source): words,
#: slot, flag, n_pairs, capacity, the shard's first slot and its slot
#: count, stream, device.
_KERNEL = _build.Kernel("bitmap_pairs", "kta_bitmap_apply_pairs",
                        struct.Struct("<QQQQqQQQq"))


def bitmap_num_words(bits: int, space_shards: int = 1) -> int:
    """Words of one space shard's slice of a ``2^bits``-slot bitmap."""
    total_words = 1 << max(bits - 5, 0)
    if total_words % space_shards:
        raise ValueError(
            f"2^{bits} slots not divisible into {space_shards} space shards"
        )
    return total_words // space_shards


def bitmap_apply_pairs_plain(
    words: torch.Tensor,       # int32[W] packed bits
    slot: torch.Tensor,        # int32[T] u32 bit patterns; prefix n_pairs live
    alive_flag: torch.Tensor,  # uint8[T] 1 = the slot's last record had a value
    n_pairs: torch.Tensor,     # int32 scalar — live prefix length
    bits: int,
    space_index: int = 0,
    space_shards: int = 1,
) -> torch.Tensor:
    """The plain PyTorch version, in place: ``words = (words & ~clear) |
    set`` over the touched words, with T-sized temporaries only.

    Each pair reads its word once (``cur``) and adds the change of its own
    bit: ``bit & ~cur`` to set it, ``-(bit & cur)`` to clear it.  Each live
    slot appears once, so the changes that land in one word are of distinct
    bits and their sum, added by one ``index_add_``, sets and clears exactly
    those bits (bit 31, ``INT32_MIN``, wraps in two's complement).  Padding
    entries and pairs outside space shard ``space_index``'s slot range add
    0 to word 0."""
    w = bitmap_num_words(bits, space_shards)
    s = u32_low_bits(slot) - w * 32 * space_index
    live = torch.arange(slot.shape[0], device=slot.device) < n_pairs
    live = live & (s >= 0) & (s < w * 32)
    word = torch.where(live, s >> 5, 0)
    bit = torch.where(live, bit_i32(s & 31), 0)
    cur = words[word]
    delta = torch.where(alive_flag.to(torch.bool), bit & ~cur, -(bit & cur))
    return words.index_add_(0, word, delta)


def _check(words, slot, alive_flag, n_pairs, bits: int, space_index: int,
           space_shards: int) -> torch.device:
    """Raise what the kernel does not take; return the tensors' device.  It
    runs on every call, so it reads each attribute once."""
    try:
        if not (words.dtype is _I32 and slot.dtype is _I32
                and alive_flag.dtype is _U8 and n_pairs.dtype is _I32):
            raise TypeError(
                "bitmap_apply_pairs needs int32 words, int32 slots, uint8 "
                f"flags and an int32 n_pairs, got {words.dtype}, {slot.dtype}, "
                f"{alive_flag.dtype} and {n_pairs.dtype}"
            )
        if not 0 <= space_index < space_shards:
            raise ValueError(
                f"bitmap_apply_pairs: space_index {space_index} outside "
                f"{space_shards} space shards"
            )
        w = bitmap_num_words(bits, space_shards)
        if words.shape != (w,):
            raise ValueError(
                f"bitmap_apply_pairs needs [{w}] words for 2^{bits} slots in "
                f"{space_shards} space shard(s), got {tuple(words.shape)}"
            )
        if slot.dim() != 1 or alive_flag.shape != slot.shape:
            raise ValueError(
                "bitmap_apply_pairs needs 1-d slots and flags of one length, "
                f"got {tuple(slot.shape)} and {tuple(alive_flag.shape)}"
            )
        if n_pairs.numel() != 1:
            raise ValueError(
                "bitmap_apply_pairs needs n_pairs as one value, got "
                f"{tuple(n_pairs.shape)}"
            )
        dev = words.device
        if not (slot.device == dev and alive_flag.device == dev
                and n_pairs.device == dev):
            raise ValueError(
                f"bitmap_apply_pairs device mismatch: words on {dev}, slots on "
                f"{slot.device}, flags on {alive_flag.device}, n_pairs on "
                f"{n_pairs.device}"
            )
        if not (words.is_contiguous() and slot.is_contiguous()
                and alive_flag.is_contiguous()):
            raise ValueError("bitmap_apply_pairs needs contiguous tensors")
        if (words.data_ptr() | slot.data_ptr() | n_pairs.data_ptr()) & 3:
            raise ValueError(
                "bitmap_apply_pairs needs 4-byte aligned words, slots and "
                "n_pairs"
            )
        if not (words.is_cuda or words.is_cpu):
            raise ValueError(f"bitmap_apply_pairs runs on cuda or cpu, not {dev}")
    except AttributeError:  # an argument that is not a tensor
        got = [type(a).__name__ for a in (words, slot, alive_flag, n_pairs)
               if not isinstance(a, torch.Tensor)]
        raise TypeError(
            f"bitmap_apply_pairs takes tensors, got {', '.join(got)}"
        ) from None
    return dev


def bitmap_apply_pairs(
    words: torch.Tensor,       # int32[W] packed bits
    slot: torch.Tensor,        # int32[T] u32 bit patterns; prefix n_pairs live
    alive_flag: torch.Tensor,  # uint8[T] 1 = the slot's last record had a value
    n_pairs: torch.Tensor,     # int32 scalar — live prefix length
    bits: int,
    space_index: int = 0,
    space_shards: int = 1,
) -> torch.Tensor:
    """Apply host-deduped (slot, aliveness) pairs in place: ``words =
    (words & ~clear) | set``; returns ``words``.  ``words`` is space shard
    ``space_index``'s slice: pairs outside its slot range change nothing.

    CUDA tensors launch the kernel on the current stream (and add one to
    ``bitmap_apply_pairs.launches``); it reads ``n_pairs`` on the device,
    so nothing waits for the host.  CPU tensors take
    `bitmap_apply_pairs_plain`.  Anything else raises."""
    dev = _check(words, slot, alive_flag, n_pairs, bits, space_index,
                 space_shards)
    if dev.type == "cpu":
        return bitmap_apply_pairs_plain(
            words, slot, alive_flag, n_pairs, bits, space_index, space_shards
        )
    span = words.shape[0] * 32
    _KERNEL.launch(
        dev, words.data_ptr(), slot.data_ptr(), alive_flag.data_ptr(),
        n_pairs.data_ptr(), slot.shape[0], span * space_index, span,
    )
    bitmap_apply_pairs.launches += 1
    return words


#: Kernel launches since import (or since a caller reset it to 0).
bitmap_apply_pairs.launches = 0


def bitmap_apply_masks(
    words: torch.Tensor,        # int32[W] this space shard's words
    set_words: torch.Tensor,    # int32[W_total] LWW set mask
    clear_words: torch.Tensor,  # int32[W_total] LWW clear mask
    space_index: int = 0,
    space_shards: int = 1,
) -> torch.Tensor:
    """Apply host-built set/clear word masks in place: one elementwise
    ``(words & ~clear) | set`` pass, no scatter.  Space shard
    ``space_index`` takes its word range of the full-bitmap masks."""
    if space_shards > 1:
        w = words.shape[0]
        lo = w * space_index
        set_words = set_words[lo : lo + w]
        clear_words = clear_words[lo : lo + w]
    return words.bitwise_and_(~clear_words).bitwise_or_(set_words)
