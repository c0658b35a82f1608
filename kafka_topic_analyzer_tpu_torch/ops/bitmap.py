"""Packed-bit alive-key bitmap (port of the reference's ``ops/bitmap.py``,
the host-deduped apply paths).

Same observable semantics as the reference's fnv32-indexed ``BitSet``: a
key is alive iff its latest record has a non-null value, and hash
collisions conflate keys exactly as the 32-bit hash does.  The host has
already resolved last-writer-wins per slot (packing.pack_pair_table), so
the device only applies (slot, alive) pairs or set/clear word masks.

Words are ``int32[W]`` bit patterns (`_torch_support`): bit 31 of a word is
``INT32_MIN``, and every mask below is built, ORed, ANDed and negated
bitwise, so the two's-complement reading never enters the arithmetic.
The one add — summing the bits of one word's pairs — adds *distinct* bits
(slots are unique), and a sum of distinct bits equals their OR in two's
complement too: no partial sum leaves the int32 range.

Updates are in place: the state owns its words (the reference's step is
pure; its buffers are donated instead).
"""

from __future__ import annotations

import torch

from kafka_topic_analyzer_tpu_torch._torch_support import bit_i32, u32_low_bits


def bitmap_num_words(bits: int) -> int:
    return 1 << max(bits - 5, 0)


def bitmap_scratch(bits: int, device) -> torch.Tensor:
    """The all-zero ``int32[W]`` word accumulator `bitmap_apply_pairs`
    uses.  Allocate once per state and pass to every apply: each apply
    re-zeroes only the words it touched, so a 2^32-slot bitmap does not
    pay a 512 MiB allocation and fill per dispatch."""
    return torch.zeros(bitmap_num_words(bits), dtype=torch.int32, device=device)


def bitmap_apply_pairs(
    words: torch.Tensor,       # int32[W] packed bits
    slot: torch.Tensor,        # int32[T] u32 bit patterns; prefix n_pairs live
    alive_flag: torch.Tensor,  # uint8[T] 1 = the slot's last record had a value
    n_pairs: torch.Tensor,     # int32 scalar — live prefix length
    bits: int,
    scratch: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Apply host-deduped (slot, aliveness) pairs in place:
    ``words = (words & ~clear) | set`` over the touched words only.

    Each live slot appears once, so the bits landing in one word are
    distinct and an integer ``index_add_`` builds that word's mask.  The
    masks accumulate in ``scratch`` (see `bitmap_scratch`), are applied by
    gather/scatter at the touched words, and are zeroed again there.
    Padding entries add no bit and point at word 0: they read word 0's
    finished mask like any live entry there, so every write to one word
    carries the same value and the scatter is order-free — with no
    data-dependent shape, hence no device→host sync."""
    w = bitmap_num_words(bits)
    if scratch is None:
        scratch = bitmap_scratch(bits, words.device)
    s = u32_low_bits(slot)
    live = torch.arange(slot.shape[0], device=slot.device) < n_pairs
    live = live & (s < w * 32)
    word = torch.where(live, s >> 5, 0)
    bit = torch.where(live, bit_i32(s & 31), 0)
    alive = alive_flag.to(torch.bool)
    # Clear-then-set equals the reference's (words & ~clear) | set: a slot
    # is either cleared or set, never both.
    for mask, is_clear in ((torch.where(alive, 0, bit), True),
                           (torch.where(alive, bit, 0), False)):
        scratch.index_add_(0, word, mask)
        acc = scratch[word]
        scratch[word] = 0
        cur = words[word]
        words[word] = cur & ~acc if is_clear else cur | acc
    return words


def bitmap_apply_masks(
    words: torch.Tensor,        # int32[W]
    set_words: torch.Tensor,    # int32[W] LWW set mask
    clear_words: torch.Tensor,  # int32[W] LWW clear mask
) -> torch.Tensor:
    """Apply host-built set/clear word masks in place: one elementwise
    ``(words & ~clear) | set`` pass, no scatter."""
    return words.bitwise_and_(~clear_words).bitwise_or_(set_words)
