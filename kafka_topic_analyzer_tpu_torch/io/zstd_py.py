"""Pure-Python zstd (RFC 8878) frame decoder (port of the reference's
``io/zstd_py.py``, unchanged).

Fallback for `io/compression.py::zstd_decompress` when libzstd isn't
loadable.  librdkafka gives the reference zstd support for free
(the reference's Cargo.toml:19 — rdkafka statically links the full C
client); this build's fast path is ctypes-on-libzstd, and this module keeps
the wire client correct without it — same split as the snappy/LZ4 decoders.

Scope: single/multi-frame streams, skippable frames, raw/RLE/compressed
blocks, Huffman literals (direct + FSE-compressed weights, 1- and 4-stream),
FSE sequences (predefined/RLE/compressed/repeat modes), repeat offsets.
Dictionaries are rejected (Kafka record batches never use them).  Content
checksums are skipped, not verified (byte-identical behavior to librdkafka's
default ZSTD_d_ignoreChecksum=0?  No — libzstd verifies; a mismatch there
raises too, via the native path).

Like the sibling decoders, every malformed input must raise ValueError —
fuzzed by tests/test_zstd.py over random garbage and truncations.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

ZSTD_MAGIC = 0xFD2FB528
SKIPPABLE_MAGIC_MIN = 0x184D2A50
SKIPPABLE_MAGIC_MAX = 0x184D2A5F

#: Hard output bound, mirrored from compression.MAX_DECOMPRESSED at call
#: time (passed in) — documented here for readers.
_BLOCK_MAX = 128 * 1024


class CorruptZstdStream(ValueError):
    """Classified malformed-zstd error: every decode failure in this
    module raises this (never a bare ValueError/struct.error/IndexError),
    so the codec layer can map it onto the corruption taxonomy
    (io/kafka_codec.py ``BadCompressionError``) while callers written
    against the historical ValueError contract keep working."""


_Err = CorruptZstdStream  # short internal alias (raised ~60x below)


# ---------------------------------------------------------------------------
# bitstreams


class _BackBits:
    """zstd backward bitstream: bytes are a little-endian integer; the
    highest set bit of the final byte is a sentinel; bits are read from
    just below it, downward.  Reads past the start yield zero bits (the
    spec's defined behavior near stream end); `pos` going far negative
    means corrupt input."""

    __slots__ = ("val", "pos")

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise _Err("zstd: backward bitstream missing sentinel")
        self.val = int.from_bytes(data, "little")
        self.pos = 8 * len(data) - 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        if self.pos >= 0:
            return (self.val >> self.pos) & ((1 << n) - 1)
        return (self.val << -self.pos) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        p = self.pos - n
        if p >= 0:
            return (self.val >> p) & ((1 << n) - 1)
        return (self.val << -p) & ((1 << n) - 1)


class _FwdBits:
    """Forward little-endian bitstream (FSE table descriptions)."""

    __slots__ = ("data", "bitpos")

    def __init__(self, data: bytes):
        self.data = data
        self.bitpos = 0

    def read(self, n: int) -> int:
        end = self.bitpos + n
        if end > 8 * len(self.data):
            raise _Err("zstd: FSE description overruns its stream")
        lo_byte = self.bitpos >> 3
        hi_byte = (end + 7) >> 3
        chunk = int.from_bytes(self.data[lo_byte:hi_byte], "little")
        out = (chunk >> (self.bitpos & 7)) & ((1 << n) - 1)
        self.bitpos = end
        return out

    def bytes_consumed(self) -> int:
        return (self.bitpos + 7) >> 3


# ---------------------------------------------------------------------------
# FSE


def _read_fse_distribution(
    data: bytes, max_accuracy: int, max_symbol: int
) -> Tuple[List[int], int, int]:
    """FSE_readNCount: (probabilities, accuracy_log, bytes_consumed).
    Probabilities may include -1 ("less than one")."""
    br = _FwdBits(data)
    accuracy_log = br.read(4) + 5
    if accuracy_log > max_accuracy:
        raise _Err(f"zstd: FSE accuracy {accuracy_log} > max {max_accuracy}")
    remaining = (1 << accuracy_log) + 1
    threshold = 1 << accuracy_log
    nbits = accuracy_log + 1
    probs: List[int] = []
    previous0 = False
    while remaining > 1:
        if len(probs) > max_symbol:
            raise _Err("zstd: FSE distribution has too many symbols")
        if previous0:
            while True:
                rep = br.read(2)
                probs.extend([0] * rep)
                if rep < 3:
                    break
            previous0 = False
            continue
        maxv = 2 * threshold - 1 - remaining
        v = br.read(nbits - 1)
        if v < maxv:
            count = v  # small value: fits in nbits-1 bits
        else:
            v |= br.read(1) << (nbits - 1)
            count = v if v < threshold else v - maxv
        count -= 1  # encoded +1; -1 means "less than one"
        remaining -= -count if count < 0 else count
        if remaining < 0:
            raise _Err("zstd: FSE distribution exceeds table size")
        probs.append(count)
        previous0 = count == 0
        while remaining < threshold and threshold > 1:
            nbits -= 1
            threshold >>= 1
    if len(probs) > max_symbol + 1:
        raise _Err("zstd: FSE distribution has too many symbols")
    return probs, accuracy_log, br.bytes_consumed()


def _build_fse_table(
    probs: List[int], accuracy_log: int
) -> Tuple[List[int], List[int], List[int]]:
    """FSE decode table → (symbol, nb_bits, new_state_base) per state."""
    size = 1 << accuracy_log
    symbols = [0] * size
    high = size - 1
    for s, p in enumerate(probs):
        if p == -1:
            symbols[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, p in enumerate(probs):
        if p <= 0:
            continue
        for _ in range(p):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise _Err("zstd: corrupt FSE distribution (spread mismatch)")
    occur = [1 if p == -1 else max(p, 0) for p in probs]
    nb_bits = [0] * size
    new_state = [0] * size
    for u in range(size):
        s = symbols[u]
        x = occur[s]
        occur[s] = x + 1
        nb = accuracy_log - (x.bit_length() - 1)
        nb_bits[u] = nb
        new_state[u] = (x << nb) - size
    return symbols, nb_bits, new_state


class _FseDecoder:
    """One interactive FSE state machine over a backward bitstream."""

    __slots__ = ("symbols", "nb_bits", "new_state", "accuracy_log", "state")

    def __init__(self, probs: List[int], accuracy_log: int):
        self.symbols, self.nb_bits, self.new_state = _build_fse_table(
            probs, accuracy_log
        )
        self.accuracy_log = accuracy_log
        self.state = 0

    def init_state(self, br: _BackBits) -> None:
        self.state = br.read(self.accuracy_log)

    def symbol(self) -> int:
        return self.symbols[self.state]

    def update(self, br: _BackBits) -> None:
        self.state = self.new_state[self.state] + br.read(
            self.nb_bits[self.state]
        )


class _RleDecoder:
    """Degenerate one-symbol 'FSE' table (Symbol_Compression_Mode 1)."""

    __slots__ = ("sym", "accuracy_log")

    def __init__(self, sym: int):
        self.sym = sym
        self.accuracy_log = 0

    def init_state(self, br: _BackBits) -> None:
        pass

    def symbol(self) -> int:
        return self.sym

    def update(self, br: _BackBits) -> None:
        pass


# ---------------------------------------------------------------------------
# Huffman


def _huffman_weights_fse(data: bytes) -> List[int]:
    """Weights compressed with FSE (header byte < 128): two interleaved
    states decode until the backward bitstream is exhausted."""
    probs, al, consumed = _read_fse_distribution(data, 6, 255)
    table = _build_fse_table(probs, al)
    symbols, nb_bits, new_state = table
    br = _BackBits(data[consumed:])
    s1 = br.read(al)
    s2 = br.read(al)
    weights: List[int] = []
    # Two states take turns; when a state's update exhausts the bitstream,
    # the OTHER state emits its final symbol and decoding stops.
    while True:
        if len(weights) > 255:
            raise _Err("zstd: too many Huffman weights")
        weights.append(symbols[s1])
        s1 = new_state[s1] + br.read(nb_bits[s1])
        if br.pos < 0:
            weights.append(symbols[s2])
            break
        weights.append(symbols[s2])
        s2 = new_state[s2] + br.read(nb_bits[s2])
        if br.pos < 0:
            weights.append(symbols[s1])
            break
    return weights


def _huffman_table(data: bytes) -> Tuple[List[Tuple[int, int]], int, int]:
    """Parse a Huffman tree description.  Returns (decode_table, max_bits,
    bytes_consumed) where decode_table[prefix] = (symbol, code_bits)."""
    if not data:
        raise _Err("zstd: empty Huffman description")
    hb = data[0]
    if hb >= 128:
        n = hb - 127
        nbytes = (n + 1) // 2
        if 1 + nbytes > len(data):
            raise _Err("zstd: truncated Huffman weights")
        weights = []
        for i in range(n):
            b = data[1 + i // 2]
            weights.append((b >> 4) if i % 2 == 0 else (b & 0xF))
        consumed = 1 + nbytes
    else:
        if 1 + hb > len(data):
            raise _Err("zstd: truncated Huffman FSE weights")
        weights = _huffman_weights_fse(data[1 : 1 + hb])
        consumed = 1 + hb
    # Last weight is implied so the code space sums to a power of two
    # (smallest 2^max_bits strictly greater than the partial sum).
    total = sum((1 << (w - 1)) for w in weights if w > 0)
    if total == 0:
        raise _Err("zstd: Huffman weights empty")
    max_bits = total.bit_length()
    if max_bits > 11:  # zstd's Huffman code length limit
        raise _Err("zstd: Huffman max bits exceeds 11")
    rest = (1 << max_bits) - total
    if rest <= 0 or rest & (rest - 1):
        raise _Err("zstd: Huffman weights do not sum to a power of two")
    weights.append(rest.bit_length())  # 2^(w-1) = rest
    # Prefix table: ascending weight (longest codes first), symbols in
    # natural order within a weight.
    table: List[Tuple[int, int]] = [(0, 0)] * (1 << max_bits)
    cur = 0
    for w in range(1, max_bits + 1):
        for sym, sw in enumerate(weights):
            if sw != w:
                continue
            bits = max_bits + 1 - w
            span = 1 << (w - 1)
            if cur + span > len(table):
                raise _Err("zstd: Huffman code space overflow")
            for i in range(cur, cur + span):
                table[i] = (sym, bits)
            cur += span
    if cur != len(table):
        raise _Err("zstd: Huffman code space underfilled")
    return table, max_bits, consumed


def _huffman_decode_stream(
    data: bytes, table: List[Tuple[int, int]], max_bits: int, n: int
) -> bytearray:
    br = _BackBits(data)
    out = bytearray()
    while len(out) < n:
        sym, bits = table[br.peek(max_bits)]
        br.pos -= bits
        if br.pos < -max_bits:
            raise _Err("zstd: Huffman stream overrun")
        out.append(sym)
    return out


# ---------------------------------------------------------------------------
# sequences: code → (baseline, extra_bits)

_LL_BASE = (
    [(i, 0) for i in range(16)]
    + [(16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3),
       (40, 3), (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10),
       (2048, 11), (4096, 12), (8192, 13), (16384, 14), (32768, 15),
       (65536, 16)]
)
_ML_BASE = (
    [(i + 3, 0) for i in range(32)]
    + [(35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3),
       (59, 3), (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9),
       (1027, 10), (2051, 11), (4099, 12), (8195, 13), (16387, 14),
       (32771, 15), (65539, 16)]
)

_LL_DEFAULT = (
    [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2,
     2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1],
    6,
)
_ML_DEFAULT = (
    [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, -1, -1, -1, -1, -1, -1, -1],
    6,
)
_OF_DEFAULT = (
    [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, -1, -1, -1, -1, -1],
    5,
)

_MAX_ACCURACY = {"ll": 9, "of": 8, "ml": 9}
_MAX_SYMBOL = {"ll": 35, "of": 31, "ml": 52}
_DEFAULTS = {"ll": _LL_DEFAULT, "of": _OF_DEFAULT, "ml": _ML_DEFAULT}

for _name, (_probs, _al) in _DEFAULTS.items():
    assert sum(1 if p == -1 else p for p in _probs) == 1 << _al, _name


def _sequence_decoder(
    kind: str, mode: int, data: bytes, prev, out_consumed: List[int]
):
    """Build the LL/OF/ML decoder for one block per its compression mode.
    Appends bytes consumed from `data` to out_consumed."""
    if mode == 0:  # predefined
        probs, al = _DEFAULTS[kind]
        out_consumed.append(0)
        return _FseDecoder(probs, al)
    if mode == 1:  # RLE
        if not data:
            raise _Err("zstd: missing RLE symbol byte")
        out_consumed.append(1)
        sym = data[0]
        if sym > _MAX_SYMBOL[kind]:
            raise _Err(f"zstd: RLE {kind} symbol {sym} out of range")
        return _RleDecoder(sym)
    if mode == 2:  # FSE-compressed distribution
        probs, al, used = _read_fse_distribution(
            data, _MAX_ACCURACY[kind], _MAX_SYMBOL[kind]
        )
        out_consumed.append(used)
        return _FseDecoder(probs, al)
    if prev is None:  # mode 3: repeat
        raise _Err(f"zstd: repeat {kind} table with no previous table")
    out_consumed.append(0)
    return prev


# ---------------------------------------------------------------------------
# block + frame decode


class _FrameCtx:
    """State carried across blocks within a frame: the previous Huffman
    table (treeless literals) and previous FSE tables (repeat mode), plus
    the rolling repeat offsets."""

    def __init__(self):
        self.huffman: "Optional[Tuple[List[Tuple[int, int]], int]]" = None
        self.fse = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def _decode_literals(data: bytes, ctx: _FrameCtx) -> Tuple[bytearray, int]:
    if not data:
        raise _Err("zstd: empty literals section")
    b0 = data[0]
    lb_type = b0 & 3
    size_format = (b0 >> 2) & 3
    if lb_type <= 1:  # Raw / RLE
        if size_format in (0, 2):
            rs, hdr = b0 >> 3, 1
        elif size_format == 1:
            if len(data) < 2:
                raise _Err("zstd: truncated literals header")
            rs, hdr = (b0 >> 4) | (data[1] << 4), 2
        else:
            if len(data) < 3:
                raise _Err("zstd: truncated literals header")
            rs, hdr = (b0 >> 4) | (data[1] << 4) | (data[2] << 12), 3
        if lb_type == 0:
            if hdr + rs > len(data):
                raise _Err("zstd: truncated raw literals")
            return bytearray(data[hdr : hdr + rs]), hdr + rs
        if hdr + 1 > len(data):
            raise _Err("zstd: truncated RLE literals")
        return bytearray(data[hdr : hdr + 1] * rs), hdr + 1
    # Compressed (2) / Treeless (3)
    if size_format == 0:
        streams, sbits, hdr = 1, 10, 3
    elif size_format == 1:
        streams, sbits, hdr = 4, 10, 3
    elif size_format == 2:
        streams, sbits, hdr = 4, 14, 4
    else:
        streams, sbits, hdr = 4, 18, 5
    if len(data) < hdr:
        raise _Err("zstd: truncated literals header")
    v = int.from_bytes(data[:hdr], "little") >> 4
    rs = v & ((1 << sbits) - 1)
    cs = (v >> sbits) & ((1 << sbits) - 1)
    if hdr + cs > len(data):
        raise _Err("zstd: truncated compressed literals")
    payload = data[hdr : hdr + cs]
    if lb_type == 2:
        table, max_bits, used = _huffman_table(payload)
        ctx.huffman = (table, max_bits)
        payload = payload[used:]
    else:
        if ctx.huffman is None:
            raise _Err("zstd: treeless literals with no previous table")
        table, max_bits = ctx.huffman
    if rs > _BLOCK_MAX:
        raise _Err("zstd: literals exceed block maximum")
    if streams == 1:
        return _huffman_decode_stream(payload, table, max_bits, rs), hdr + cs
    if len(payload) < 6:
        raise _Err("zstd: truncated 4-stream jump table")
    s1, s2, s3 = struct.unpack_from("<HHH", payload, 0)
    body = payload[6:]
    if s1 + s2 + s3 > len(body):
        raise _Err("zstd: 4-stream sizes exceed payload")
    per = (rs + 3) // 4
    sizes = [per, per, per, rs - 3 * per]
    if sizes[3] < 0:
        raise _Err("zstd: negative fourth-stream size")
    chunks = [
        body[:s1],
        body[s1 : s1 + s2],
        body[s1 + s2 : s1 + s2 + s3],
        body[s1 + s2 + s3 :],
    ]
    out = bytearray()
    for chunk, n in zip(chunks, sizes):
        out += _huffman_decode_stream(chunk, table, max_bits, n)
    return out, hdr + cs


def _decode_block(
    data: bytes, ctx: _FrameCtx, out: bytearray, cap: int, frame_start: int
) -> None:
    literals, used = _decode_literals(data, ctx)
    data = data[used:]
    if not data:
        raise _Err("zstd: missing sequences section")
    b0 = data[0]
    if b0 < 128:
        nseq, hdr = b0, 1
    elif b0 < 255:
        if len(data) < 2:
            raise _Err("zstd: truncated sequence count")
        nseq, hdr = ((b0 - 128) << 8) + data[1], 2
    else:
        if len(data) < 3:
            raise _Err("zstd: truncated sequence count")
        nseq, hdr = data[1] + (data[2] << 8) + 0x7F00, 3
    data = data[hdr:]
    if nseq == 0:
        if len(out) + len(literals) > cap:
            raise _Err("zstd: output exceeds cap")
        out += literals
        return
    if not data:
        raise _Err("zstd: missing symbol compression modes")
    modes = data[0]
    if modes & 3:
        raise _Err("zstd: reserved sequence mode bits set")
    data = data[1:]
    consumed: List[int] = []
    ll = _sequence_decoder("ll", (modes >> 6) & 3, data, ctx.fse["ll"], consumed)
    data = data[consumed[-1] :]
    of = _sequence_decoder("of", (modes >> 4) & 3, data, ctx.fse["of"], consumed)
    data = data[consumed[-1] :]
    ml = _sequence_decoder("ml", (modes >> 2) & 3, data, ctx.fse["ml"], consumed)
    data = data[consumed[-1] :]
    ctx.fse.update(ll=ll, of=of, ml=ml)

    br = _BackBits(data)
    ll.init_state(br)
    of.init_state(br)
    ml.init_state(br)
    lit_pos = 0
    rep = ctx.rep
    for i in range(nseq):
        of_code = of.symbol()
        if of_code > 31:
            raise _Err("zstd: offset code out of range")
        of_value = (1 << of_code) + br.read(of_code)
        ml_base, ml_bits = _ML_BASE[ml.symbol()]
        match_len = ml_base + br.read(ml_bits)
        ll_base, ll_bits = _LL_BASE[ll.symbol()]
        lit_len = ll_base + br.read(ll_bits)
        if i + 1 < nseq:
            ll.update(br)
            ml.update(br)
            of.update(br)
        # Repeat-offset resolution (RFC 8878 §3.1.1.5).
        if of_value > 3:
            offset = of_value - 3
            rep[2] = rep[1]
            rep[1] = rep[0]
            rep[0] = offset
        else:
            idx = of_value - 1 + (1 if lit_len == 0 else 0)
            if idx == 0:
                offset = rep[0]
            elif idx == 1:
                offset = rep[1]
                rep[1] = rep[0]
                rep[0] = offset
            elif idx == 2:
                offset = rep[2]
                rep[2] = rep[1]
                rep[1] = rep[0]
                rep[0] = offset
            else:
                offset = rep[0] - 1
                if offset == 0:
                    raise _Err("zstd: zero repeat offset")
                rep[2] = rep[1]
                rep[1] = rep[0]
                rep[0] = offset
        if lit_pos + lit_len > len(literals):
            raise _Err("zstd: sequence literals overrun")
        if len(out) + lit_len + match_len > cap:
            raise _Err("zstd: output exceeds cap")
        out += literals[lit_pos : lit_pos + lit_len]
        lit_pos += lit_len
        if offset > len(out) - frame_start:
            # Frames are independent: a match may not reach into output
            # produced by a previous frame (libzstd rejects this too).
            raise _Err("zstd: match offset beyond frame start")
        if offset >= match_len:  # non-overlapping fast path
            start = len(out) - offset
            out += out[start : start + match_len]
        else:
            for _ in range(match_len):
                out.append(out[-offset])
    if br.pos < -8:
        raise _Err("zstd: sequence bitstream overrun")
    if len(out) + len(literals) - lit_pos > cap:
        raise _Err("zstd: output exceeds cap")
    out += literals[lit_pos:]


def decompress(data: bytes, cap: int) -> bytes:
    """Decode a (possibly multi-frame) zstd stream, bounding output at
    `cap` bytes.  Raises ValueError on any malformed input."""
    out = bytearray()
    pos = 0
    n = len(data)
    if n < 4:
        raise _Err("zstd: input shorter than a frame header")
    while pos < n:
        if pos + 4 > n:
            raise _Err("zstd: trailing garbage after frame")
        (magic,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if SKIPPABLE_MAGIC_MIN <= magic <= SKIPPABLE_MAGIC_MAX:
            if pos + 4 > n:
                raise _Err("zstd: truncated skippable frame")
            (size,) = struct.unpack_from("<I", data, pos)
            pos += 4 + size
            if pos > n:
                raise _Err("zstd: truncated skippable frame")
            continue
        if magic != ZSTD_MAGIC:
            raise _Err(f"zstd: bad magic 0x{magic:08x}")
        if pos >= n:
            raise _Err("zstd: missing frame header descriptor")
        fhd = data[pos]
        pos += 1
        fcs_flag = fhd >> 6
        single_segment = (fhd >> 5) & 1
        has_checksum = (fhd >> 2) & 1
        dict_flag = fhd & 3
        if fhd & 0x08:
            raise _Err("zstd: reserved frame header bit set")
        if not single_segment:
            if pos >= n:
                raise _Err("zstd: missing window descriptor")
            pos += 1  # window size only bounds the cap, enforced directly
        if dict_flag:
            did_len = (0, 1, 2, 4)[dict_flag]
            did = int.from_bytes(data[pos : pos + did_len], "little")
            pos += did_len
            if did:
                raise _Err("zstd: dictionaries are not supported")
        fcs_len = (1 if single_segment else 0, 2, 4, 8)[fcs_flag]
        if pos + fcs_len > n:
            raise _Err("zstd: truncated frame content size")
        fcs = None
        if fcs_len:
            fcs = int.from_bytes(data[pos : pos + fcs_len], "little")
            if fcs_len == 2:
                fcs += 256
            pos += fcs_len
        if fcs is not None and len(out) + fcs > cap:
            raise _Err("zstd: declared content size exceeds cap")
        ctx = _FrameCtx()
        frame_start = len(out)
        while True:
            if pos + 3 > n:
                raise _Err("zstd: truncated block header")
            h = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16)
            pos += 3
            last = h & 1
            btype = (h >> 1) & 3
            bsize = h >> 3
            if btype == 0:  # raw
                if pos + bsize > n:
                    raise _Err("zstd: truncated raw block")
                if len(out) + bsize > cap:
                    raise _Err("zstd: output exceeds cap")
                out += data[pos : pos + bsize]
                pos += bsize
            elif btype == 1:  # RLE
                if pos >= n:
                    raise _Err("zstd: truncated RLE block")
                if bsize > _BLOCK_MAX or len(out) + bsize > cap:
                    raise _Err("zstd: output exceeds cap")
                out += data[pos : pos + 1] * bsize
                pos += 1
            elif btype == 2:
                if pos + bsize > n:
                    raise _Err("zstd: truncated compressed block")
                before = len(out)
                _decode_block(data[pos : pos + bsize], ctx, out, cap, frame_start)
                if len(out) - before > _BLOCK_MAX:
                    raise _Err("zstd: block exceeds 128 KiB maximum")
                pos += bsize
            else:
                raise _Err("zstd: reserved block type")
            if last:
                break
        if fcs is not None and len(out) - frame_start != fcs:
            raise _Err(
                f"zstd: frame declared {fcs} bytes, produced "
                f"{len(out) - frame_start}"
            )
        if has_checksum:
            if pos + 4 > n:
                raise _Err("zstd: truncated content checksum")
            pos += 4  # xxh64 low 32 bits — parsed, not verified
    return bytes(out)
