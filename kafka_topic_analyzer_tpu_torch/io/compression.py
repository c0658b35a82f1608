"""Record-batch decompression: gzip (stdlib), snappy and LZ4 (native shim
with pure-Python fallback), zstd (ctypes on system libzstd with a
pure-Python RFC 8878 fallback, io/zstd_py.py).  Port of the reference's
``io/compression.py``; snappy and LZ4 reach the port's own shim.

Kafka's snappy payloads use the xerial chunked framing; LZ4 uses the LZ4
frame format.  Python's stdlib has neither, so the fast path is the C++
shim (native/ingest.cpp); the pure-Python decoders keep the wire client
correct when the shim can't be built.

The literal-only *encoders* here exist for tests and the in-process fake
broker: a snappy/LZ4 stream consisting solely of literal runs is valid, so
round-trips exercise real framing without a compressor dependency.
"""

from __future__ import annotations

import struct
import zlib

XERIAL_MAGIC = b"\x82SNAPPY\x00"
LZ4_FRAME_MAGIC = 0x184D2204

#: Safety cap for decompressed record sets (a batch can't meaningfully
#: exceed this: brokers bound message sizes far below it).
MAX_DECOMPRESSED = 1 << 30


class UnsupportedCodecError(RuntimeError):
    pass


class CorruptPayloadError(ValueError):
    """A compressed codec stream that does not decode (truncated, bad
    framing, length mismatch, over-cap).  Subclasses ValueError so callers
    written against the decoders' historical "raise ValueError on garbage"
    contract keep working; the codec layer (io/kafka_codec.py) re-wraps it
    into the `BadCompressionError` corruption classification."""


# ---------------------------------------------------------------------------
# pure-Python decoders (fallback path)


def _total(fn):
    """Truncated streams index past the end in several places; map every
    IndexError to the same ValueError a caller can handle (fuzzed by
    tests/test_properties.py: decoders must be total over garbage)."""
    import functools

    @functools.wraps(fn)
    def wrapper(*a, **k):
        try:
            return fn(*a, **k)
        except IndexError as e:
            raise CorruptPayloadError("truncated compressed payload") from e

    return wrapper


def _snappy_raw_py(data: bytes) -> bytes:
    ip = 0
    ulen = 0
    shift = 0
    while ip < len(data):
        b = data[ip]
        ip += 1
        ulen |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    n = len(data)
    while ip < n:
        tag = data[ip]
        ip += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                length = int.from_bytes(data[ip : ip + extra], "little") + 1
                ip += extra
            if ip + length > n:
                raise CorruptPayloadError("truncated snappy literal run")
            out += data[ip : ip + length]
            ip += length
        else:
            if kind == 1:
                length = ((tag >> 2) & 7) + 4
                offset = ((tag >> 5) << 8) | data[ip]
                ip += 1
            elif kind == 2:
                length = (tag >> 2) + 1
                offset = int.from_bytes(data[ip : ip + 2], "little")
                ip += 2
            else:
                length = (tag >> 2) + 1
                offset = int.from_bytes(data[ip : ip + 4], "little")
                ip += 4
            if offset <= 0 or offset > len(out):
                raise CorruptPayloadError("bad snappy copy offset")
            for _ in range(length):  # may overlap (RLE)
                out.append(out[-offset])
    if len(out) != ulen:
        raise CorruptPayloadError(f"snappy length mismatch: {len(out)} != {ulen}")
    return bytes(out)


@_total
def snappy_decompress_py(data: bytes) -> bytes:
    if data.startswith(XERIAL_MAGIC):
        ip = 16  # magic + version + compat
        out = bytearray()
        while ip + 4 <= len(data):
            (blen,) = struct.unpack(">i", data[ip : ip + 4])
            ip += 4
            # A negative/overlong block length must fail, not loop forever
            # (this decoder's totality cannot depend on callers validating
            # first).
            if blen < 0 or ip + blen > len(data):
                raise CorruptPayloadError("bad xerial block length")
            out += _snappy_raw_py(data[ip : ip + blen])
            ip += blen
        return bytes(out)
    return _snappy_raw_py(data)


def _lz4_block_py(data: bytes, out: bytearray) -> None:
    ip = 0
    n = len(data)
    while ip < n:
        token = data[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise CorruptPayloadError("truncated lz4 length extension")
                b = data[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        if ip + lit > n:
            raise CorruptPayloadError("truncated lz4 literal run")
        out += data[ip : ip + lit]
        ip += lit
        if ip >= n:
            break
        offset = int.from_bytes(data[ip : ip + 2], "little")
        ip += 2
        if offset == 0 or offset > len(out):
            raise CorruptPayloadError("bad lz4 match offset")
        mlen = token & 0x0F
        if mlen == 15:
            while True:
                if ip >= n:
                    raise CorruptPayloadError("truncated lz4 length extension")
                b = data[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        if len(out) + mlen > MAX_DECOMPRESSED:
            raise CorruptPayloadError("lz4 output exceeds 1 GiB cap")
        for _ in range(mlen):
            out.append(out[-offset])


@_total
def lz4_decompress_py(data: bytes) -> bytes:
    if len(data) >= 7 and struct.unpack("<I", data[:4])[0] == LZ4_FRAME_MAGIC:
        ip = 4
        flg = data[ip]
        ip += 2  # FLG + BD
        if flg & 0x01:
            raise CorruptPayloadError("lz4 dictionaries unsupported")
        if flg & 0x08:  # content size present
            ip += 8
        ip += 1  # header checksum
        out = bytearray()
        while ip + 4 <= len(data):
            (bsize,) = struct.unpack("<I", data[ip : ip + 4])
            ip += 4
            if bsize == 0:  # EndMark
                return bytes(out)
            blen = bsize & 0x7FFFFFFF
            block = data[ip : ip + blen]
            ip += blen
            if bsize & 0x80000000:
                out += block
            else:
                _lz4_block_py(block, out)
            if len(out) > MAX_DECOMPRESSED:
                raise CorruptPayloadError("lz4 output exceeds 1 GiB cap")
            if flg & 0x10:  # block checksum
                ip += 4
        raise CorruptPayloadError("lz4 frame missing EndMark")
    out = bytearray()
    _lz4_block_py(data, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# native dispatch


def _read_uvarint(data: bytes, pos: int) -> "tuple[int, int]":
    val = 0
    shift = 0
    while pos < len(data):
        b = data[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7
        if shift > 35:
            break
    raise CorruptPayloadError("bad varint in compressed payload")


def _snappy_output_size(data: bytes) -> int:
    """Exact decompressed size from the stream's own length preambles."""
    if data.startswith(XERIAL_MAGIC):
        total = 0
        ip = 16
        while ip + 4 <= len(data):
            (blen,) = struct.unpack(">i", data[ip : ip + 4])
            ip += 4
            if blen < 0 or ip + blen > len(data):
                raise CorruptPayloadError("bad xerial block length")
            size, _ = _read_uvarint(data, ip)
            total += size
            ip += blen
        return total
    size, _ = _read_uvarint(data, 0)
    return size


def _lz4_output_bound(data: bytes) -> int:
    """Content size when the frame declares it, else the format's worst-case
    expansion bound (a match emits at most 255x its encoding)."""
    if len(data) >= 7 and struct.unpack("<I", data[:4])[0] == LZ4_FRAME_MAGIC:
        flg = data[4]
        if flg & 0x08:
            if len(data) < 14:
                raise CorruptPayloadError("truncated lz4 frame header")
            return struct.unpack("<Q", data[6:14])[0]
    return len(data) * 255 + 64


def _native_decompress(fn_name: str, data: bytes, cap: int) -> "bytes | None":
    """One-shot native call with an exact/bounded output size — malformed
    input (or no shim) returns None and the Python path raises a clear
    error."""
    from kafka_topic_analyzer_tpu_torch.io import native

    if not native.native_available():
        return None
    return native.decompress_native(fn_name, data, cap)


def snappy_decompress(data: bytes) -> bytes:
    size = _snappy_output_size(data)  # raises on malformed preambles
    if size > MAX_DECOMPRESSED:
        raise CorruptPayloadError(f"snappy payload declares {size} bytes (> 1 GiB cap)")
    out = _native_decompress("kta_snappy_decompress", data, size)
    return out if out is not None else snappy_decompress_py(data)


def lz4_decompress(data: bytes) -> bytes:
    # Kafka's Java client omits the frame content size, so the only a-priori
    # bound is the 255x worst case — far too big to allocate per batch.
    # Grow on demand instead: -1 from the native decoder means either a
    # short buffer or malformed input, so after reaching the bound the
    # strict Python decoder delivers the verdict (raises on malformed).
    bound = min(_lz4_output_bound(data), MAX_DECOMPRESSED)
    cap = min(max(len(data) * 8, 1 << 20), bound)
    while True:
        out = _native_decompress("kta_lz4_decompress", data, cap)
        if out is not None:
            return out
        if cap >= bound:
            return lz4_decompress_py(data)
        cap = min(cap * 16, bound)


def gzip_decompress(payload: bytes) -> bytes:
    """Bounded gzip/zlib inflate — same MAX_DECOMPRESSED cap the snappy and
    LZ4 paths enforce, so a corrupt or hostile batch can't balloon ~1000x
    into memory unchecked."""
    d = zlib.decompressobj(wbits=47)
    try:
        out = d.decompress(payload, MAX_DECOMPRESSED)
    except zlib.error as e:
        raise CorruptPayloadError(f"corrupt gzip stream: {e}") from e
    if d.unconsumed_tail:
        raise CorruptPayloadError(
            f"gzip batch exceeds decompressed size cap ({MAX_DECOMPRESSED} B)"
        )
    out += d.flush()
    if len(out) > MAX_DECOMPRESSED:
        raise CorruptPayloadError(
            f"gzip batch exceeds decompressed size cap ({MAX_DECOMPRESSED} B)"
        )
    # zlib.decompress raised on truncated streams; a decompressobj only
    # signals it via eof.  Trailing bytes after a complete stream stay
    # ignored (old zlib.decompress(wbits=47) behavior).
    if not d.eof:
        raise CorruptPayloadError("truncated gzip stream")
    return out


_ZSTD_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_ZSTD_CONTENTSIZE_ERROR = (1 << 64) - 2
_libzstd = "unresolved"  # tri-state: unresolved / CDLL / None


def _load_libzstd():
    """System libzstd via ctypes (the fast path; the reference gets zstd
    from librdkafka's statically-linked libzstd, Cargo.toml:19).  Returns
    None when the shared library isn't loadable — the pure-Python RFC 8878
    decoder (zstd_py.py) then carries correctness."""
    global _libzstd
    if _libzstd == "unresolved":
        try:
            import ctypes

            lib = ctypes.CDLL("libzstd.so.1")
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_getFrameContentSize.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.ZSTD_compressBound.restype = ctypes.c_size_t
            lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
            lib.ZSTD_compress.restype = ctypes.c_size_t
            lib.ZSTD_compress.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ]
            lib.ZSTD_createDCtx.restype = ctypes.c_void_p
            lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
            lib.ZSTD_DCtx_reset.restype = ctypes.c_size_t
            lib.ZSTD_DCtx_reset.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.ZSTD_decompressStream.restype = ctypes.c_size_t
            lib.ZSTD_decompressStream.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            _libzstd = lib
        except Exception:
            _libzstd = None
    return _libzstd


def _zstd_stream_decompress(lib, data: bytes) -> "bytes | None":
    """ZSTD_decompressStream loop for frames without a declared content
    size (the shape stream-compressing producers emit).  Returns None on
    any libzstd error — the pure-Python decoder then delivers the verdict."""
    import ctypes

    class Buf(ctypes.Structure):
        _fields_ = [
            ("ptr", ctypes.c_void_p),
            ("size", ctypes.c_size_t),
            ("pos", ctypes.c_size_t),
        ]

    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        return None
    try:
        src = ctypes.create_string_buffer(data, len(data))
        inbuf = Buf(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        chunk_size = min(max(len(data) * 4, 1 << 18), MAX_DECOMPRESSED)
        chunk = ctypes.create_string_buffer(chunk_size)
        out = bytearray()
        ret = 0
        while True:
            in_before = inbuf.pos
            outbuf = Buf(ctypes.cast(chunk, ctypes.c_void_p), chunk_size, 0)
            ret = int(lib.ZSTD_decompressStream(
                dctx, ctypes.byref(outbuf), ctypes.byref(inbuf)
            ))
            if lib.ZSTD_isError(ret):
                return None
            if inbuf.pos == in_before and outbuf.pos == 0:
                return None  # no progress: treat as corrupt
            out += ctypes.string_at(chunk, outbuf.pos)
            if len(out) > MAX_DECOMPRESSED:
                raise CorruptPayloadError(
                    f"zstd batch exceeds decompressed size cap "
                    f"({MAX_DECOMPRESSED} B)"
                )
            if inbuf.pos >= inbuf.size and (
                ret == 0 or outbuf.pos < outbuf.size
            ):
                # Input drained and either the frame completed (ret == 0 —
                # even when the output chunk filled exactly) or the decoder
                # flushed everything it could (not full ⇒ it wants more
                # input: truncated, handled below).
                break
        if ret != 0:
            return None  # truncated final frame
        return bytes(out)
    finally:
        lib.ZSTD_freeDCtx(dctx)


def zstd_decompress(data: bytes) -> bytes:
    """Bounded zstd decode: libzstd one-shot when the frame declares its
    content size, growing-cap retries when it doesn't; the pure-Python
    decoder is the fallback and the verdict on malformed input."""
    import ctypes

    lib = _load_libzstd()
    if lib is not None and len(data) >= 4:
        csize = int(lib.ZSTD_getFrameContentSize(data, len(data)))
        if csize not in (_ZSTD_CONTENTSIZE_UNKNOWN, _ZSTD_CONTENTSIZE_ERROR):
            if csize > MAX_DECOMPRESSED:
                raise CorruptPayloadError(
                    f"zstd batch declares {csize} bytes (> 1 GiB cap)"
                )
            buf = ctypes.create_string_buffer(max(csize, 1))
            n = int(lib.ZSTD_decompress(buf, csize, data, len(data)))
            if not lib.ZSTD_isError(n):
                return buf.raw[:n]
            # fall through: the Python decoder raises the precise error
        elif csize == _ZSTD_CONTENTSIZE_UNKNOWN:
            # Streaming producers (ZSTD_compressStream2, i.e. most real
            # Kafka clients) omit the content size: decode incrementally.
            out = _zstd_stream_decompress(lib, data)
            if out is not None:
                return out
            # corrupt input: fall through, Python delivers the verdict
    from kafka_topic_analyzer_tpu_torch.io import zstd_py

    return zstd_py.decompress(data, MAX_DECOMPRESSED)


def zstd_compress_frame(data: bytes, level: int = 3) -> bytes:
    """zstd encoder for tests and the fake broker: real libzstd when
    loadable, else a valid literal-only frame (raw blocks)."""
    import ctypes

    lib = _load_libzstd()
    if lib is not None:
        bound = int(lib.ZSTD_compressBound(len(data)))
        buf = ctypes.create_string_buffer(max(bound, 1))
        n = int(lib.ZSTD_compress(buf, bound, data, len(data), level))
        if not lib.ZSTD_isError(n):
            return buf.raw[:n]
    from kafka_topic_analyzer_tpu_torch.io.zstd_py import ZSTD_MAGIC

    # Single-segment frame, 8-byte declared content size, raw blocks.
    out = bytearray(struct.pack("<IB", ZSTD_MAGIC, 0xE0))
    out += struct.pack("<Q", len(data))
    pos = 0
    block_max = 128 * 1024
    while True:
        chunk = data[pos : pos + block_max]
        pos += len(chunk)
        last = 1 if pos >= len(data) else 0
        h = last | (len(chunk) << 3)  # type 0 = raw
        out += struct.pack("<I", h)[:3] + chunk
        if last:
            break
    return bytes(out)


def decompress(codec: int, payload: bytes) -> bytes:
    """Kafka record-batch attribute codec → decompressed payload."""
    if codec == 0:
        return payload
    if isinstance(payload, (bytearray, memoryview)):
        # The wire client hands out zero-copy bytearray slices; the ctypes
        # codec fast paths (c_char_p) need real bytes.  Compressed payloads
        # are the small side of the pipe, so this copy is cheap.
        payload = bytes(payload)
    if codec == 1:  # gzip (RFC1952; wbits=47 auto-detects zlib too)
        return gzip_decompress(payload)
    if codec == 2:
        return snappy_decompress(payload)
    if codec == 3:
        return lz4_decompress(payload)
    if codec == 4:
        return zstd_decompress(payload)
    raise UnsupportedCodecError(f"unknown compression codec {codec}")


# ---------------------------------------------------------------------------
# literal-only encoders (tests / fake broker interop)


def _snappy_literal_block(data: bytes) -> bytes:
    out = bytearray()
    # preamble: uncompressed length varint
    n = len(data)
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            break
    pos = 0
    while pos < len(data):
        chunk = data[pos : pos + 60]
        out.append((len(chunk) - 1) << 2)  # literal tag, kind 0
        out += chunk
        pos += len(chunk)
    return bytes(out)


def snappy_compress_xerial(data: bytes) -> bytes:
    """Valid xerial-framed snappy stream using literal-only encoding."""
    block = _snappy_literal_block(data)
    return (
        XERIAL_MAGIC
        + struct.pack(">ii", 1, 1)  # version, compat
        + struct.pack(">i", len(block))
        + block
    )


def lz4_compress_frame(data: bytes) -> bytes:
    """Valid LZ4 frame using one uncompressed block (flag bit set)."""
    header = struct.pack("<I", LZ4_FRAME_MAGIC) + bytes([0x60, 0x40])
    # FLG 0x60: version 01, block-independence; BD 0x40: 64KB max block.
    # header checksum byte: xxhash of descriptor — brokers don't verify in
    # our decoder; real clients do, so use the real second byte of
    # XXH32(desc) >> 8 ... we skip verification on decode, write 0.
    header += b"\x00"
    body = struct.pack("<I", 0x80000000 | len(data)) + data
    return header + body + struct.pack("<I", 0)  # EndMark
