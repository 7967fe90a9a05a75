"""Blosc chunk codec for zarrlite — reads/writes the reference wire format.

The port's copy of garmentnets_tpu/data/blosc_codec.py (numpy and the
standard library only).

The reference compresses every zarr it writes with
``Blosc(cname='zstd', clevel=6, shuffle=Blosc.BITSHUFFLE)``
(reference predict.py:75-79, eval.py:910) and the released GarmentNets
datasets are Blosc-compressed too, so ingesting/producing real artifacts
requires this codec.

Two interchangeable engines:

1. ctypes binding to the system ``libblosc.so.1`` (where installed) —
   byte-exact c-blosc, all cnames (blosclz/lz4/lz4hc/snappy/zlib/zstd).
2. A pure-Python implementation of the blosc1 chunk format (16-byte header,
   per-block streams, byte-shuffle and bit-shuffle) with zstd (via the
   ``zstandard`` package) and zlib payloads — used when the shared library
   is unavailable, and cross-validated against it in tests/test_blosc.py.

Format notes (c-blosc 1.x): header = version, versionlz, flags, typesize,
then little-endian uint32 nbytes/blocksize/cbytes. flags bit0 = byte
shuffle, bit1 = memcpyed, bit2 = bitshuffle, bit4 = block-NOT-split marker,
bits 5-7 = compressor code (0 blosclz, 1 lz4/lz4hc, 2 snappy, 3 zlib,
4 zstd). Non-memcpyed chunks carry a uint32 offset table (one absolute
offset per block); each block is a sequence of int32-length-prefixed
streams — typesize streams when split (flags bit4 clear and the block is
full-size), one otherwise; a stream whose stored length equals its
uncompressed length is raw. Shuffles are applied per block (before
splitting); bitshuffle processes the largest multiple of 8 elements and
copies the tail verbatim.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import struct
import zlib

import numpy as np

# numcodecs shuffle constants
NOSHUFFLE, SHUFFLE, BITSHUFFLE = 0, 1, 2

_CNAME_CODE = {"blosclz": 0, "lz4": 1, "lz4hc": 1, "snappy": 2,
               "zlib": 3, "zstd": 4}


# --------------------------------------------------------------------------
# engine 1: system libblosc via ctypes
# --------------------------------------------------------------------------

def _load_libblosc():
    for name in ("libblosc.so.1", "libblosc.so", "blosc"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        found = ctypes.util.find_library("blosc")
        if not found:
            return None
        lib = ctypes.CDLL(found)
    lib.blosc_compress_ctx.restype = ctypes.c_int
    lib.blosc_compress_ctx.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.c_size_t, ctypes.c_int]
    lib.blosc_decompress_ctx.restype = ctypes.c_int
    lib.blosc_decompress_ctx.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    lib.blosc_cbuffer_sizes.restype = None
    lib.blosc_cbuffer_sizes.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t)]
    return lib


_LIB = _load_libblosc()


def _lib_compress(buf: bytes, typesize: int, cname: str, clevel: int,
                  shuffle: int) -> bytes:
    dest = ctypes.create_string_buffer(len(buf) + 16)
    n = _LIB.blosc_compress_ctx(
        clevel, shuffle, max(1, typesize), len(buf), buf, dest, len(dest),
        cname.encode(), 0, 1)
    if n <= 0:
        raise RuntimeError(f"blosc_compress_ctx failed: {n}")
    return dest.raw[:n]


def _lib_decompress(buf: bytes):
    """Returns a fresh writable uint8 ndarray (not bytes): decompressing
    straight into np.empty avoids create_string_buffer's zero-fill memset
    AND the .raw bytes copy — both were measured input-pipeline overhead
    (~4 ms per 8.4 MB volume chunk on one CPU core)."""
    nbytes = ctypes.c_size_t()
    cbytes = ctypes.c_size_t()
    blocksize = ctypes.c_size_t()
    _LIB.blosc_cbuffer_sizes(buf, ctypes.byref(nbytes), ctypes.byref(cbytes),
                             ctypes.byref(blocksize))
    if nbytes.value == 0:
        return np.empty(0, np.uint8)
    out = np.empty(nbytes.value, np.uint8)
    n = _LIB.blosc_decompress_ctx(
        buf, out.ctypes.data_as(ctypes.c_void_p), nbytes.value, 1)
    if n != nbytes.value:
        raise RuntimeError(f"blosc_decompress_ctx failed: {n}")
    return out


# --------------------------------------------------------------------------
# engine 2: pure Python (zstd/zlib payloads)
# --------------------------------------------------------------------------

def _zstd():
    import zstandard
    return zstandard


def _payload_decompress(compcode: int, data: bytes, nbytes: int) -> bytes:
    if compcode == 3:
        return zlib.decompress(data)
    if compcode == 4:
        return _zstd().ZstdDecompressor().decompress(
            data, max_output_size=nbytes)
    raise ValueError(
        f"pure-Python blosc supports zlib/zstd payloads only, got "
        f"compressor code {compcode} (install/load libblosc for the rest)")


def _payload_compress(compcode: int, data: bytes, clevel: int) -> bytes:
    if compcode == 3:
        return zlib.compress(data, min(clevel, 9))
    if compcode == 4:
        return _zstd().ZstdCompressor(level=clevel).compress(data)
    raise ValueError(f"unsupported compressor code {compcode}")


def _byte_shuffle(block: bytes, typesize: int, reverse: bool) -> bytes:
    if typesize <= 1:
        return block
    whole = len(block) - len(block) % typesize
    arr = np.frombuffer(block[:whole], np.uint8)
    n = whole // typesize
    if reverse:
        body = arr.reshape(typesize, n).T
    else:
        body = arr.reshape(n, typesize).T
    return np.ascontiguousarray(body).tobytes() + block[whole:]


def _bit_shuffle(block: bytes, typesize: int) -> bytes:
    # c-blosc ≥1.18 semantics: if the element count is not a multiple of 8
    # the whole block is left unshuffled; otherwise all elements are
    # shuffled and only the sub-typesize tail is copied verbatim.
    n = len(block) // typesize
    if n == 0 or n % 8 != 0:
        return block
    whole = n * typesize
    arr = np.frombuffer(block[:whole], np.uint8).reshape(n, typesize, 1)
    bits = np.unpackbits(arr, axis=2, bitorder="little")    # [n, T, 8]
    planes = bits.transpose(1, 2, 0)                        # [T, 8, n]
    packed = np.packbits(
        planes.reshape(typesize, 8, n // 8, 8), axis=-1, bitorder="little")
    return packed.tobytes() + block[whole:]


def _bit_unshuffle(block: bytes, typesize: int) -> bytes:
    n = len(block) // typesize
    if n == 0 or n % 8 != 0:
        return block
    whole = n * typesize
    arr = np.frombuffer(block[:whole], np.uint8).reshape(
        typesize, 8, n // 8, 1)
    bits = np.unpackbits(arr, axis=3, bitorder="little")    # [T, 8, n/8, 8]
    elems = bits.reshape(typesize, 8, n).transpose(2, 0, 1)  # [n, T, 8]
    packed = np.packbits(elems, axis=-1, bitorder="little")
    return packed.tobytes() + block[whole:]


def _py_decompress(buf: bytes) -> bytes:
    if len(buf) < 16:
        raise ValueError("truncated blosc chunk")
    flags, typesize = buf[2], max(1, buf[3])
    nbytes, blocksize, cbytes = struct.unpack_from("<III", buf, 4)
    if nbytes == 0:
        return b""
    if flags & 0x2:                                          # memcpyed
        return bytes(buf[16:16 + nbytes])
    compcode = flags >> 5
    dont_split = bool(flags & 0x10)
    nblocks = -(-nbytes // blocksize)
    starts = struct.unpack_from(f"<{nblocks}I", buf, 16)
    out = bytearray(nbytes)
    for i, off in enumerate(starts):
        bsize = min(blocksize, nbytes - i * blocksize)
        nsplits = (typesize if not dont_split and bsize == blocksize
                   and typesize > 1 and bsize % typesize == 0 else 1)
        neblock = bsize // nsplits
        parts = []
        for _ in range(nsplits):
            (csize,) = struct.unpack_from("<i", buf, off)
            payload = buf[off + 4: off + 4 + csize]
            off += 4 + csize
            if csize == neblock:                             # stored raw
                parts.append(bytes(payload))
            else:
                parts.append(
                    _payload_decompress(compcode, payload, neblock))
        block = b"".join(parts)
        if len(block) != bsize:
            raise ValueError(
                f"blosc block {i}: got {len(block)} bytes, want {bsize}")
        if flags & 0x1:
            block = _byte_shuffle(block, typesize, reverse=True)
        elif flags & 0x4:
            block = _bit_unshuffle(block, typesize)
        out[i * blocksize: i * blocksize + bsize] = block
    return bytes(out)


def _py_compress(buf: bytes, typesize: int, cname: str, clevel: int,
                 shuffle: int) -> bytes:
    typesize = max(1, typesize)
    compcode = _CNAME_CODE[cname]
    if compcode not in (3, 4):
        raise ValueError(f"pure-Python blosc cannot encode cname {cname!r}")
    nbytes = len(buf)
    if nbytes == 0:
        return struct.pack("<BBBBIII", 2, 1, compcode << 5, typesize,
                           0, 0, 16)
    unit = typesize * 8
    blocksize = min(nbytes, max(unit, (1 << 18) // unit * unit))
    nblocks = -(-nbytes // blocksize)
    flags = (compcode << 5) | 0x10                           # never split
    if shuffle == SHUFFLE and typesize > 1:
        flags |= 0x1
    elif shuffle == BITSHUFFLE:
        flags |= 0x4
    streams = []
    for i in range(nblocks):
        block = buf[i * blocksize: i * blocksize + blocksize]
        if flags & 0x1:
            block = _byte_shuffle(block, typesize, reverse=False)
        elif flags & 0x4:
            block = _bit_shuffle(block, typesize)
        comp = _payload_compress(compcode, block, clevel)
        if len(comp) >= len(block):
            comp = block                                     # store raw
        streams.append(struct.pack("<i", len(comp)) + comp)
    header_len = 16 + 4 * nblocks
    total = header_len + sum(len(s) for s in streams)
    if total >= nbytes + 16:                                 # incompressible
        header = struct.pack("<BBBBIII", 2, 1, (compcode << 5) | 0x2,
                             typesize, nbytes, blocksize, nbytes + 16)
        return header + buf
    header = struct.pack("<BBBBIII", 2, 1, flags, typesize,
                         nbytes, blocksize, total)
    offsets, pos = [], header_len
    for s in streams:
        offsets.append(pos)
        pos += len(s)
    return header + struct.pack(f"<{nblocks}I", *offsets) + b"".join(streams)


# --------------------------------------------------------------------------
# public API + zarrlite codec hooks
# --------------------------------------------------------------------------

def compress(buf: bytes, typesize: int, cname: str = "zstd", clevel: int = 6,
             shuffle: int = BITSHUFFLE, force_python: bool = False) -> bytes:
    if not 1 <= typesize <= 255:
        typesize = 1   # c-blosc convention: out-of-range typesize -> 1
    if _LIB is not None and not force_python:
        return _lib_compress(buf, typesize, cname, clevel, shuffle)
    return _py_compress(buf, typesize, cname, clevel, shuffle)


def decompress(buf: bytes, force_python: bool = False):
    """Returns the decompressed payload as a bytes-like object: a writable
    memoryview on the c-blosc path (zero-copy — compares equal to bytes and
    feeds np.frombuffer as a writable buffer), plain bytes on the
    pure-Python path."""
    if _LIB is not None and not force_python:
        return memoryview(_lib_decompress(buf))
    return _py_decompress(buf)


def available() -> bool:
    """True if blosc-zstd chunks can be encoded+decoded in this process."""
    if _LIB is not None:
        return True
    try:
        _zstd()
        return True
    except ImportError:
        return False


def zarr_encode(buf: bytes, cfg: dict) -> bytes:
    """zarrlite codec hook. cfg is the .zarray compressor metadata plus a
    transient '_typesize' the writer injects (numcodecs infers typesize from
    the buffer dtype; it is not part of the on-disk config)."""
    return compress(buf,
                    typesize=int(cfg.get("_typesize", 1)),
                    cname=cfg.get("cname", "zstd"),
                    clevel=int(cfg.get("clevel", 6)),
                    shuffle=int(cfg.get("shuffle", BITSHUFFLE)))


def zarr_decode(buf: bytes, cfg: dict) -> bytes:
    return decompress(buf)
