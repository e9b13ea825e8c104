"""CRAM 3.0 reader (+ writer subset for tests).

The reference pipeline's canonical input is a CRAM (HLA-LA.pl:221-229 accepts
BAM or CRAM; the NA12878 golden input is a 316MB CRAM).  This module decodes
CRAM 3.0 natively — containers, slices, block codecs (raw/gzip/bzip2/lzma/
rANS4x8), the data-series encodings (EXTERNAL, HUFFMAN, BETA, GAMMA, SUBEXP,
BYTE_ARRAY_LEN, BYTE_ARRAY_STOP), reference-based sequence reconstruction,
and mate attachment — yielding the same `BamRecord`s the BAM codec yields.

Layout per the CRAM 3.0 specification (samtools/hts-specs CRAMv3.pdf):
file definition, containers (header + blocks), compression header
(preservation map / data-series encodings / tag dictionary), slices
(header block, core bitstream block, external blocks).
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from . import rans
from .bam import BamRecord

CRAM_MAGIC = b"CRAM"

# block compression methods
M_RAW, M_GZIP, M_BZIP2, M_LZMA, M_RANS4x8, M_RANSNx16, M_ARITH, M_FQZ, \
    M_TOK3 = range(9)
# block content types
CT_FILE_HEADER, CT_COMPRESSION_HEADER, CT_SLICE_HEADER, CT_RESERVED, \
    CT_EXTERNAL, CT_CORE = range(6)

# CF (CRAM record flag) bits
CF_QUAL_STORED = 0x1
CF_DETACHED = 0x2
CF_HAS_MATE_DOWNSTREAM = 0x4
CF_NO_SEQ = 0x8

# MF (CRAM mate flag) bits
MF_MATE_REVERSE = 0x1
MF_MATE_UNMAPPED = 0x2

# BAM flag bits we patch for attached mates
BAM_FPAIRED = 0x1
BAM_FPROPER = 0x2
BAM_FUNMAP = 0x4
BAM_FMUNMAP = 0x8
BAM_FREVERSE = 0x10
BAM_FMREVERSE = 0x20


# ------------------------------------------------------------------ itf8
def read_itf8(buf: bytes, pos: int) -> tuple[int, int]:
    b0 = buf[pos]
    if b0 < 0x80:
        return b0, pos + 1
    if b0 < 0xC0:
        return ((b0 & 0x3F) << 8) | buf[pos + 1], pos + 2
    if b0 < 0xE0:
        return (((b0 & 0x1F) << 16) | (buf[pos + 1] << 8)
                | buf[pos + 2]), pos + 3
    if b0 < 0xF0:
        return (((b0 & 0x0F) << 24) | (buf[pos + 1] << 16)
                | (buf[pos + 2] << 8) | buf[pos + 3]), pos + 4
    v = (((b0 & 0x0F) << 28) | (buf[pos + 1] << 20) | (buf[pos + 2] << 12)
         | (buf[pos + 3] << 4) | (buf[pos + 4] & 0x0F))
    if v >= (1 << 31):
        v -= 1 << 32
    return v, pos + 5


def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < (1 << 7):
        return bytes([v])
    if v < (1 << 14):
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < (1 << 21):
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < (1 << 28):
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def read_ltf8(buf: bytes, pos: int) -> tuple[int, int]:
    b0 = buf[pos]
    n_extra = 0
    for bit in range(8):
        if b0 & (0x80 >> bit):
            n_extra += 1
        else:
            break
    if n_extra == 0:
        return b0, pos + 1
    if n_extra == 8:
        v = int.from_bytes(buf[pos + 1:pos + 9], "big")
        if v >= (1 << 63):
            v -= 1 << 64
        return v, pos + 9
    mask = (1 << (7 - n_extra)) - 1
    v = b0 & mask
    for i in range(n_extra):
        v = (v << 8) | buf[pos + 1 + i]
    return v, pos + 1 + n_extra


def write_ltf8(v: int) -> bytes:
    v &= (1 << 64) - 1
    if v < (1 << 7):
        return bytes([v])
    for n_extra in range(1, 8):
        if v < (1 << (7 * (n_extra + 1))):
            prefix = (0xFF << (8 - n_extra)) & 0xFF
            top_bits = 7 - n_extra
            out = [prefix | (v >> (8 * n_extra))]
            for i in range(n_extra - 1, -1, -1):
                out.append((v >> (8 * i)) & 0xFF)
            return bytes(out)
    return bytes([0xFF]) + v.to_bytes(8, "big")


# ------------------------------------------------------------------ blocks
def _decompress(method: int, data: bytes, raw_size: int) -> bytes:
    try:
        if method == M_RAW:
            return data
        if method == M_GZIP:
            return gzip.decompress(data)
        if method == M_BZIP2:
            return bz2.decompress(data)
        if method == M_LZMA:
            return lzma.decompress(data)
        if method == M_RANS4x8:
            return rans.uncompress(data)
        if method == M_RANSNx16:
            from . import rans_nx16
            return rans_nx16.uncompress(data, raw_size)
        if method == M_ARITH:
            from . import arith
            return arith.uncompress(data, raw_size)
        if method == M_FQZ:
            from . import fqzcomp
            return fqzcomp.uncompress(data, raw_size)
        if method == M_TOK3:
            from . import tok3
            return tok3.uncompress(data, raw_size)
    except NotImplementedError:
        raise
    except Exception as e:  # noqa: BLE001 — corrupt payloads raise cleanly
        raise ValueError(f"corrupt CRAM block (method {method}: {e})") from e
    raise NotImplementedError(
        f"CRAM block compression method {method} not supported")


@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes            # uncompressed


def read_block(buf: bytes, pos: int) -> tuple[Block, int]:
    start = pos
    method = buf[pos]
    ctype = buf[pos + 1]
    pos += 2
    content_id, pos = read_itf8(buf, pos)
    comp_size, pos = read_itf8(buf, pos)
    raw_size, pos = read_itf8(buf, pos)
    if comp_size < 0 or raw_size < 0 or raw_size > (1 << 31):
        raise ValueError(f"CRAM block: implausible sizes "
                         f"(comp {comp_size}, raw {raw_size})")
    data = buf[pos:pos + comp_size]
    pos += comp_size
    if pos + 4 > len(buf):
        raise ValueError("CRAM block: truncated (missing CRC32)")
    # CRAM 3.x: CRC32 of all preceding block bytes — verify so a corrupt
    # block fails loudly instead of decoding to wrong data
    stored = struct.unpack_from("<I", buf, pos)[0]
    pos += 4
    if (zlib.crc32(buf[start:pos - 4]) & 0xFFFFFFFF) != stored:
        raise ValueError("CRAM block: CRC32 mismatch (corrupt data)")
    out = _decompress(method, data, raw_size)
    if len(out) != raw_size:
        raise ValueError(f"CRAM block: raw size mismatch "
                         f"({len(out)} != {raw_size})")
    return Block(method, ctype, content_id, out), pos


def write_block(method: int, ctype: int, content_id: int,
                raw: bytes) -> bytes:
    if method == M_GZIP:
        data = gzip.compress(raw)
    elif method == M_RANS4x8:
        data = rans.compress(raw, order=0)
    elif method == M_RANSNx16:
        from . import rans_nx16
        data = rans_nx16.compress(raw, order=0)
    elif method == M_ARITH:
        from . import arith
        data = arith.compress(raw, order=0)
    elif method == M_FQZ:
        from . import fqzcomp
        data = fqzcomp.compress(raw)
    elif method == M_TOK3:
        from . import tok3
        data = tok3.compress(raw)
    elif method == M_RAW:
        data = raw
    else:
        raise NotImplementedError(method)
    out = bytearray([method, ctype])
    out += write_itf8(content_id)
    out += write_itf8(len(data))
    out += write_itf8(len(raw))
    out += data
    out += struct.pack("<I", zlib.crc32(bytes(out)) & 0xFFFFFFFF)
    return bytes(out)


@dataclass
class ContainerHeader:
    length: int
    ref_id: int
    start: int
    span: int
    n_records: int
    counter: int
    n_bases: int
    n_blocks: int
    landmarks: list[int]


def read_container_header(buf: bytes, pos: int) -> tuple[ContainerHeader, int]:
    hdr_start = pos
    length = struct.unpack_from("<i", buf, pos)[0]
    pos += 4
    ref_id, pos = read_itf8(buf, pos)
    start, pos = read_itf8(buf, pos)
    span, pos = read_itf8(buf, pos)
    n_records, pos = read_itf8(buf, pos)
    counter, pos = read_ltf8(buf, pos)
    n_bases, pos = read_ltf8(buf, pos)
    n_blocks, pos = read_itf8(buf, pos)
    n_landmarks, pos = read_itf8(buf, pos)
    landmarks = []
    for _ in range(n_landmarks):
        lm, pos = read_itf8(buf, pos)
        landmarks.append(lm)
    if pos + 4 > len(buf):
        raise ValueError("CRAM container header: truncated (missing CRC32)")
    stored = struct.unpack_from("<I", buf, pos)[0]
    # CRC32 of the preceding container-header bytes (CRAM 3.x §9)
    if (zlib.crc32(buf[hdr_start:pos]) & 0xFFFFFFFF) != stored:
        raise ValueError("CRAM container header: CRC32 mismatch "
                         "(corrupt data)")
    pos += 4
    return ContainerHeader(length, ref_id, start, span, n_records, counter,
                           n_bases, n_blocks, landmarks), pos


def write_container_header(ref_id: int, start: int, span: int,
                           n_records: int, counter: int, n_bases: int,
                           n_blocks: int, landmarks: list[int],
                           blocks_len: int) -> bytes:
    body = bytearray()
    body += write_itf8(ref_id)
    body += write_itf8(start)
    body += write_itf8(span)
    body += write_itf8(n_records)
    body += write_ltf8(counter)
    body += write_ltf8(n_bases)
    body += write_itf8(n_blocks)
    body += write_itf8(len(landmarks))
    for lm in landmarks:
        body += write_itf8(lm)
    out = struct.pack("<i", blocks_len) + bytes(body)
    out += struct.pack("<I", zlib.crc32(out) & 0xFFFFFFFF)
    return out


# -------------------------------------------------------------- encodings
class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 0

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos]
            v = (v << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v

    def read_bit(self) -> int:
        byte = self.data[self.pos]
        v = (byte >> (7 - self.bit)) & 1
        self.bit += 1
        if self.bit == 8:
            self.bit = 0
            self.pos += 1
        return v


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.nbits = 0

    def write_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.cur = (self.cur << 1) | ((v >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.cur)
                self.cur = 0
                self.nbits = 0

    def finish(self) -> bytes:
        if self.nbits:
            self.out.append(self.cur << (8 - self.nbits))
            self.cur = 0
            self.nbits = 0
        return bytes(self.out)


class ExternalStream:
    """Sequential reader over one external block's bytes.

    Integer streams get a bulk fast path: the first read_itf8 decodes the
    WHOLE remaining block in one native pass (hla_itf8_decode_all); later
    reads pop from the array.  Byte-level reads stay correct because `pos`
    is maintained on the fast path and the bulk index resyncs on mismatch
    (in practice one content id serves one series, so streams are either
    pure-int or pure-bytes)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self._vals = None
        self._ends = None
        self._i = 0
        self._starts = None

    def read_byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def read_bytes(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def read_itf8(self) -> int:
        if self._vals is None:
            from .. import native
            res = native.itf8_decode_all(self.data, self.pos) \
                if native.available() else None
            if res is None:
                v, self.pos = read_itf8(self.data, self.pos)
                return v
            self._vals, self._ends = res
            self._vals = self._vals.tolist()
            self._ends = self._ends.tolist()
            self._starts = [self.pos] + self._ends[:-1]
            self._i = 0
        i = self._i
        if i < len(self._vals) and self._starts[i] == self.pos:
            self.pos = self._ends[i]
            self._i = i + 1
            return self._vals[i]
        # resync after interleaved byte reads (rare): scalar decode and
        # realign the bulk cursor
        v, self.pos = read_itf8(self.data, self.pos)
        import bisect
        self._i = bisect.bisect_left(self._starts, self.pos)
        return v

    def read_until(self, stop: int) -> bytes:
        end = self.data.index(stop, self.pos)
        out = self.data[self.pos:end]
        self.pos = end + 1
        return out


# codec ids
C_NULL, C_EXTERNAL, C_GOLOMB, C_HUFFMAN, C_BYTE_ARRAY_LEN, \
    C_BYTE_ARRAY_STOP, C_BETA, C_SUBEXP, C_GOLOMB_RICE, C_GAMMA = range(10)


@dataclass
class Encoding:
    codec: int
    params: bytes
    # parsed params:
    content_id: int = -1
    stop_byte: int = 0
    offset: int = 0
    nbits: int = 0
    k: int = 0
    alphabet: list[int] = field(default_factory=list)
    bitlens: list[int] = field(default_factory=list)
    sub_len: "Encoding" = None
    sub_val: "Encoding" = None
    _huff: dict = None

    @classmethod
    def parse(cls, codec: int, params: bytes) -> "Encoding":
        e = cls(codec, params)
        p = 0
        if codec == C_EXTERNAL:
            e.content_id, p = read_itf8(params, p)
        elif codec == C_HUFFMAN:
            n, p = read_itf8(params, p)
            for _ in range(n):
                v, p = read_itf8(params, p)
                e.alphabet.append(v)
            n2, p = read_itf8(params, p)
            for _ in range(n2):
                v, p = read_itf8(params, p)
                e.bitlens.append(v)
            e._build_huffman()
        elif codec == C_BYTE_ARRAY_LEN:
            lc, p = read_itf8(params, p)
            ll, p = read_itf8(params, p)
            e.sub_len = Encoding.parse(lc, params[p:p + ll])
            p += ll
            vc, p = read_itf8(params, p)
            vl, p = read_itf8(params, p)
            e.sub_val = Encoding.parse(vc, params[p:p + vl])
            p += vl
        elif codec == C_BYTE_ARRAY_STOP:
            e.stop_byte = params[p]
            p += 1
            e.content_id, p = read_itf8(params, p)
        elif codec == C_BETA:
            e.offset, p = read_itf8(params, p)
            e.nbits, p = read_itf8(params, p)
        elif codec == C_SUBEXP:
            e.offset, p = read_itf8(params, p)
            e.k, p = read_itf8(params, p)
        elif codec == C_GAMMA:
            e.offset, p = read_itf8(params, p)
        return e

    def _build_huffman(self):
        """Canonical Huffman codes from (alphabet, bit lengths)."""
        if len(self.alphabet) == 1 and self.bitlens[0] == 0:
            self._huff = {}  # constant
            return
        pairs = sorted(zip(self.bitlens, self.alphabet))
        codes = {}
        code = 0
        prev_len = pairs[0][0]
        for blen, sym in pairs:
            code <<= (blen - prev_len)
            codes[(blen, code)] = sym
            code += 1
            prev_len = blen
        self._huff = codes

    # ------------------------------------------------------- decode value
    def read_int(self, core: BitReader, ext: dict) -> int:
        if self.codec == C_EXTERNAL:
            return ext[self.content_id].read_itf8()
        if self.codec == C_HUFFMAN:
            if not self._huff:
                return self.alphabet[0]
            code, blen = 0, 0
            while True:
                code = (code << 1) | core.read_bit()
                blen += 1
                sym = self._huff.get((blen, code))
                if sym is not None:
                    return sym
                if blen > 31:
                    raise ValueError("bad huffman stream")
        if self.codec == C_BETA:
            return core.read_bits(self.nbits) - self.offset
        if self.codec == C_GAMMA:
            n = 0
            while core.read_bit() == 0:
                n += 1
            v = 1
            for _ in range(n):
                v = (v << 1) | core.read_bit()
            return v - self.offset
        if self.codec == C_SUBEXP:
            n = 0
            while core.read_bit() == 1:
                n += 1
            if n == 0:
                b = self.k
                u = core.read_bits(b)
                return u - self.offset
            b = self.k + n - 1
            u = core.read_bits(b)
            return ((1 << b) | u) - self.offset
        raise NotImplementedError(f"int codec {self.codec}")

    def read_byte(self, core: BitReader, ext: dict) -> int:
        if self.codec == C_EXTERNAL:
            return ext[self.content_id].read_byte()
        if self.codec == C_HUFFMAN:
            return self.read_int(core, ext)
        if self.codec == C_BETA:
            return core.read_bits(self.nbits) - self.offset
        raise NotImplementedError(f"byte codec {self.codec}")

    def read_array(self, core: BitReader, ext: dict,
                   length: int | None = None) -> bytes:
        if self.codec == C_BYTE_ARRAY_STOP:
            return ext[self.content_id].read_until(self.stop_byte)
        if self.codec == C_BYTE_ARRAY_LEN:
            n = self.sub_len.read_int(core, ext)
            if self.sub_val.codec == C_EXTERNAL:
                return ext[self.sub_val.content_id].read_bytes(n)
            return bytes(self.sub_val.read_byte(core, ext) for _ in range(n))
        if self.codec == C_EXTERNAL:
            assert length is not None
            return ext[self.content_id].read_bytes(length)
        raise NotImplementedError(f"array codec {self.codec}")


# ------------------------------------------------- compression header
@dataclass
class CompressionHeader:
    rn_preserved: bool = True
    ap_delta: bool = True
    ref_required: bool = True
    sub_matrix: bytes = b"\x00" * 5
    tag_dict: list[list[tuple[str, str]]] = field(default_factory=list)
    encodings: dict = field(default_factory=dict)      # series -> Encoding
    tag_encodings: dict = field(default_factory=dict)  # int key -> Encoding

    # decode table: sub_matrix -> {ref_base: code -> alt_base}
    def sub_table(self) -> dict[int, list[int]]:
        bases = b"ACGTN"
        table = {}
        for ri, rbase in enumerate(bases):
            byte = self.sub_matrix[ri]
            alts = [b for b in bases if b != rbase]
            row = [0] * 4
            for ai, alt in enumerate(alts):
                code = (byte >> (6 - 2 * ai)) & 0x3
                row[code] = alt
            table[rbase] = row
        return table


def parse_compression_header(data: bytes) -> CompressionHeader:
    ch = CompressionHeader()
    pos = 0
    # preservation map
    _size, pos = read_itf8(data, pos)
    n, pos = read_itf8(data, pos)
    for _ in range(n):
        key = data[pos:pos + 2].decode()
        pos += 2
        if key == "RN":
            ch.rn_preserved = bool(data[pos]); pos += 1
        elif key == "AP":
            ch.ap_delta = bool(data[pos]); pos += 1
        elif key == "RR":
            ch.ref_required = bool(data[pos]); pos += 1
        elif key == "SM":
            ch.sub_matrix = data[pos:pos + 5]; pos += 5
        elif key == "TD":
            td_len, pos = read_itf8(data, pos)
            blob = data[pos:pos + td_len]
            pos += td_len
            for line in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") \
                    else blob.split(b"\x00"):
                tags = []
                for i in range(0, len(line), 3):
                    trip = line[i:i + 3]
                    if len(trip) == 3:
                        tags.append((trip[:2].decode(), chr(trip[2])))
                ch.tag_dict.append(tags)
        else:
            raise ValueError(f"unknown preservation key {key!r}")
    # data series encodings
    _size, pos = read_itf8(data, pos)
    n, pos = read_itf8(data, pos)
    for _ in range(n):
        key = data[pos:pos + 2].decode()
        pos += 2
        codec, pos = read_itf8(data, pos)
        plen, pos = read_itf8(data, pos)
        ch.encodings[key] = Encoding.parse(codec, data[pos:pos + plen])
        pos += plen
    # tag encodings
    _size, pos = read_itf8(data, pos)
    n, pos = read_itf8(data, pos)
    for _ in range(n):
        key, pos = read_itf8(data, pos)
        codec, pos = read_itf8(data, pos)
        plen, pos = read_itf8(data, pos)
        ch.tag_encodings[key] = Encoding.parse(codec, data[pos:pos + plen])
        pos += plen
    return ch


# ------------------------------------------------------------ slice header
@dataclass
class SliceHeader:
    ref_id: int
    start: int
    span: int
    n_records: int
    counter: int
    n_blocks: int
    content_ids: list[int]
    embedded_ref_id: int
    md5: bytes


def parse_slice_header(data: bytes) -> SliceHeader:
    pos = 0
    ref_id, pos = read_itf8(data, pos)
    start, pos = read_itf8(data, pos)
    span, pos = read_itf8(data, pos)
    n_records, pos = read_itf8(data, pos)
    counter, pos = read_ltf8(data, pos)
    n_blocks, pos = read_itf8(data, pos)
    n_ids, pos = read_itf8(data, pos)
    ids = []
    for _ in range(n_ids):
        v, pos = read_itf8(data, pos)
        ids.append(v)
    emb, pos = read_itf8(data, pos)
    md5 = data[pos:pos + 16]
    return SliceHeader(ref_id, start, span, n_records, counter, n_blocks,
                      ids, emb, md5)


# ------------------------------------------------------------ the reader
class CramReader:
    """Iterate a CRAM 3.x file as BamRecords.

    `reference`: None, a dict {contig_name: sequence}, or a callable
    (name, start0, end0) -> str returning reference bases.  Required for
    reference-based CRAMs (RR=true) unless slices embed their reference.
    """

    def __init__(self, path: str, reference=None):
        self.path = path
        with open(path, "rb") as fh:
            self.buf = fh.read()
        if self.buf[:4] != CRAM_MAGIC:
            raise ValueError(f"{path}: not a CRAM file")
        self.major, self.minor = self.buf[4], self.buf[5]
        if self.major != 3:
            # CRAM 2.x blocks/containers carry no CRC32 fields — parsing
            # them with the 3.0 layout would silently misalign
            raise ValueError(
                f"unsupported CRAM version {self.major}.{self.minor} — "
                "only CRAM 3.0/3.x decodes (convert with samtools)")
        self.pos = 26  # 4 magic + 2 version + 20 file id
        self.reference = reference
        # file header container
        try:
            hdr, self.pos = read_container_header(self.buf, self.pos)
            end = self.pos + hdr.length
            blk, _ = read_block(self.buf, self.pos)
        except (IndexError, struct.error) as e:
            raise ValueError(f"{path}: truncated or corrupt CRAM "
                             f"({e})") from e
        self.pos = end
        if blk.content_type != CT_FILE_HEADER:
            raise ValueError("first CRAM container is not the file header")
        hlen = struct.unpack_from("<i", blk.data, 0)[0]
        self.header_text = blk.data[4:4 + hlen].decode(errors="replace")
        self.references: list[tuple[str, int]] = []
        for line in self.header_text.splitlines():
            if line.startswith("@SQ"):
                name, ln = None, 0
                for f in line.split("\t")[1:]:
                    if f.startswith("SN:"):
                        name = f[3:]
                    elif f.startswith("LN:"):
                        ln = int(f[3:])
                if name:
                    self.references.append((name, ln))

    def contigs(self) -> dict[str, int]:
        return dict(self.references)

    def close(self) -> None:
        pass  # fully buffered

    # -------------------------------------------------------- reference
    def _ref_bases(self, ref_id: int, start0: int, end0: int) -> bytes:
        # (embedded references are sliced by _reconstruct itself — they are
        # slice-local, not contig-global, so this function must not see
        # them)
        if self.reference is None:
            raise ValueError(
                "CRAM slice requires the reference genome — pass --ref "
                "<genome.fa> (CLI) or reference= (dict or callable) to "
                "CramReader/extract_reads")
        name = self.references[ref_id][0]
        if callable(self.reference):
            seq = self.reference(name, start0, end0)
        else:
            seq = self.reference[name][start0:end0]
        # the spec normalises references to uppercase before use — the
        # writer compares case-insensitively, so raw soft-masked
        # (lowercase) bases here would reconstruct wrong reads
        return (seq.encode() if isinstance(seq, str) else bytes(seq)).upper()

    # -------------------------------------------------------- iteration
    def __iter__(self):
        try:
            yield from self._iter_records()
        except (ValueError, NotImplementedError):
            raise
        except Exception as e:  # noqa: BLE001 — untrusted input: any
            # parser failure surfaces as a clean rejection, never a crash
            raise ValueError(f"{self.path}: truncated or corrupt CRAM "
                             f"({type(e).__name__}: {e})") from e

    def _iter_records(self):
        pos = self.pos
        buf = self.buf
        saw_eof = False
        while pos < len(buf):
            hdr, pos = read_container_header(buf, pos)
            end = pos + hdr.length
            if hdr.n_records == 0:
                # empty container — incl. the special EOF sentinel
                # (start 4542278, CRAM 3.0 §11); requiring it at the end
                # is what catches truncation at a container boundary
                saw_eof = hdr.start == 4542278
                pos = end
                continue
            saw_eof = False
            blk, bpos = read_block(buf, pos)
            if blk.content_type != CT_COMPRESSION_HEADER:
                raise ValueError("expected compression header block")
            ch = parse_compression_header(blk.data)
            # slices via landmarks (offsets from start of first block)
            for lm in hdr.landmarks:
                spos = pos + lm
                sblk, spos = read_block(buf, spos)
                if sblk.content_type != CT_SLICE_HEADER:
                    raise ValueError("expected slice header block")
                sh = parse_slice_header(sblk.data)
                core = None
                ext: dict[int, ExternalStream] = {}
                embedded_ref = None
                for _ in range(sh.n_blocks):
                    b, spos = read_block(buf, spos)
                    if b.content_type == CT_CORE:
                        core = BitReader(b.data)
                    elif b.content_type == CT_EXTERNAL:
                        ext[b.content_id] = ExternalStream(b.data)
                        if b.content_id == sh.embedded_ref_id:
                            embedded_ref = b.data
                yield from self._decode_slice(hdr, ch, sh, core, ext,
                                              embedded_ref)
            pos = end
        if not saw_eof:
            raise ValueError(f"{self.path}: missing CRAM EOF container "
                             "(truncated file?)")

    def _decode_slice(self, hdr, ch: CompressionHeader, sh: SliceHeader,
                      core: BitReader, ext: dict, embedded_ref):
        enc = ch.encodings
        sub_table = ch.sub_table()
        records = []
        last_pos = sh.start
        for ri in range(sh.n_records):
            rec = {}
            bf = enc["BF"].read_int(core, ext)
            cf = enc["CF"].read_int(core, ext)
            if sh.ref_id == -2:
                rid = enc["RI"].read_int(core, ext)
            else:
                rid = sh.ref_id
            rl = enc["RL"].read_int(core, ext)
            ap = enc["AP"].read_int(core, ext)
            if ch.ap_delta:
                pos1 = last_pos + ap
                last_pos = pos1
            else:
                pos1 = ap
            rg = enc["RG"].read_int(core, ext) if "RG" in enc else -1
            if ch.rn_preserved:
                name = enc["RN"].read_array(core, ext).decode()
            else:
                name = f"cram.{sh.counter + ri}"
            mate = None
            nf = -1
            if cf & CF_DETACHED:
                mf = enc["MF"].read_int(core, ext)
                if not ch.rn_preserved:
                    name = enc["RN"].read_array(core, ext).decode()
                ns = enc["NS"].read_int(core, ext)
                np_ = enc["NP"].read_int(core, ext)
                ts = enc["TS"].read_int(core, ext)
                mate = (mf, ns, np_, ts)
            elif cf & CF_HAS_MATE_DOWNSTREAM:
                nf = enc["NF"].read_int(core, ext)
            tl = enc["TL"].read_int(core, ext)
            tags = []
            if 0 <= tl < len(ch.tag_dict):
                for tag, ttype in ch.tag_dict[tl]:
                    key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) \
                        | ord(ttype)
                    tenc = ch.tag_encodings[key]
                    blob = tenc.read_array(core, ext)
                    tags.append((tag, ttype, blob))
            features = []
            mapq = 0
            if not (bf & BAM_FUNMAP):
                fn = enc["FN"].read_int(core, ext)
                fpos = 0
                for _ in range(fn):
                    fc = chr(enc["FC"].read_byte(core, ext))
                    fp = enc["FP"].read_int(core, ext)
                    fpos += fp
                    if fc == "B":
                        base = enc["BA"].read_byte(core, ext)
                        qual = enc["QS"].read_byte(core, ext)
                        features.append((fc, fpos, (base, qual)))
                    elif fc == "X":
                        features.append((fc, fpos,
                                         enc["BS"].read_byte(core, ext)))
                    elif fc == "I":
                        features.append((fc, fpos,
                                         enc["IN"].read_array(core, ext)))
                    elif fc == "i":
                        features.append((fc, fpos,
                                         enc["BA"].read_byte(core, ext)))
                    elif fc == "D":
                        features.append((fc, fpos,
                                         enc["DL"].read_int(core, ext)))
                    elif fc == "S":
                        features.append((fc, fpos,
                                         enc["SC"].read_array(core, ext)))
                    elif fc == "N":
                        features.append((fc, fpos,
                                         enc["RS"].read_int(core, ext)))
                    elif fc == "P":
                        features.append((fc, fpos,
                                         enc["PD"].read_int(core, ext)))
                    elif fc == "H":
                        features.append((fc, fpos,
                                         enc["HC"].read_int(core, ext)))
                    elif fc == "Q":
                        features.append((fc, fpos,
                                         enc["QS"].read_byte(core, ext)))
                    elif fc == "q":
                        features.append((fc, fpos,
                                         enc["QQ"].read_array(core, ext)))
                    elif fc == "b":
                        features.append((fc, fpos,
                                         enc["BB"].read_array(core, ext)))
                    else:
                        raise ValueError(f"unknown feature code {fc!r}")
                mapq = enc["MQ"].read_int(core, ext)
                quals = None
                if cf & CF_QUAL_STORED:
                    quals = enc["QS"].read_array(core, ext, length=rl) \
                        if enc["QS"].codec == C_EXTERNAL else bytes(
                            enc["QS"].read_byte(core, ext)
                            for _ in range(rl))
                seq, cigar, quals = self._reconstruct(
                    rid, pos1 - 1, rl, features, sub_table, sh,
                    embedded_ref, quals, ch)
            else:
                if cf & CF_NO_SEQ:
                    seq = "*"
                    quals = None
                else:
                    bb = bytes(enc["BA"].read_byte(core, ext)
                               for _ in range(rl))
                    seq = bb.decode()
                    quals = None
                    if cf & CF_QUAL_STORED:
                        quals = enc["QS"].read_array(core, ext, length=rl) \
                            if enc["QS"].codec == C_EXTERNAL else bytes(
                                enc["QS"].read_byte(core, ext)
                                for _ in range(rl))
                cigar = []
            if quals is not None:
                # vectorised phred+33: a chr() genexpr here cost ~30% of
                # whole-file decode time
                qual_str = (np.frombuffer(bytes(quals), np.uint8)
                            + np.uint8(33)).tobytes().decode("latin-1")
            else:
                qual_str = "*"
            records.append(dict(
                name=name, flag=bf, ref_id=rid, pos=pos1 - 1, mapq=mapq,
                cigar=cigar, seq=seq, qual=qual_str, cf=cf, nf=nf,
                mate=mate, tags=tags, idx=ri))
        # attach mates within the slice (CF_HAS_MATE_DOWNSTREAM + NF):
        # name + mate flags + RNEXT/PNEXT/TLEN on both records
        def _ref_len(rec):
            return sum(n for n, op in rec["cigar"]
                       if op in (0, 2, 3, 7, 8))

        for r in records:
            if r["cf"] & CF_HAS_MATE_DOWNSTREAM and r["nf"] >= 0:
                mi = r["idx"] + r["nf"] + 1
                if mi < len(records):
                    m = records[mi]
                    m["name"] = r["name"]
                    # patch mate-related BAM flags on both
                    for a, b in ((r, m), (m, r)):
                        a["flag"] |= BAM_FPAIRED
                        if b["flag"] & BAM_FREVERSE:
                            a["flag"] |= BAM_FMREVERSE
                        if b["flag"] & BAM_FUNMAP:
                            a["flag"] |= BAM_FMUNMAP
                        a["mate_ref_id"] = b["ref_id"]
                        a["mate_pos"] = b["pos"]
                    # TLEN: signed leftmost-start to rightmost-end span;
                    # 0 when the mates map to different reference
                    # sequences (BAM convention — a cross-contig "span"
                    # would mix coordinate systems)
                    if r["ref_id"] != m["ref_id"]:
                        r["tlen"] = m["tlen"] = 0
                    else:
                        left, right = ((r, m) if r["pos"] <= m["pos"]
                                       else (m, r))
                        span = (right["pos"] + _ref_len(right)) \
                            - left["pos"]
                        left["tlen"] = span
                        right["tlen"] = -span
            elif r["cf"] & CF_DETACHED and r["mate"] is not None:
                mf, ns, np_, ts = r["mate"]
                r["flag"] |= BAM_FPAIRED
                if mf & MF_MATE_REVERSE:
                    r["flag"] |= BAM_FMREVERSE
                if mf & MF_MATE_UNMAPPED:
                    r["flag"] |= BAM_FMUNMAP
                r["mate_ref_id"] = ns
                r["mate_pos"] = np_ - 1
                r["tlen"] = ts
        for r in records:
            yield BamRecord(name=r["name"], flag=r["flag"],
                            ref_id=r["ref_id"], pos=r["pos"],
                            mapq=r["mapq"], cigar=r["cigar"], seq=r["seq"],
                            qual=r["qual"],
                            mate_ref_id=r.get("mate_ref_id", -1),
                            mate_pos=r.get("mate_pos", -1),
                            tlen=r.get("tlen", 0))

    def _reconstruct(self, rid, pos0, rl, features, sub_table, sh,
                     embedded_ref, quals, ch):
        """Rebuild SEQ + CIGAR from reference bases + read features
        (CRAM 3.0 spec §10.5)."""
        seq = bytearray(rl)
        if quals is None:
            quals = bytearray([0xFF] * rl)  # missing -> '*' handling below
        else:
            quals = bytearray(quals)
        cigar = []

        def add_op(op, n):
            if n <= 0:
                return
            if cigar and cigar[-1][1] == op:
                cigar[-1] = (cigar[-1][0] + n, op)
            else:
                cigar.append((n, op))

        # reference span needed: rl + total deletions/skips
        extra = sum(f[2] if f[0] in ("D", "N") else 0 for f in features)
        ref = None
        softclip = sum(len(f[2]) for f in features if f[0] == "S")
        ins = sum(len(f[2]) if f[0] == "I" else (1 if f[0] == "i" else 0)
                  for f in features)
        ref_span = rl + extra - softclip - ins
        if ch.ref_required or embedded_ref is not None:
            if embedded_ref is not None:
                ref = bytes(embedded_ref[pos0 - (sh.start - 1):]).upper()
            else:
                ref = self._ref_bases(rid, pos0, pos0 + max(ref_span, 0))
            if ref is not None and len(ref) < max(ref_span, 0):
                # alignment overhangs the contig end: htslib pads the
                # reference with N — a short slice must NOT shrink the
                # bytearray slice-assignments below (silent base shifts)
                ref = bytes(ref) + b"N" * (max(ref_span, 0) - len(ref))
        rp = 0   # read pos (0-based)
        ref_off = 0
        for fc, fpos, val in sorted(features, key=lambda f: f[1]):
            f0 = fpos - 1  # 1-based in read -> 0-based
            # copy matched bases up to this feature
            n_match = f0 - rp
            if n_match > 0:
                if ref is None:
                    raise ValueError("reference required to decode match "
                                     "bases (RR=true)")
                seq[rp:f0] = ref[ref_off:ref_off + n_match]
                add_op(0, n_match)
                rp += n_match
                ref_off += n_match
            if fc == "B":
                base, q = val
                seq[rp] = base
                quals[rp] = q
                add_op(0, 1)
                rp += 1
                ref_off += 1
            elif fc == "X":
                rbase = ref[ref_off] if ref is not None else ord("N")
                seq[rp] = sub_table[rbase if rbase in sub_table
                                    else ord("N")][val]
                add_op(0, 1)
                rp += 1
                ref_off += 1
            elif fc == "I":
                seq[rp:rp + len(val)] = val
                add_op(1, len(val))
                rp += len(val)
            elif fc == "i":
                seq[rp] = val
                add_op(1, 1)
                rp += 1
            elif fc == "D":
                add_op(2, val)
                ref_off += val
            elif fc == "N":
                add_op(3, val)
                ref_off += val
            elif fc == "S":
                seq[rp:rp + len(val)] = val
                add_op(4, len(val))
                rp += len(val)
            elif fc == "P":
                add_op(6, val)
            elif fc == "H":
                add_op(5, val)
            elif fc == "Q":
                quals[f0] = val
            elif fc == "q":
                quals[f0:f0 + len(val)] = val
            elif fc == "b":
                seq[rp:rp + len(val)] = val
                add_op(0, len(val))
                rp += len(val)
                ref_off += len(val)
        if rp < rl:
            n_match = rl - rp
            if ref is None:
                raise ValueError("reference required (RR=true)")
            seq[rp:rl] = ref[ref_off:ref_off + n_match]
            add_op(0, n_match)
            ref_off += n_match
        qa = np.frombuffer(bytes(quals), np.uint8)
        if (qa == 0xFF).all():
            return seq.decode(), cigar, None
        return seq.decode(), cigar, np.where(qa == 0xFF, 0, qa
                                             ).astype(np.uint8).tobytes()
