"""Native BAM/BGZF I/O.

The reference links BamTools and shells out to samtools/picard for region
extraction and FASTQ conversion (HLA-LA.pl:393-479).  Neither exists in this
framework's runtime, so BAM is read and written directly: BGZF block layer on
zlib, BAM record codec per the SAM spec.  A C++ fast path for block inflation
and record parsing lives in native/ (used when built; this module is the
always-available fallback and the format reference).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Iterator

SEQ_DECODE = "=ACMGRSVTWYHKDNB"
CIGAR_OPS = "MIDNSHP=X"

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


# ---------------------------------------------------------------- BGZF layer
def _iter_bgzf_blocks(fh) -> Iterator[bytes]:
    while True:
        head = fh.read(12)
        if len(head) == 0:
            return
        if len(head) < 12:
            raise ValueError("truncated BGZF header")
        magic1, magic2, method, flags, _mtime, _xfl, _os, xlen = \
            struct.unpack("<BBBBIBBH", head)
        if magic1 != 0x1F or magic2 != 0x8B:
            raise ValueError("not a BGZF/gzip stream")
        extra = fh.read(xlen)
        bsize = None
        off = 0
        while off + 4 <= len(extra):
            si1, si2, slen = struct.unpack_from("<BBH", extra, off)
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, off + 4)[0]
            off += 4 + slen
        if bsize is None:
            raise ValueError("missing BGZF BC subfield")
        cdata_len = bsize - xlen - 19
        if cdata_len < 0:
            raise ValueError("corrupt BGZF block (BSIZE smaller than header)")
        cdata = fh.read(cdata_len)
        tail = fh.read(8)
        if len(cdata) < cdata_len or len(tail) < 8:
            raise ValueError("truncated BGZF block")
        if cdata_len == 2 and cdata == b"\x03\x00":
            continue  # empty terminator block
        data = zlib.decompress(cdata, -15)
        # BGZF stores CRC32+ISIZE of the uncompressed payload; verifying
        # them is what keeps a bit-flipped-but-still-inflatable stream
        # from silently decoding to wrong bases (htslib does the same)
        crc, isize = struct.unpack("<II", tail)
        if len(data) != isize or (zlib.crc32(data) & 0xFFFFFFFF) != crc:
            raise ValueError("BGZF block CRC/ISIZE mismatch (corrupt data)")
        yield data


def _bgzf_compress_block(data: bytes) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = c.compress(data) + c.flush()
    total = 12 + 6 + len(cdata) + 8   # header + extra + payload + crc/isize
    header = struct.pack("<BBBBIBBH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
    extra = struct.pack("<BBHH", 66, 67, 2, total - 1)
    tail = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + extra + cdata + tail


class BgzfWriter:
    def __init__(self, path: str):
        self.fh = open(path, "wb")
        self.buf = bytearray()

    def write(self, data: bytes):
        self.buf += data
        while len(self.buf) >= 60000:
            self.fh.write(_bgzf_compress_block(bytes(self.buf[:60000])))
            del self.buf[:60000]

    def close(self):
        if self.buf:
            self.fh.write(_bgzf_compress_block(bytes(self.buf)))
        self.fh.write(BGZF_EOF)
        self.fh.close()


# ----------------------------------------------------------------- BAM layer
FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos: int              # 0-based
    mapq: int
    cigar: list[tuple[int, int]]   # (oplen, opcode)
    seq: str
    qual: str             # phred+33 string ('' if missing)
    mate_ref_id: int = -1
    mate_pos: int = -1
    tlen: int = 0
    tags: bytes = b""

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_read1(self) -> bool:
        return bool(self.flag & FLAG_READ1)

    def reference_end(self) -> int:
        end = self.pos
        for ln, op in self.cigar:
            if CIGAR_OPS[op] in "MDN=X":
                end += ln
        return end

    def cigar_string(self) -> str:
        return "".join(f"{ln}{CIGAR_OPS[op]}" for ln, op in self.cigar)


class BamReader:
    def __init__(self, path: str, use_native: bool = True):
        self.path = path
        self.fh = open(path, "rb")
        head = self.fh.read(4)
        if head == b"CRAM":
            raise ValueError(
                f"{path}: CRAM input is not supported by the native codec — "
                "convert to BAM first (samtools view -b -o out.bam in.cram)")
        # require the 28-byte BGZF EOF terminator: without this check a
        # file truncated at an exact block boundary silently yields fewer
        # reads (htslib errors on a missing EOF marker too)
        self.fh.seek(0, 2)
        fsize = self.fh.tell()
        if fsize >= len(BGZF_EOF):
            self.fh.seek(fsize - len(BGZF_EOF))
            if self.fh.read(len(BGZF_EOF)) != BGZF_EOF:
                raise ValueError(f"{path}: missing BGZF EOF marker "
                                 "(truncated BAM?)")
        self.fh.seek(0)
        self._buf = b""
        self._pos = 0
        self._blocks = None
        if use_native:
            from .. import native
            if native.available():
                raw = self.fh.read()
                inflated = native.bgzf_inflate_all(raw)
                if inflated is not None:
                    self._buf = inflated
        if not self._buf:
            self.fh.seek(0)
            self._blocks = _iter_bgzf_blocks(self.fh)
        magic = self._read(4)
        if magic != b"BAM\x01":
            if magic[:4] == b"CRAM":
                raise ValueError(
                    f"{path}: CRAM input is not supported by the native "
                    "codec — convert to BAM first (samtools view -b)")
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", self._read(4))[0]
        self.header_text = self._read(l_text).decode(errors="replace")
        n_ref = struct.unpack("<i", self._read(4))[0]
        self.references: list[tuple[str, int]] = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._read(4))[0]
            name = self._read(l_name)[:-1].decode()
            l_ref = struct.unpack("<i", self._read(4))[0]
            self.references.append((name, l_ref))

    def contigs(self) -> dict[str, int]:
        return dict(self.references)

    def _read(self, n: int) -> bytes:
        if self._blocks is None:
            out = self._buf[self._pos:self._pos + n]
            self._pos += len(out)
            if out and len(out) < n:
                raise ValueError("truncated BAM")
            return out
        while len(self._buf) - self._pos < n:
            try:
                block = next(self._blocks)
            except StopIteration:
                chunk = self._buf[self._pos:]
                self._buf = b""
                self._pos = 0
                if len(chunk) < n:
                    if chunk:
                        raise ValueError("truncated BAM")
                    return b""
                return chunk
            self._buf = self._buf[self._pos:] + block
            self._pos = 0
        out = self._buf[self._pos:self._pos + n]
        self._pos += n
        return out

    def __iter__(self) -> Iterator[BamRecord]:
        while True:
            raw = self._read(4)
            if not raw:
                return
            block_size = struct.unpack("<i", raw)[0]
            data = self._read(block_size)
            yield _parse_record(data)

    def close(self):
        self.fh.close()


def _parse_record(data: bytes) -> BamRecord:
    (ref_id, pos, l_name, mapq, _bin, n_cigar, flag, l_seq,
     mate_ref, mate_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", data, 0)
    off = 32
    name = data[off:off + l_name - 1].decode()
    off += l_name
    cigar = []
    for _ in range(n_cigar):
        v = struct.unpack_from("<I", data, off)[0]
        cigar.append((v >> 4, v & 0xF))
        off += 4
    nyb = data[off:off + (l_seq + 1) // 2]
    off += (l_seq + 1) // 2
    seq_chars = []
    for i in range(l_seq):
        b = nyb[i // 2]
        seq_chars.append(SEQ_DECODE[(b >> 4) if i % 2 == 0 else (b & 0xF)])
    seq = "".join(seq_chars)
    qual_raw = data[off:off + l_seq]
    off += l_seq
    if l_seq and qual_raw and qual_raw[0] == 0xFF:
        qual = ""
    else:
        qual = "".join(chr(q + 33) for q in qual_raw)
    return BamRecord(name=name, flag=flag, ref_id=ref_id, pos=pos, mapq=mapq,
                     cigar=cigar, seq=seq, qual=qual, mate_ref_id=mate_ref,
                     mate_pos=mate_pos, tlen=tlen, tags=data[off:])


class BamWriter:
    def __init__(self, path: str, references: list[tuple[str, int]],
                 header_text: str = "@HD\tVN:1.6\tSO:unsorted\n"):
        self.w = BgzfWriter(path)
        self.references = references
        out = bytearray(b"BAM\x01")
        ht = header_text.encode()
        out += struct.pack("<i", len(ht)) + ht
        out += struct.pack("<i", len(references))
        for name, length in references:
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb
            out += struct.pack("<i", length)
        self.w.write(bytes(out))

    def write(self, r: BamRecord):
        name_b = r.name.encode() + b"\x00"
        l_seq = len(r.seq)
        seq_nyb = bytearray((l_seq + 1) // 2)
        for i, c in enumerate(r.seq):
            code = SEQ_DECODE.find(c)
            if code < 0:
                code = 15
            if i % 2 == 0:
                seq_nyb[i // 2] |= code << 4
            else:
                seq_nyb[i // 2] |= code
        qual_b = (bytes(ord(q) - 33 for q in r.qual) if r.qual
                  else b"\xff" * l_seq)
        body = bytearray()
        body += struct.pack("<iiBBHHHiiii", r.ref_id, r.pos, len(name_b),
                            r.mapq, 0, len(r.cigar), r.flag, l_seq,
                            r.mate_ref_id, r.mate_pos, r.tlen)
        body += name_b
        for ln, op in r.cigar:
            body += struct.pack("<I", (ln << 4) | op)
        body += bytes(seq_nyb) + qual_b + r.tags
        self.w.write(struct.pack("<i", len(body)) + bytes(body))

    def close(self):
        self.w.close()


# ------------------------------------------------------------- conveniences
# full IUPAC complement (BAM SEQ nibbles decode to '=ACMGRSVTWYHKDBN');
# unknown characters pass through unchanged
_COMP_TABLE = bytes.maketrans(b"ACGTUacgtuRYSWKMBVDHryswkmbvdh",
                              b"TGCAAtgcaaYRSWMKVBHDyrswmkvbhd")


def revcomp(s: str) -> str:
    return s.encode().translate(_COMP_TABLE)[::-1].decode()


def record_to_fastq(r: BamRecord):
    """SamToFastq semantics: emit the read in sequencing orientation."""
    from .fastq import FastqRead
    seq, qual = r.seq, r.qual or ("I" * len(r.seq))
    if r.is_reverse:
        seq = revcomp(seq)
        qual = qual[::-1]
    return FastqRead(r.name, seq, qual)


def estimate_insert_size_from_bam(path: str, max_pairs: int = 4000,
                                  cram_reference=None
                                  ) -> tuple[float, float]:
    """Insert-size estimate straight from BAM/CRAM mate fields — the
    graph-free estimateInsertSize_noGraph (processBAM.cpp:866-990):
    histogram of |TLEN| over proper primary pairs -> (median, spread)."""
    if is_cram(path):
        from .cram import CramReader
        rd = CramReader(path, reference=cram_reference)
    else:
        rd = BamReader(path)
    hist: dict[int, float] = {}
    n = 0
    for rec in rd:
        if n >= max_pairs:
            break
        if rec.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY | FLAG_UNMAPPED):
            continue
        if not (rec.flag & FLAG_PAIRED) or rec.tlen <= 0:
            continue
        hist[int(rec.tlen)] = hist.get(int(rec.tlen), 0.0) + 1.0
        n += 1
    rd.close()
    if not hist:
        import sys
        print("WARNING: no proper pairs with TLEN found — insert size "
              "falls back to (300, 100)", file=sys.stderr, flush=True)
        return 300.0, 100.0
    from ..models.aligner import insert_size_from_histogram
    return insert_size_from_histogram(hist)


def is_cram(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(4) == b"CRAM"


def extract_reads(bam_path: str,
                  regions: list[tuple[str, int, int]] | None,
                  include_unmapped: bool = True, with_tags: bool = False,
                  cram_reference=None):
    """Extract primary records overlapping `regions` (contig, start0, stop0;
    stop=0 means whole contig) plus unmapped reads — the HLA-LA.pl
    extraction step (HLA-LA.pl:393-465) without samtools.  Accepts BAM or
    CRAM input (HLA-LA.pl:221-229); CRAM needs `cram_reference` (dict or
    (name, start, end) callable) unless the slices embed their reference.
    Returns ({name: [records]}, contigs).

    The default BAM path filters on the native packed arrays (vectorised
    over all records) and materialises BamRecord objects only for the
    selected reads; pass with_tags=True to force the record-by-record path,
    which preserves optional tag bytes (the packed parser drops them)."""
    if is_cram(bam_path):
        from .cram import CramReader
        if isinstance(cram_reference, CramReader):
            rd = cram_reference      # reuse an already-buffered reader
        else:
            rd = CramReader(bam_path, reference=cram_reference)
    else:
        if not with_tags:
            res = _extract_reads_packed(bam_path, regions, include_unmapped)
            if res is not None:
                return res
        rd = BamReader(bam_path)
    name_to_id = {n: i for i, (n, _) in enumerate(rd.references)}
    wanted: dict[int, list[tuple[int, int]]] = {}
    if regions:
        for contig, start, stop in regions:
            if contig in name_to_id:
                wanted.setdefault(name_to_id[contig], []).append((start, stop))
    by_name: dict[str, list[BamRecord]] = {}
    for rec in rd:
        if rec.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY):
            continue
        take = False
        if rec.is_unmapped:
            take = include_unmapped
        elif regions is None:
            take = True
        else:
            for start, stop in wanted.get(rec.ref_id, ()):
                if stop == 0 or (rec.pos < stop and rec.reference_end() > start):
                    take = True
                    break
        if take:
            by_name.setdefault(rec.name, []).append(rec)
    contigs = rd.contigs()
    rd.close()
    return by_name, contigs


def _extract_reads_packed(bam_path, regions, include_unmapped):
    import numpy as np

    from .. import native
    if not native.available():
        return None
    rd = BamReader(bam_path)
    contigs = rd.contigs()
    if rd._blocks is not None or not rd._buf:
        # native inflate failed or unavailable: rd._buf holds at most the
        # lazily-loaded first block, NOT the whole stream — treating it as
        # such silently truncates the file (verified r2 regression)
        rd.close()
        return None
    stream = rd._buf[rd._pos:]
    rd.close()
    arrs = native.bam_parse_packed(stream)
    if arrs is None:
        return None
    n = arrs["n"]
    flag = arrs["flag"][:n].astype(np.int64)
    keep = (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
    unmapped = (flag & FLAG_UNMAPPED) != 0
    if regions is None:
        sel = keep & (~unmapped | bool(include_unmapped))
    else:
        # reference-consumed length per record (for overlap tests):
        # prefix sums over the cigar buffer, diffed at record boundaries
        cig = arrs["cigar_buf"]
        lens = (cig >> np.uint32(4)).astype(np.int64)
        opc = cig & np.uint32(0xF)
        consume = ((opc == 0) | (opc == 2) | (opc == 3)
                   | (opc == 7) | (opc == 8))
        cs = np.concatenate([[0], np.cumsum(lens * consume)])
        co = arrs["cigar_off"]
        ref_len = cs[co[1:n + 1]] - cs[co[:n]]
        pos = arrs["pos"][:n].astype(np.int64)
        rid = arrs["ref_id"][:n]
        name_to_id = {c: i for i, c in enumerate(contigs)}
        sel_mapped = np.zeros(n, dtype=bool)
        for contig, start, stop in regions:
            cid = name_to_id.get(contig)
            if cid is None:
                continue
            m = rid == cid
            if stop != 0:
                m = m & (pos < stop) & (pos + ref_len > start)
            sel_mapped |= m
        sel = keep & np.where(unmapped, bool(include_unmapped), sel_mapped)
    idx = np.nonzero(sel)[0]
    name_buf = arrs["name_buf"].tobytes()
    seq_buf = arrs["seq_buf"].tobytes()
    qual_buf = arrs["qual_buf"].tobytes()
    no_ = arrs["name_off"]
    so_ = arrs["seq_off"]
    co_ = arrs["cigar_off"]
    cig = arrs["cigar_buf"]
    by_name: dict[str, list[BamRecord]] = {}
    for i in idx:
        i = int(i)
        s0, s1 = int(so_[i]), int(so_[i + 1])
        q = qual_buf[s0:s1]
        if q and q[0] == 0:
            q = b""
        c0, c1 = int(co_[i]), int(co_[i + 1])
        rec = BamRecord(
            name=name_buf[no_[i]:no_[i + 1]].decode(),
            flag=int(flag[i]), ref_id=int(arrs["ref_id"][i]),
            pos=int(arrs["pos"][i]), mapq=int(arrs["mapq"][i]),
            cigar=[(int(v) >> 4, int(v) & 0xF) for v in cig[c0:c1]],
            seq=seq_buf[s0:s1].decode(),
            qual=q.decode("latin-1"),
            mate_ref_id=int(arrs["mate_ref_id"][i]),
            mate_pos=int(arrs["mate_pos"][i]), tlen=int(arrs["tlen"][i]))
        by_name.setdefault(rec.name, []).append(rec)
    return by_name, contigs


def bam_to_fastq_pairs(by_name: dict[str, list[BamRecord]]):
    """Group extracted records into mate pairs + unpaired reads."""
    pairs = []
    unpaired = []
    for name, recs in by_name.items():
        r1 = next((r for r in recs if r.flag & FLAG_READ1), None)
        r2 = next((r for r in recs if r.flag & FLAG_READ2), None)
        if r1 is not None and r2 is not None:
            pairs.append((record_to_fastq(r1), record_to_fastq(r2)))
        else:
            for r in recs:
                unpaired.append(record_to_fastq(r))
    return pairs, unpaired
