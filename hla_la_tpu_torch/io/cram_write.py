"""CRAM 3.0 writer (test/round-trip subset).

Writes structurally valid CRAM 3.0 exercising the decoder's real paths:
containers + slices, gzip / rANS4x8 / raw block compression, EXTERNAL /
HUFFMAN / BETA / BYTE_ARRAY_LEN / BYTE_ARRAY_STOP encodings, reference-based
feature encoding (X/I/D/S/N substitution matrix), mate attachment via NF,
detached mates, unmapped records, and tag dictionaries.  The environment has
no samtools/htslib, so the suite uses this writer to produce CRAM inputs.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

from .bam import BamRecord
from .cram import (BAM_FPAIRED, BAM_FUNMAP, BitWriter, CF_DETACHED,
                   CF_HAS_MATE_DOWNSTREAM, CF_QUAL_STORED, CRAM_MAGIC,
                   CT_COMPRESSION_HEADER, CT_CORE, CT_EXTERNAL,
                   CT_FILE_HEADER, CT_SLICE_HEADER, M_GZIP, M_RANS4x8,
                   M_RANSNx16, M_RAW,
                   write_block, write_container_header, write_itf8,
                   write_ltf8)

BASES = b"ACGTN"
# one substitution-matrix byte 0x1B per ref base: alt k (in ACGTN-minus-ref
# order) gets code k
SUB_MATRIX = bytes([0x1B] * 5)


def _sub_code(ref_base: int, read_base: int) -> int | None:
    if ref_base not in BASES or read_base not in BASES:
        return None
    alts = [b for b in BASES if b != ref_base]
    if read_base not in alts:
        return None
    return alts.index(read_base)


# content ids for the external streams (arbitrary but distinct)
IDS = {k: i + 1 for i, k in enumerate(
    ["BF", "RL", "AP", "RN", "MF", "NS", "NP", "TS", "NF", "TL", "FN",
     "FC", "FP", "BS", "BA", "QS", "DL", "IN", "SC", "RS", "PD", "HC",
     "BBl", "BBv", "QQl", "QQv", "TAGl", "TAGv", "RI", "RG"])}


def _enc_external(content_id: int) -> tuple[int, bytes]:
    return 1, write_itf8(content_id)


def _enc_huffman(alphabet: list[int], bitlens: list[int]) -> tuple[int, bytes]:
    p = write_itf8(len(alphabet))
    for a in alphabet:
        p += write_itf8(a)
    p += write_itf8(len(bitlens))
    for b in bitlens:
        p += write_itf8(b)
    return 3, p


def _enc_beta(offset: int, nbits: int) -> tuple[int, bytes]:
    return 6, write_itf8(offset) + write_itf8(nbits)


def _enc_byte_array_stop(stop: int, content_id: int) -> tuple[int, bytes]:
    return 5, bytes([stop]) + write_itf8(content_id)


def _enc_byte_array_len(len_enc: tuple[int, bytes],
                        val_enc: tuple[int, bytes]) -> tuple[int, bytes]:
    p = write_itf8(len_enc[0]) + write_itf8(len(len_enc[1])) + len_enc[1]
    p += write_itf8(val_enc[0]) + write_itf8(len(val_enc[1])) + val_enc[1]
    return 4, p


def _canonical_huffman(values: list[int]) -> tuple[list[int], list[int]]:
    """Tiny canonical-huffman helper: alphabet + bit lengths for the value
    set (uniform-ish lengths are fine for the test writer)."""
    import collections
    import heapq
    counts = collections.Counter(values)
    syms = sorted(counts)
    if len(syms) == 1:
        return syms, [0]
    heap = [(c, i, (s,)) for i, (s, c) in enumerate(sorted(counts.items()))]
    heapq.heapify(heap)
    depth = {s: 0 for s in syms}
    nxt = len(heap)
    while len(heap) > 1:
        c1, _, g1 = heapq.heappop(heap)
        c2, _, g2 = heapq.heappop(heap)
        for s in g1 + g2:
            depth[s] += 1
        heapq.heappush(heap, (c1 + c2, nxt, g1 + g2))
        nxt += 1
    return syms, [depth[s] for s in syms]


def _huffman_codes(alphabet, bitlens) -> dict[int, tuple[int, int]]:
    pairs = sorted(zip(bitlens, alphabet))
    codes = {}
    code = 0
    prev = pairs[0][0]
    for blen, sym in pairs:
        code <<= (blen - prev)
        codes[sym] = (code, blen)
        code += 1
        prev = blen
    return codes


@dataclass
class _Streams:
    ext: dict = None
    core: BitWriter = None

    def __post_init__(self):
        self.ext = {k: bytearray() for k in IDS.values()}
        self.core = BitWriter()

    def put_itf8(self, series: str, v: int):
        self.ext[IDS[series]] += write_itf8(v)

    def put_byte(self, series: str, v: int):
        self.ext[IDS[series]].append(v)

    def put_stop_array(self, series: str, data: bytes, stop: int = 0):
        self.ext[IDS[series]] += data + bytes([stop])


def write_cram(path: str, contigs: list[tuple[str, int]],
               records: list[BamRecord], reference: dict[str, str],
               per_slice: int = 1000, method: int = M_GZIP,
               embed_reference: bool = False,
               qual_method: int | None = None,
               name_method: int | None = None) -> None:
    """records must be grouped so that mates are adjacent (name equality);
    mapped records' seq must match the reference except via M/I/D/S/N cigar
    walking (standard BAM semantics).  `qual_method` / `name_method`
    override the block codec for the quality (QS) and read-name (RN)
    streams — the CRAM 3.1 codecs fqzcomp and tok3 are stream-specific."""
    out = bytearray()
    out += CRAM_MAGIC + bytes([3, 0]) + b"hla_la_tpu_cram_____"
    # ---- file header container
    hdr_text = "@HD\tVN:1.6\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in contigs)
    blob = struct.pack("<i", len(hdr_text)) + hdr_text.encode()
    blk = write_block(M_RAW, CT_FILE_HEADER, 0, blob)
    out += write_container_header(-1, 0, 0, 0, 0, 0, 1, [0], len(blk))
    out += blk

    counter = 0
    for s0 in range(0, len(records), per_slice):
        chunk = records[s0:s0 + per_slice]
        out += _write_data_container(chunk, contigs, reference, counter,
                                     method, embed_reference,
                                     qual_method, name_method)
        counter += len(chunk)
    # ---- EOF container: the spec's canonical 38-byte sentinel (CRAM 3.0
    # §11) — container CRC 05bdd94f and block CRC ee63014b both reproduce
    # from our encoders (tests/test_cram.py::test_cram_eof_container),
    # which is what lets htslib-written files verify under our CRC checks
    # and our files end with the marker htslib looks for
    eof_blk = write_block(M_RAW, CT_COMPRESSION_HEADER, 0,
                          bytes([1, 0, 1, 0, 1, 0]))
    out += write_container_header(-1, 4542278, 0, 0, 0, 0, 1, [],
                                  len(eof_blk))
    out += eof_blk
    with open(path, "wb") as fh:
        fh.write(out)


def _write_data_container(records, contigs, reference, counter, method,
                          embed_reference, qual_method=None,
                          name_method=None) -> bytes:
    # unmapped records contribute ref_id -1: a chunk mixing one mapped
    # contig with unmapped reads MUST be multiref (with per-record RI),
    # else the decoder assigns the slice ref to the unmapped records
    ref_ids = {(-1 if (r.flag & BAM_FUNMAP) else r.ref_id)
               for r in records}
    multiref = len(ref_ids) != 1
    slice_ref = -2 if multiref else next(iter(ref_ids)) if ref_ids else -1
    mapped = [r for r in records if not (r.flag & BAM_FUNMAP)]
    if mapped and not multiref:
        start = min(r.pos for r in mapped) + 1
        span = max(r.pos + sum(n for n, op in r.cigar
                               if op in (0, 2, 3, 7, 8)) + 1
                   for r in mapped) - start
    else:
        start, span = 0, 0

    st = _Streams()
    cf_values = []
    mq_values = []

    # plan mate attachment: adjacent records sharing a name AND forming a
    # real primary mate pair (both FPAIRED, complementary READ1/READ2,
    # neither secondary/supplementary) — name adjacency alone would
    # attach supplementary alignments and corrupt mate fields on decode
    def _attachable(a, b):
        aux = 0x100 | 0x800   # secondary | supplementary
        if (a.flag | b.flag) & aux:
            return False
        if not ((a.flag & BAM_FPAIRED) and (b.flag & BAM_FPAIRED)):
            return False
        r1a, r2a = a.flag & 0x40, a.flag & 0x80
        r1b, r2b = b.flag & 0x40, b.flag & 0x80
        return bool((r1a and r2b) or (r2a and r1b))

    nf = {}
    i = 0
    while i < len(records):
        j = i + 1
        if (j < len(records) and records[j].name == records[i].name
                and _attachable(records[i], records[j])):
            nf[i] = j - i - 1
            i = j + 1
        else:
            i += 1

    last_pos = start
    for idx, r in enumerate(records):
        cf = CF_QUAL_STORED if r.qual and r.qual != "*" else 0
        attached = idx in nf
        second_of_pair = (idx - 1) in nf and records[idx - 1].name == r.name
        if attached:
            cf |= CF_HAS_MATE_DOWNSTREAM
        elif not second_of_pair and (r.flag & BAM_FPAIRED):
            cf |= CF_DETACHED
        cf_values.append(cf)
        st.put_itf8("BF", r.flag)
        if multiref:
            st.put_itf8("RI", r.ref_id)
        st.put_itf8("RL", len(r.seq))
        pos1 = r.pos + 1
        st.put_itf8("AP", pos1 - last_pos)
        last_pos = pos1
        st.put_itf8("RG", -1)
        st.put_stop_array("RN", r.name.encode())
        if cf & CF_DETACHED:
            # MF carries the mate's strand/unmapped state — a conformant
            # consumer derives the mate flags from MF, not from BF
            mf = ((1 if r.flag & 0x20 else 0)      # FMREVERSE
                  | (2 if r.flag & 0x8 else 0))    # FMUNMAP
            st.put_itf8("MF", mf)
            st.put_itf8("NS", r.mate_ref_id)
            st.put_itf8("NP", r.mate_pos + 1)
            st.put_itf8("TS", r.tlen)
        elif cf & CF_HAS_MATE_DOWNSTREAM:
            st.put_itf8("NF", nf[idx])
        st.put_itf8("TL", 0)
        if not (r.flag & BAM_FUNMAP):
            feats = _features(r, reference, contigs)
            st.put_itf8("FN", len(feats))
            prev = 0
            for fc, fpos, val in feats:
                st.put_byte("FC", ord(fc))
                st.put_itf8("FP", fpos - prev)
                prev = fpos
                if fc == "B":
                    st.put_byte("BA", val[0])
                    st.put_byte("QS", val[1])
                elif fc == "X":
                    st.put_byte("BS", val)
                elif fc == "I":
                    st.put_stop_array("IN", val)
                elif fc == "i":
                    st.put_byte("BA", val)
                elif fc == "D":
                    st.put_itf8("DL", val)
                elif fc == "S":
                    st.put_stop_array("SC", val)
                elif fc == "N":
                    st.put_itf8("RS", val)
                elif fc == "P":
                    st.put_itf8("PD", val)
                elif fc == "H":
                    st.put_itf8("HC", val)
            mq_values.append(r.mapq)   # mapped records only: the reader
            if cf & CF_QUAL_STORED:    # never reads MQ for unmapped ones
                st.ext[IDS["QS"]] += bytes(ord(c) - 33 for c in r.qual)
        else:
            st.ext[IDS["BA"]] += r.seq.encode()
            if cf & CF_QUAL_STORED:
                st.ext[IDS["QS"]] += bytes(ord(c) - 33 for c in r.qual)
            mq_values.append(None)

    # CF via huffman (core), MQ via beta (core)
    cf_alpha, cf_bits = _canonical_huffman(cf_values)
    cf_codes = _huffman_codes(cf_alpha, cf_bits)
    for idx, r in enumerate(records):
        code, blen = cf_codes[cf_values[idx]]
        if blen:
            st.core.write_bits(code, blen)
        if mq_values[idx] is not None:
            st.core.write_bits(mq_values[idx], 8)

    # ---- compression header
    pres = bytearray()
    entries = []
    entries.append(b"RN" + b"\x01")
    entries.append(b"AP" + b"\x01")
    entries.append(b"RR" + b"\x01")
    entries.append(b"SM" + SUB_MATRIX)
    entries.append(b"TD" + write_itf8(1) + b"\x00")
    body = write_itf8(len(entries)) + b"".join(entries)
    pres += write_itf8(len(body)) + body

    enc_map = {}
    enc_map["BF"] = _enc_external(IDS["BF"])
    enc_map["CF"] = _enc_huffman(cf_alpha, cf_bits)
    if multiref:
        enc_map["RI"] = _enc_external(IDS["RI"])
    enc_map["RL"] = _enc_external(IDS["RL"])
    enc_map["AP"] = _enc_external(IDS["AP"])
    enc_map["RG"] = _enc_external(IDS["RG"])
    enc_map["RN"] = _enc_byte_array_stop(0, IDS["RN"])
    enc_map["MF"] = _enc_external(IDS["MF"])
    enc_map["NS"] = _enc_external(IDS["NS"])
    enc_map["NP"] = _enc_external(IDS["NP"])
    enc_map["TS"] = _enc_external(IDS["TS"])
    enc_map["NF"] = _enc_external(IDS["NF"])
    enc_map["TL"] = _enc_external(IDS["TL"])
    enc_map["FN"] = _enc_external(IDS["FN"])
    enc_map["FC"] = _enc_external(IDS["FC"])
    enc_map["FP"] = _enc_external(IDS["FP"])
    enc_map["BS"] = _enc_external(IDS["BS"])
    enc_map["BA"] = _enc_external(IDS["BA"])
    enc_map["QS"] = _enc_external(IDS["QS"])
    enc_map["DL"] = _enc_external(IDS["DL"])
    enc_map["IN"] = _enc_byte_array_stop(0, IDS["IN"])
    enc_map["SC"] = _enc_byte_array_stop(0, IDS["SC"])
    enc_map["RS"] = _enc_external(IDS["RS"])
    enc_map["PD"] = _enc_external(IDS["PD"])
    enc_map["HC"] = _enc_external(IDS["HC"])
    enc_map["MQ"] = _enc_beta(0, 8)
    enc_map["BB"] = _enc_byte_array_len(_enc_external(IDS["BBl"]),
                                        _enc_external(IDS["BBv"]))
    enc_map["QQ"] = _enc_byte_array_len(_enc_external(IDS["QQl"]),
                                        _enc_external(IDS["QQv"]))
    ds = bytearray()
    body = write_itf8(len(enc_map))
    for key, (codec, params) in enc_map.items():
        body += key.encode() + write_itf8(codec) + write_itf8(len(params)) \
            + params
    ds += write_itf8(len(body)) + body

    tag_body = write_itf8(0)   # zero tag encodings
    tags = write_itf8(len(tag_body)) + tag_body

    comp_hdr = bytes(pres) + bytes(ds) + bytes(tags)
    ch_block = write_block(M_GZIP, CT_COMPRESSION_HEADER, 0, comp_hdr)

    # ---- slice
    used_ids = [cid for cid, buf in st.ext.items() if len(buf) > 0]
    embedded_id = -1
    embedded_block = b""
    if embed_reference and not multiref and mapped:
        name = contigs[slice_ref][0]
        refseq = reference[name][start - 1:start - 1 + span].encode()
        embedded_id = 999
        used_ids = used_ids + [embedded_id]
        embedded_block = write_block(method, CT_EXTERNAL, embedded_id,
                                     refseq)
    n_blocks = 1 + len(used_ids)  # core + externals

    sh = bytearray()
    sh += write_itf8(slice_ref)
    sh += write_itf8(start if not multiref else 0)
    sh += write_itf8(span if not multiref else 0)
    sh += write_itf8(len(records))
    sh += write_ltf8(counter)
    sh += write_itf8(n_blocks)
    sh += write_itf8(len(used_ids))
    for cid in used_ids:
        sh += write_itf8(cid)
    sh += write_itf8(embedded_id)
    sh += b"\x00" * 16
    sh_block = write_block(M_RAW, CT_SLICE_HEADER, 0, bytes(sh))

    core_block = write_block(M_RAW, CT_CORE, 0, st.core.finish())
    ext_blocks = b""
    for cid in used_ids:
        if cid == embedded_id:
            ext_blocks += embedded_block
            continue
        data = bytes(st.ext[cid])
        m = method
        if qual_method is not None and cid == IDS["QS"]:
            m = qual_method
        elif name_method is not None and cid == IDS["RN"]:
            m = name_method
        if len(data) <= 16:
            m = M_RAW
        ext_blocks += write_block(m, CT_EXTERNAL, cid, data)

    blocks = ch_block + sh_block + core_block + ext_blocks
    landmarks = [len(ch_block)]
    n_bases = sum(len(r.seq) for r in records)
    hdr = write_container_header(slice_ref, start if not multiref else 0,
                                 span if not multiref else 0, len(records),
                                 counter, n_bases,
                                 2 + n_blocks, landmarks, len(blocks))
    return hdr + blocks


def _features(r: BamRecord, reference, contigs) -> list:
    """BAM record -> CRAM read features (1-based read positions)."""
    name = contigs[r.ref_id][0]
    ref = reference[name]
    feats = []
    rp = 0          # read pos 0-based
    gp = r.pos      # ref pos 0-based
    for n, op in r.cigar:
        if op in (0, 7, 8):  # M/=/X
            for k in range(n):
                rb = r.seq[rp + k].upper().encode()[0]
                fb = ref[gp + k].upper().encode()[0] \
                    if gp + k < len(ref) else ord("N")
                if rb != fb:
                    code = _sub_code(fb, rb)
                    if code is not None:
                        feats.append(("X", rp + k + 1, code))
                    else:
                        q = ord(r.qual[rp + k]) - 33 if r.qual and \
                            r.qual != "*" else 30
                        feats.append(("B", rp + k + 1, (rb, q)))
            rp += n
            gp += n
        elif op == 1:   # I
            ins = r.seq[rp:rp + n].encode()
            if n == 1:
                feats.append(("i", rp + 1, ins[0]))
            else:
                feats.append(("I", rp + 1, ins))
            rp += n
        elif op == 2:   # D
            feats.append(("D", rp + 1, n))
            gp += n
        elif op == 3:   # N
            feats.append(("N", rp + 1, n))
            gp += n
        elif op == 4:   # S
            feats.append(("S", rp + 1, r.seq[rp:rp + n].encode()))
            rp += n
        elif op == 5:   # H
            feats.append(("H", rp + 1, n))
        elif op == 6:   # P
            feats.append(("P", rp + 1, n))
    return feats
