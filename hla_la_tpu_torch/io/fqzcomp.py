"""fqzcomp quality codec (CRAM 3.1 block compression method 7).

Quality strings are the bulk of a CRAM; fqzcomp (hts-specs CRAMcodecs,
"fqzcomp quality codec") models them with an adaptive range coder whose
context mixes the recent quality history, the position in the read and a
running delta (count of quality changes), per the specification's
parameter block: each parameter set carries bit allocations (qbits/qshift)
and context insert locations (qloc/ploc/dloc/sloc) plus optional
quantisation tables (qtab/ptab/dtab) and a quality symbol map (qmap).
Read lengths (and optional per-record parameter selectors, reverse flags
and duplicate flags) are coded in-stream, so a block decodes standalone.

Both encode and decode are implemented on top of the range coder and
adaptive models from io/arith.py.  Parity caveat, exactly as for
io/rans_nx16.py: no htscodecs or CRAM 3.1 sample files exist in this
environment, so the layout follows the specification text but could not
be cross-validated bit-for-bit; it is documented here and locked by
round-trip and fuzz tests (tests/test_cram31_codecs.py).

Container layout implemented here:
  byte  vers (5)
  byte  gflags      1 MULTI_PARAM | 2 HAVE_STAB | 4 DO_REV
  [byte nparam]     if MULTI_PARAM
  [byte max_sel; rle-table stab[256]]   if HAVE_STAB (selector -> param)
  per parameter set:
    uint16le context  base context value
    byte  pflags      2 DO_DEDUP | 4 DO_LEN | 8 DO_SEL | 16 HAVE_QMAP |
                      32 HAVE_PTAB | 64 HAVE_DTAB | 128 HAVE_QTAB
    byte  max_sym     number of distinct quality symbols
    byte  qbits<<4 | qshift
    byte  qloc<<4 | sloc
    byte  ploc<<4 | dloc
    [max_sym bytes qmap]         if HAVE_QMAP (code -> quality byte)
    [rle-table qtab[256]]        if HAVE_QTAB
    [rle-table ptab[1024]]       if HAVE_PTAB
    [rle-table dtab[256]]        if HAVE_DTAB
  range-coded stream; per record:
    length   4 bytes via len models (first record always; later records
             only under DO_LEN, else the first length repeats)
    selector 1 symbol via sel model if DO_SEL (selects the param set
             through stab)
    rev      1 bit via rev model if gflags DO_REV (record's qualities are
             reversed after decoding)
    dup      1 bit via dup model if DO_DEDUP; 1 = copy previous record
    per base: quality code via qual model at the rolling context
  rle-table: pairs of (uint7 value, uint7 run) until the table is full.

Context update per decoded code q (spec formula):
  qctx = ((qctx << qshift) + qtab[q]) & ((1 << qbits) - 1)
  ctx  = base + (qctx << qloc)
       + (ptab[min(pos_remaining, 1023)] << ploc)   if HAVE_PTAB
       + (dtab[min(delta, 255)] << dloc)            if HAVE_DTAB
       + (sel << sloc)                              if DO_SEL
  all taken modulo 2^16; delta increments when q differs from the
  previous code; pos_remaining counts down from the read length.
"""

from __future__ import annotations

import numpy as np

from .arith import RangeDecoder, RangeEncoder, SimpleModel
from .rans_nx16 import read_uint7, write_uint7

GF_MULTI_PARAM = 1
GF_HAVE_STAB = 2
GF_DO_REV = 4

PF_DO_DEDUP = 2
PF_DO_LEN = 4
PF_DO_SEL = 8
PF_HAVE_QMAP = 16
PF_HAVE_PTAB = 32
PF_HAVE_DTAB = 64
PF_HAVE_QTAB = 128


# ------------------------------------------------------------- rle tables
def _write_table(tab, out: bytearray) -> None:
    i = 0
    n = len(tab)
    while i < n:
        j = i
        while j < n and tab[j] == tab[i]:
            j += 1
        write_uint7(int(tab[i]), out)
        write_uint7(j - i, out)
        i = j


def _read_table(buf, pos: int, n: int) -> tuple[np.ndarray, int]:
    tab = np.zeros(n, dtype=np.int64)
    i = 0
    while i < n:
        v, pos = read_uint7(buf, pos)
        run, pos = read_uint7(buf, pos)
        if run == 0 or i + run > n:
            raise ValueError("fqzcomp: bad rle table run")
        tab[i:i + run] = v
        i += run
    return tab, pos


# ------------------------------------------------------------ parameters
class Params:
    """One fqzcomp parameter set (decoded or encoder-chosen)."""

    def __init__(self, context: int, pflags: int, max_sym: int,
                 qbits: int, qshift: int, qloc: int, sloc: int,
                 ploc: int, dloc: int, qmap: np.ndarray | None,
                 qtab: np.ndarray | None, ptab: np.ndarray | None,
                 dtab: np.ndarray | None) -> None:
        self.context = context
        self.pflags = pflags
        self.max_sym = max_sym
        self.qbits, self.qshift = qbits, qshift
        self.qloc, self.sloc, self.ploc, self.dloc = qloc, sloc, ploc, dloc
        self.qmap = qmap
        self.qtab = qtab if qtab is not None else np.arange(256,
                                                            dtype=np.int64)
        self.ptab = ptab
        self.dtab = dtab
        self.qmask = (1 << qbits) - 1

    def write(self, out: bytearray) -> None:
        out += int(self.context).to_bytes(2, "little")
        out.append(self.pflags)
        out.append(self.max_sym)
        out.append((self.qbits << 4) | self.qshift)
        out.append((self.qloc << 4) | self.sloc)
        out.append((self.ploc << 4) | self.dloc)
        if self.pflags & PF_HAVE_QMAP:
            out += bytes(int(v) for v in self.qmap)
        if self.pflags & PF_HAVE_QTAB:
            _write_table(self.qtab, out)
        if self.pflags & PF_HAVE_PTAB:
            _write_table(self.ptab, out)
        if self.pflags & PF_HAVE_DTAB:
            _write_table(self.dtab, out)

    @classmethod
    def read(cls, buf, pos: int) -> tuple["Params", int]:
        context = int.from_bytes(bytes(buf[pos:pos + 2]), "little")
        pflags = buf[pos + 2]
        max_sym = buf[pos + 3]
        if max_sym == 0:
            raise ValueError("fqzcomp: max_sym 0")
        qbits, qshift = buf[pos + 4] >> 4, buf[pos + 4] & 0xF
        qloc, sloc = buf[pos + 5] >> 4, buf[pos + 5] & 0xF
        ploc, dloc = buf[pos + 6] >> 4, buf[pos + 6] & 0xF
        pos += 7
        qmap = None
        if pflags & PF_HAVE_QMAP:
            qmap = np.frombuffer(bytes(buf[pos:pos + max_sym]),
                                 dtype=np.uint8).astype(np.int64)
            if len(qmap) != max_sym:
                raise ValueError("fqzcomp: truncated qmap")
            pos += max_sym
        qtab = ptab = dtab = None
        if pflags & PF_HAVE_QTAB:
            qtab, pos = _read_table(buf, pos, 256)
        if pflags & PF_HAVE_PTAB:
            ptab, pos = _read_table(buf, pos, 1024)
        if pflags & PF_HAVE_DTAB:
            dtab, pos = _read_table(buf, pos, 256)
        return cls(context, pflags, max_sym, qbits, qshift, qloc, sloc,
                   ploc, dloc, qmap, qtab, ptab, dtab), pos


class _State:
    __slots__ = ("qctx", "p", "delta", "prevq")

    def __init__(self, rec_len: int) -> None:
        self.qctx = 0
        self.p = rec_len
        self.delta = 0
        self.prevq = 0


def _update_ctx(pm: Params, st: _State, q: int, sel: int) -> int:
    st.qctx = ((st.qctx << pm.qshift) + int(pm.qtab[q])) & pm.qmask
    ctx = pm.context + (st.qctx << pm.qloc)
    if pm.ptab is not None:
        ctx += int(pm.ptab[min(st.p, 1023)]) << pm.ploc
    if pm.dtab is not None:
        ctx += int(pm.dtab[min(st.delta, 255)]) << pm.dloc
        st.delta += int(st.prevq != q)
        st.prevq = q
    if pm.pflags & PF_DO_SEL:
        ctx += sel << pm.sloc
    st.p -= 1
    return ctx & 0xFFFF


class _Models:
    """Lazily-allocated per-context quality models + record-level models."""

    def __init__(self, params: list[Params], do_rev: bool) -> None:
        self.qual: list[dict[int, SimpleModel]] = [{} for _ in params]
        self.nsym = [pm.max_sym for pm in params]
        self.len = [SimpleModel(256) for _ in range(4)]
        self.sel = SimpleModel(256)
        self.rev = SimpleModel(2) if do_rev else None
        self.dup = SimpleModel(2)

    def qmodel(self, pset: int, ctx: int) -> SimpleModel:
        m = self.qual[pset].get(ctx)
        if m is None:
            m = self.qual[pset][ctx] = SimpleModel(self.nsym[pset])
        return m


# ----------------------------------------------------------------- encode
def _default_params(data: bytes, lens: list[int]) -> Params:
    arr = np.frombuffer(data, dtype=np.uint8)
    syms = np.unique(arr) if len(arr) else np.array([0], dtype=np.uint8)
    max_sym = len(syms)
    qmap = syms.astype(np.int64)
    pflags = PF_HAVE_QMAP | PF_HAVE_PTAB | PF_HAVE_DTAB
    if len(lens) > 1 and len(set(lens)) > 1:
        pflags |= PF_DO_LEN
    # two previous quality codes in the low bits, coarse position at bit
    # qbits, coarse delta above that
    qshift = max(1, int(np.ceil(np.log2(max_sym))) if max_sym > 1 else 1)
    qbits = min(2 * qshift, 12)
    ploc = qbits
    ptab = np.minimum(np.arange(1024) >> 6, 7).astype(np.int64)
    dloc = min(ploc + 3, 15)
    dtab = np.minimum(np.arange(256) >> 5, 3).astype(np.int64)
    return Params(0, pflags, max_sym, qbits, qshift, qloc=0, sloc=15,
                  ploc=ploc, dloc=dloc, qmap=qmap, qtab=None, ptab=ptab,
                  dtab=dtab)


def compress(data: bytes, lens: list[int] | None = None,
             params: list[Params] | None = None,
             sels: list[int] | None = None, stab: np.ndarray | None = None,
             revs: list[bool] | None = None) -> bytes:
    """Encode concatenated quality strings.  `lens` gives the record
    boundaries (one record covering everything when omitted); the other
    arguments exercise the multi-parameter / selector / reverse layers and
    default to the single-parameter form the CRAM writer emits."""
    if lens is None:
        lens = [len(data)] if data else []
    if sum(lens) != len(data):
        raise ValueError("fqzcomp: record lengths do not sum to data size")
    if any(ln <= 0 for ln in lens):
        # the stream cannot represent empty records (decode treats
        # rec_len <= 0 as corruption); callers must drop '*'-quality reads
        raise ValueError("fqzcomp: zero-length record")
    if params is None:
        params = [_default_params(data, lens)]
    gflags = 0
    if len(params) > 1:
        gflags |= GF_MULTI_PARAM
    if stab is not None:
        gflags |= GF_HAVE_STAB
    if revs is not None:
        gflags |= GF_DO_REV
    out = bytearray()
    out.append(5)                       # vers
    out.append(gflags)
    if gflags & GF_MULTI_PARAM:
        out.append(len(params))
    if gflags & GF_HAVE_STAB:
        out.append(int(stab.max()))
        _write_table(stab, out)
    for pm in params:
        pm.write(out)
    stab_arr = stab if stab is not None else np.zeros(256, dtype=np.int64)
    # code lookup per param set: quality byte -> model symbol; bytes the
    # model cannot represent map to -1 (with no qmap, codes ARE the bytes,
    # so anything >= max_sym is unencodable and must be rejected here —
    # the native encoder would otherwise index past the model row)
    inv = []
    for pm in params:
        if pm.qmap is not None:
            m = np.full(256, -1, dtype=np.int64)
            m[pm.qmap] = np.arange(pm.max_sym)
            inv.append(m)
        else:
            a = np.arange(256, dtype=np.int64)
            inv.append(np.where(a < pm.max_sym, a, -1))
    # precompute the per-record dup flags, param-set choices and the
    # qmap-inverted model symbols — shared by the native and Python paths.
    # The default write path (single param set, no reverse/dedup) needs no
    # per-record loop: one vectorised qmap inversion covers everything
    if (sels is None and revs is None and len(params) == 1
            and not (params[0].pflags & PF_DO_DEDUP)):
        codes_cat = inv[0][np.frombuffer(data, dtype=np.uint8)]
        if np.any(codes_cat < 0):
            raise ValueError("fqzcomp: quality byte outside qmap")
        codes_cat = codes_cat.astype(np.uint8)
        dups = [0] * len(lens)
        psets = [0] * len(lens)
    else:
        dups, psets = [], []
        codes_parts: list[np.ndarray] = []
        off = 0
        prev_rec: bytes | None = None
        for ri, rec_len in enumerate(lens):
            rec = data[off:off + rec_len]
            off += rec_len
            sel = sels[ri] if sels is not None else 0
            pset = int(stab_arr[sel]) if gflags & GF_HAVE_STAB else 0
            if (gflags & GF_DO_REV) and revs is not None and revs[ri]:
                rec = rec[::-1]
            dup = 0
            if params[pset].pflags & PF_DO_DEDUP:
                dup = int(prev_rec is not None and rec == prev_rec)
            dups.append(dup)
            psets.append(pset)
            c = inv[pset][np.frombuffer(rec, dtype=np.uint8)]
            if np.any(c < 0):
                raise ValueError("fqzcomp: quality byte outside qmap")
            codes_parts.append(c.astype(np.uint8))
            prev_rec = rec
        codes_cat = (np.concatenate(codes_parts) if codes_parts
                     else np.zeros(0, dtype=np.uint8))
    payload = _native_encode(codes_cat, lens, sels, revs, dups, gflags,
                             params, stab_arr)
    if payload is not None:
        return bytes(out) + payload
    enc = RangeEncoder()
    models = _Models(params, bool(gflags & GF_DO_REV))
    off = 0
    first = True
    for ri, rec_len in enumerate(lens):
        pm0 = params[0]
        if first or (pm0.pflags & PF_DO_LEN):
            for b in range(4):
                models.len[b].encode(enc, (rec_len >> (8 * b)) & 0xFF)
        elif rec_len != lens[0]:
            raise ValueError("fqzcomp: varying lengths need DO_LEN")
        first = False
        sel = sels[ri] if sels is not None else 0
        if pm0.pflags & PF_DO_SEL:
            models.sel.encode(enc, sel)
        pset = psets[ri]
        pm = params[pset]
        if gflags & GF_DO_REV:
            models.rev.encode(enc, int(bool(revs[ri]))
                              if revs is not None else 0)
        if pm.pflags & PF_DO_DEDUP:
            models.dup.encode(enc, dups[ri])
            if dups[ri]:
                off += rec_len
                continue
        st = _State(rec_len)
        ctx = pm.context & 0xFFFF
        for q in codes_cat[off:off + rec_len]:
            q = int(q)
            models.qmodel(pset, ctx).encode(enc, q)
            ctx = _update_ctx(pm, st, q, sel)
        off += rec_len
    return bytes(out) + enc.finish()


def _flatten_tables(params: list[Params]):
    """(pm, qmap, qtab, ptab, dtab) int32 arrays for the native codecs."""
    nparam = len(params)
    pm = np.zeros((nparam, 9), dtype=np.int32)
    qmap = np.tile(np.arange(256, dtype=np.int32), (nparam, 1))
    qtab = np.zeros((nparam, 256), dtype=np.int32)
    ptab = np.zeros((nparam, 1024), dtype=np.int32)
    dtab = np.zeros((nparam, 256), dtype=np.int32)
    for i, p in enumerate(params):
        pm[i] = (p.context, p.pflags, p.max_sym, p.qbits, p.qshift,
                 p.qloc, p.sloc, p.ploc, p.dloc)
        if p.qmap is not None:
            qmap[i, :p.max_sym] = p.qmap
        qtab[i] = p.qtab
        if p.ptab is not None:
            ptab[i] = p.ptab
        if p.dtab is not None:
            dtab[i] = p.dtab
    return pm, qmap, qtab, ptab, dtab


def _native_encode(codes_cat, lens, sels, revs, dups, gflags, params,
                   stab_arr) -> bytes | None:
    from .. import native
    enc = getattr(native, "fqz_encode", None)
    if enc is None or not native.available():
        return None
    pm, _, qtab, ptab, dtab = _flatten_tables(params)
    return enc(codes_cat, lens, sels, revs, dups, len(params), gflags,
               pm, qtab, ptab, dtab, stab_arr)


# ----------------------------------------------------------------- decode
def _native_decode(blob, pos: int, n_out: int, gflags: int,
                   params: list[Params],
                   stab: np.ndarray) -> bytes | None:
    from .. import native
    dec = getattr(native, "fqz_decode", None)
    if dec is None or not native.available():
        return None
    pm, qmap, qtab, ptab, dtab = _flatten_tables(params)
    return dec(bytes(blob), pos, n_out, len(params), gflags, pm, qmap,
               qtab, ptab, dtab, stab)


def uncompress(blob: bytes, n_out: int) -> bytes:
    """Decode one fqzcomp block to the concatenated quality bytes."""
    if n_out > (1 << 31):
        raise ValueError(f"fqzcomp: implausible raw size {n_out}")
    pos = 0
    vers = blob[pos]
    if vers != 5:
        raise ValueError(f"fqzcomp: unsupported version {vers}")
    gflags = blob[pos + 1]
    pos += 2
    nparam = 1
    if gflags & GF_MULTI_PARAM:
        nparam = blob[pos]
        pos += 1
        if nparam == 0:
            raise ValueError("fqzcomp: zero parameter sets")
    stab = np.zeros(256, dtype=np.int64)
    if gflags & GF_HAVE_STAB:
        pos += 1                         # max_sel (informational)
        stab, pos = _read_table(blob, pos, 256)
    if np.any(stab >= nparam):
        raise ValueError("fqzcomp: selector table exceeds parameter sets")
    params = []
    for _ in range(nparam):
        pm, pos = Params.read(blob, pos)
        params.append(pm)
    res = _native_decode(blob, pos, n_out, gflags, params, stab)
    if res is not None:
        return res
    dec = RangeDecoder(blob, pos)
    models = _Models(params, bool(gflags & GF_DO_REV))
    out = bytearray(n_out)
    rev_spans: list[tuple[int, int]] = []
    off = 0
    first = True
    rec_len = 0
    prev_span: tuple[int, int] | None = None
    pm0 = params[0]
    while off < n_out:
        if first or (pm0.pflags & PF_DO_LEN):
            rl = 0
            for b in range(4):
                rl |= models.len[b].decode(dec) << (8 * b)
            rec_len = rl
        first = False
        if rec_len <= 0 or off + rec_len > n_out:
            raise ValueError(f"fqzcomp: record length {rec_len} overflows "
                             f"block ({off}/{n_out})")
        sel = models.sel.decode(dec) if pm0.pflags & PF_DO_SEL else 0
        pset = int(stab[sel]) if gflags & GF_HAVE_STAB else 0
        pm = params[pset]
        rv = models.rev.decode(dec) if gflags & GF_DO_REV else 0
        if pm.pflags & PF_DO_DEDUP:
            if models.dup.decode(dec):
                if prev_span is None or prev_span[1] - prev_span[0] \
                        != rec_len:
                    raise ValueError("fqzcomp: bad duplicate record")
                out[off:off + rec_len] = out[prev_span[0]:prev_span[1]]
                if rv:
                    rev_spans.append((off, off + rec_len))
                prev_span = (off, off + rec_len)
                off += rec_len
                continue
        st = _State(rec_len)
        ctx = pm.context & 0xFFFF
        qmap = pm.qmap
        for i in range(rec_len):
            q = models.qmodel(pset, ctx).decode(dec)
            out[off + i] = int(qmap[q]) if qmap is not None else q
            ctx = _update_ctx(pm, st, q, sel)
        if rv:
            rev_spans.append((off, off + rec_len))
        prev_span = (off, off + rec_len)
        off += rec_len
    for lo, hi in rev_spans:
        out[lo:hi] = out[lo:hi][::-1]
    return bytes(out)
