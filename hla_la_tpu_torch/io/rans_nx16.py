"""rANS Nx16 codec (CRAM 3.1 block compression method 5).

The interleaved N-state (N = 4 or 32) range-ANS coder with 16-bit
renormalisation from the CRAM 3.1 codecs specification (hts-specs
CRAMcodecs, "rANS Nx16"), including the bit-stream transforms that the
format byte can enable: PACK (bit packing of <=16 distinct symbols), RLE
(run-length encoding of selected symbols), STRIPE (N interleaved
substreams), CAT (stored uncompressed) and NOSZ (no embedded size).

Both encode and decode are implemented, pure Python/numpy.  Parity caveat:
this environment has no htslib/htscodecs and no CRAM 3.1 sample files, so
the layout below follows the specification as faithfully as possible but
could not be cross-validated against the reference codec; every section is
therefore documented inline and locked by round-trip tests
(tests/test_cram.py).  The remaining CRAM 3.1 codecs (adaptive arithmetic,
fqzcomp, name tokeniser) stay rejected with a clear error in io/cram.py.

Stream layout implemented here:
  format byte: 0x01 ORDER1 | 0x04 N32 | 0x08 STRIPE | 0x10 NOSZ |
               0x20 CAT | 0x40 RLE | 0x80 PACK
  [uint7 ulen]                       unless NOSZ
  STRIPE: byte N; uint7 clen[0..N);  N nested blocks (encoded with NOSZ),
          substream j holds bytes i with i % N == j
  PACK meta: byte nsym; nsym map bytes; uint7 plen (packed byte count)
  RLE meta:  uint7 m (m>>1 = metadata byte length, m&1 = stored raw;
             otherwise uint7 clen + order-0 block of the metadata);
             metadata = byte n (0 means 256); n run symbols; then one uint7
             run length per literal occurrence of a run symbol;
             then uint7 litlen (length of the literal stream)
  order-0 freq table: alphabet (ascending symbols, consecutive-run coded,
             0 terminated) then one uint7 per symbol, summing to 4096
  order-1 freq table: byte (shift<<4 | compressed_flag); if compressed:
             uint7 clen + uint7 rawlen + order-0 block of the table; table =
             alphabet, then per context symbol a uint7 frequency per
             alphabet symbol (row sums normalised to 1<<shift; all-zero
             rows for absent contexts)
  rANS payload: N uint32le initial states then 16-bit little-endian
             renormalisation words; state j decodes positions i with
             i % N == j (order 0) or fragment j of N equal splits
             (order 1, remainder on the last fragment).
"""

from __future__ import annotations

import numpy as np

L_BOUND = 1 << 15
TF_SHIFT_O0 = 12
TOT_O0 = 1 << TF_SHIFT_O0

F_ORDER1 = 0x01
F_N32 = 0x04
F_STRIPE = 0x08
F_NOSZ = 0x10
F_CAT = 0x20
F_RLE = 0x40
F_PACK = 0x80


# ------------------------------------------------------------------ uint7
def write_uint7(v: int, out: bytearray) -> None:
    """Variable-size unsigned int, 7 bits per byte, most-significant first,
    top bit set on continuation bytes (the spec's uint7)."""
    assert v >= 0
    chunks = [v & 0x7F]
    v >>= 7
    while v:
        chunks.append(0x80 | (v & 0x7F))
        v >>= 7
    out.extend(reversed(chunks))


def read_uint7(buf, pos: int) -> tuple[int, int]:
    v = 0
    while True:
        b = buf[pos]
        pos += 1
        v = (v << 7) | (b & 0x7F)
        if not (b & 0x80):
            return v, pos


# ------------------------------------------------------------- alphabet
def _write_alphabet(present: np.ndarray, out: bytearray) -> None:
    """Ascending symbol list; after two consecutive symbols a run byte
    counts how many further consecutive ones follow; terminated by 0."""
    syms = np.flatnonzero(present)
    i = 0
    last = -2
    while i < len(syms):
        s = int(syms[i])
        out.append(s)
        if s == last + 1:
            run = 0
            while i + run + 1 < len(syms) and int(syms[i + run + 1]) == s + run + 1:
                run += 1
            out.append(run)
            i += run
            last = s + run
        else:
            last = s
        i += 1
    out.append(0)


def _read_alphabet(buf, pos: int) -> tuple[list[int], int]:
    syms: list[int] = []
    last = -2
    while True:
        s = buf[pos]
        pos += 1
        if s == 0 and last >= 0:
            break
        syms.append(s)
        if s == last + 1:
            run = buf[pos]
            pos += 1
            for r in range(run):
                syms.append(s + 1 + r)
            last = s + run
        else:
            last = s
    return syms, pos


def _normalize(counts: np.ndarray, total: int) -> np.ndarray:
    """Scale counts to sum exactly `total`, nonzero counts stay >= 1."""
    n = counts.sum()
    out = np.zeros_like(counts)
    nz = counts > 0
    if n == 0:
        return out
    f = np.maximum(1, (counts[nz] * (total / n)).astype(np.int64))
    diff = total - f.sum()
    order = np.argsort(-counts[nz])
    i = 0
    while diff != 0:
        j = order[i % len(order)]
        if f[j] + diff >= 1:
            f[j] += diff
            diff = 0
        else:
            diff += f[j] - 1
            f[j] = 1
            i += 1
    out[nz] = f
    return out


# ------------------------------------------------------------ rANS core
def _encode_payload(arr: np.ndarray, freqs: np.ndarray, cums: np.ndarray,
                    n_states: int, ctx: np.ndarray | None,
                    shift: int) -> bytes:
    """Encode symbols with N interleaved 16-bit-renorm states.  ctx is the
    per-position context row (order-1) or None (order-0; row 0 used).
    Order 0 interleaves round-robin; order 1 splits into N fragments
    (state j owns fragment j, remainder on the last)."""
    from .. import native
    enc = getattr(native, "ransnx16_encode", None)
    if enc is not None and native.available():
        res = enc(arr, freqs, cums, n_states, ctx, shift)
        if res is not None:
            return res
    n = len(arr)
    states = [L_BOUND] * n_states
    out_rev = bytearray()
    if ctx is None:
        owner = [(i, i & (n_states - 1)) for i in range(n)] \
            if (n_states & (n_states - 1)) == 0 else \
            [(i, i % n_states) for i in range(n)]
        seq = [(i, j, 0) for i, j in owner]
    else:
        # order-1 decode pulls states interleaved t-major (position t of
        # every fragment, then t+1, ...); the renorm byte stream must be
        # emitted in exactly the reverse of that order
        q = n // n_states
        bounds = [(j * q, (j + 1) * q if j < n_states - 1 else n)
                  for j in range(n_states)]
        max_len = max((hi - lo for lo, hi in bounds), default=0)
        seq = []
        for t in range(max_len):
            for j in range(n_states):
                lo, hi = bounds[j]
                if t < hi - lo:
                    seq.append((lo + t, j, int(ctx[lo + t])))
    # encode in reverse order of decode: decoder pulls states in position
    # order, so push symbols backwards
    for i, j, cx in reversed(seq):
        s = int(arr[i])
        f = int(freqs[cx, s])
        c = int(cums[cx, s])
        x = states[j]
        x_max = ((L_BOUND >> shift) << 16) * f
        while x >= x_max:
            out_rev.append(x & 0xFF)
            out_rev.append((x >> 8) & 0xFF)
            x >>= 16
        states[j] = ((x // f) << shift) + (x % f) + c
    body = bytearray()
    for j in range(n_states):
        body += int(states[j]).to_bytes(4, "little")
    # out_rev holds 16-bit words least-significant-byte first, reversed
    # wordwise at decode; reverse pairs
    words = bytes(out_rev)
    rev = bytearray()
    for k in range(len(words) - 2, -2, -2):
        rev.append(words[k])
        rev.append(words[k + 1])
    return bytes(body) + bytes(rev)


def _decode_payload(comp, pos: int, n_out: int, freqs: np.ndarray,
                    cums: np.ndarray, sym_of: np.ndarray, n_states: int,
                    order1: bool, shift: int) -> bytes:
    states = []
    for j in range(n_states):
        states.append(int.from_bytes(bytes(comp[pos:pos + 4]), "little"))
        pos += 4
    out = bytearray(n_out)
    mask = (1 << shift) - 1
    ln = len(comp)
    if not order1:
        for i in range(n_out):
            j = i % n_states
            x = states[j]
            slot = x & mask
            s = int(sym_of[0, slot])
            out[i] = s
            x = int(freqs[0, s]) * (x >> shift) + slot - int(cums[0, s])
            while x < L_BOUND and pos + 1 < ln:
                x = (x << 16) | comp[pos] | (comp[pos + 1] << 8)
                pos += 2
            states[j] = x
    else:
        q = n_out // n_states
        bounds = [(j * q, (j + 1) * q if j < n_states - 1 else n_out)
                  for j in range(n_states)]
        last = [0] * n_states
        max_len = max(hi - lo for lo, hi in bounds) if n_out else 0
        for t in range(max_len):
            for j in range(n_states):
                lo, hi = bounds[j]
                if t >= hi - lo:
                    continue
                x = states[j]
                cx = last[j]
                slot = x & mask
                s = int(sym_of[cx, slot])
                out[lo + t] = s
                x = int(freqs[cx, s]) * (x >> shift) + slot \
                    - int(cums[cx, s])
                while x < L_BOUND and pos + 1 < ln:
                    x = (x << 16) | comp[pos] | (comp[pos + 1] << 8)
                    pos += 2
                states[j] = x
                last[j] = s
    return bytes(out)


# ----------------------------------------------------------- order 0 / 1
def _encode_o0(data: bytes, n_states: int) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    counts = np.bincount(arr, minlength=256).astype(np.int64)
    freqs = _normalize(counts, TOT_O0)[None, :]
    cums = np.zeros((1, 257), dtype=np.int64)
    cums[0, 1:] = np.cumsum(freqs[0])
    out = bytearray()
    _write_alphabet(freqs[0] > 0, out)
    for s in np.flatnonzero(freqs[0] > 0):
        write_uint7(int(freqs[0, s]), out)
    out += _encode_payload(arr, freqs, cums, n_states, None, TF_SHIFT_O0)
    return bytes(out)


def _native_decode(comp, pos, n_out, n_states, order1, shift, freqs):
    from .. import native
    dec = getattr(native, "ransnx16_decode", None)
    if dec is None or not native.available():
        return None
    return dec(bytes(comp), pos, n_out, n_states, 1 if order1 else 0,
               shift, freqs)


def _decode_o0(comp, pos: int, n_out: int, n_states: int) -> bytes:
    syms, pos = _read_alphabet(comp, pos)
    freqs = np.zeros((1, 256), dtype=np.int64)
    for s in syms:
        f, pos = read_uint7(comp, pos)
        freqs[0, s] = f
    if freqs.sum() != TOT_O0:
        raise ValueError("rANSNx16: order-0 frequencies do not sum to "
                         f"{TOT_O0}")
    res = _native_decode(comp, pos, n_out, n_states, False, TF_SHIFT_O0,
                         freqs)
    if res is not None:
        return res
    sym_of = np.zeros((1, TOT_O0), dtype=np.uint8)
    sym_of[0] = np.repeat(np.arange(256, dtype=np.uint8), freqs[0])
    cums = np.zeros((1, 257), dtype=np.int64)
    cums[0, 1:] = np.cumsum(freqs[0])
    return _decode_payload(comp, pos, n_out, freqs, cums, sym_of,
                           n_states, False, TF_SHIFT_O0)


def _encode_o1(data: bytes, n_states: int) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    q = n // n_states
    ctx = np.zeros(n, dtype=np.uint8)
    for j in range(n_states):
        lo = j * q
        hi = (j + 1) * q if j < n_states - 1 else n
        if hi > lo:
            ctx[lo + 1:hi] = arr[lo:hi - 1]
    counts = np.zeros((256, 256), dtype=np.int64)
    np.add.at(counts, (ctx.astype(np.int64), arr.astype(np.int64)), 1)
    present = (counts.sum(axis=1) > 0) | (counts.sum(axis=0) > 0)
    shift = TF_SHIFT_O0
    freqs = np.zeros((256, 256), dtype=np.int64)
    for cx in range(256):
        if counts[cx].sum() > 0:
            freqs[cx] = _normalize(counts[cx], 1 << shift)
    # raw table: alphabet then per present context a uint7 frequency per
    # alphabet symbol (zero for absent transitions)
    table = bytearray()
    _write_alphabet(present, table)
    syms = np.flatnonzero(present)
    for cx in syms:
        for s in syms:
            write_uint7(int(freqs[cx, s]), table)
    out = bytearray()
    # compress the table itself with order-0 when that helps
    comp_table = _encode_o0(bytes(table), 4) if len(table) > 64 else None
    if comp_table is not None and len(comp_table) < len(table):
        out.append((shift << 4) | 1)
        write_uint7(len(comp_table), out)
        write_uint7(len(table), out)
        out += comp_table
    else:
        out.append(shift << 4)
        out += table
    cums = np.zeros((256, 257), dtype=np.int64)
    cums[:, 1:] = np.cumsum(freqs, axis=1)
    out += _encode_payload(arr, freqs, cums, n_states, ctx, shift)
    return bytes(out)


def _decode_o1(comp, pos: int, n_out: int, n_states: int) -> bytes:
    flag = comp[pos]
    pos += 1
    shift = flag >> 4
    if flag & 1:
        clen, pos = read_uint7(comp, pos)
        rawlen, pos = read_uint7(comp, pos)
        if rawlen > (1 << 24):   # a full 256x256 uint7 table is ~128KB
            raise ValueError(
                f"rANSNx16 order-1: implausible table size {rawlen}")
        table = _decode_o0(comp[pos:pos + clen], 0, rawlen, 4)
        pos += clen
    else:
        table = comp[pos:]
        # consumed length accounted below via tpos bookkeeping
    syms, tpos = _read_alphabet(table, 0)
    freqs = np.zeros((256, 256), dtype=np.int64)
    for cx in syms:
        for s in syms:
            f, tpos = read_uint7(table, tpos)
            freqs[cx, s] = f
    if not (flag & 1):
        pos += tpos
    row_sums = freqs.sum(axis=1)
    if not np.all((row_sums == 0) | (row_sums == (1 << shift))):
        raise ValueError("rANSNx16: order-1 context frequencies do not "
                         f"sum to {1 << shift}")
    res = _native_decode(comp, pos, n_out, n_states, True, shift, freqs)
    if res is not None:
        return res
    sym_of = np.zeros((256, 1 << shift), dtype=np.uint8)
    for cx in syms:
        if freqs[cx].sum() > 0:
            sym_of[cx] = np.repeat(np.arange(256, dtype=np.uint8),
                                   freqs[cx])
    cums = np.zeros((256, 257), dtype=np.int64)
    cums[:, 1:] = np.cumsum(freqs, axis=1)
    return _decode_payload(comp, pos, n_out, freqs, cums, sym_of,
                           n_states, True, shift)


# ------------------------------------------------------------ transforms
def pack_bits(vals: np.ndarray, nsym: int) -> bytes:
    """Bit-pack symbol indices (0..nsym-1, nsym <= 16) at 1/2/4 bits per
    value (0 bits when nsym <= 1).  Shared by the rANSNx16 and arith PACK
    transforms, which differ only in their metadata framing."""
    if nsym <= 1:
        return b""
    if nsym <= 2:
        pad = (-len(vals)) % 8
        v = np.concatenate([vals, np.zeros(pad, np.uint8)]).reshape(-1, 8)
        return (v << np.arange(8, dtype=np.uint8)).sum(
            axis=1).astype(np.uint8).tobytes()
    if nsym <= 4:
        pad = (-len(vals)) % 4
        v = np.concatenate([vals, np.zeros(pad, np.uint8)]).reshape(-1, 4)
        return (v << (2 * np.arange(4, dtype=np.uint8))).sum(
            axis=1).astype(np.uint8).tobytes()
    pad = (-len(vals)) % 2
    v = np.concatenate([vals, np.zeros(pad, np.uint8)]).reshape(-1, 2)
    return (v[:, 0] | (v[:, 1] << 4)).astype(np.uint8).tobytes()


def unpack_bits(mp: np.ndarray, packed: bytes, n_out: int,
                label: str = "rANSNx16") -> bytes:
    """Inverse of pack_bits + symbol-map application."""
    nsym = len(mp)
    arr = np.frombuffer(packed, dtype=np.uint8)
    if nsym <= 1:
        vals = np.zeros(n_out, dtype=np.uint8)
    elif nsym <= 2:
        bits = (arr[:, None] >> np.arange(8, dtype=np.uint8)) & 1
        vals = bits.reshape(-1)[:n_out]
    elif nsym <= 4:
        bits = (arr[:, None] >> (2 * np.arange(4, dtype=np.uint8))) & 3
        vals = bits.reshape(-1)[:n_out]
    else:
        bits = np.stack([arr & 0xF, arr >> 4], axis=1)
        vals = bits.reshape(-1)[:n_out]
    if len(vals) < n_out:
        raise ValueError(f"{label} PACK: truncated packed stream")
    return mp[vals].tobytes()


def _pack(data: bytes) -> tuple[bytes, bytes] | None:
    """Bit-pack when <=16 distinct symbols.  Returns (meta, packed)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    syms = np.unique(arr)
    if len(syms) > 16:
        return None
    meta = bytearray([len(syms)])
    meta += bytes(int(s) for s in syms)
    inv = np.zeros(256, dtype=np.uint8)
    inv[syms] = np.arange(len(syms), dtype=np.uint8)
    packed = pack_bits(inv[arr], len(syms))
    write_uint7(len(packed), meta)
    return bytes(meta), packed


def _unpack(meta, pos: int, packed: bytes, n_out: int) -> tuple[bytes, int]:
    nsym = meta[pos]
    pos += 1
    mp = np.frombuffer(bytes(meta[pos:pos + nsym]), dtype=np.uint8)
    pos += nsym
    plen, pos = read_uint7(meta, pos)
    return unpack_bits(mp, packed, n_out), pos


def _rle_encode(data: bytes) -> tuple[bytes, bytes] | None:
    """Run-length: pick symbols whose runs save space; literals keep one
    copy of each run, lengths (run-1) go to the metadata as uint7."""
    arr = np.frombuffer(data, dtype=np.uint8)
    if len(arr) < 4:
        return None
    change = np.concatenate([[True], arr[1:] != arr[:-1]])
    starts = np.flatnonzero(change)
    run_lens = np.diff(np.concatenate([starts, [len(arr)]]))
    run_syms = arr[starts]
    # per-symbol saving: (run_len - 1) bytes saved minus ~1 meta byte/run
    save = np.zeros(256, dtype=np.int64)
    np.add.at(save, run_syms.astype(np.int64), run_lens - 2)
    chosen = np.flatnonzero(save > 8)
    if len(chosen) == 0:
        return None
    is_chosen = np.zeros(256, dtype=bool)
    is_chosen[chosen] = True
    meta = bytearray([len(chosen) & 0xFF])   # 0 encodes 256
    meta += bytes(int(s) for s in chosen)
    lits = bytearray()
    for s, ln in zip(run_syms, run_lens):
        if is_chosen[s]:
            lits.append(int(s))
            write_uint7(int(ln) - 1, meta)
        else:
            lits += bytes([int(s)]) * int(ln)
    return bytes(meta), bytes(lits)


def _rle_decode(meta, litstream: bytes, n_out: int) -> bytes:
    pos = 0
    n = meta[pos]
    pos += 1
    if n == 0:
        n = 256
    is_run = np.zeros(256, dtype=bool)
    for _ in range(n):
        is_run[meta[pos]] = True
        pos += 1
    out = bytearray()
    for b in litstream:
        if is_run[b]:
            run, pos = read_uint7(meta, pos)
            if run + 1 > n_out - len(out):
                raise ValueError("rANSNx16 RLE: run overflows output")
            out += bytes([b]) * (run + 1)
        else:
            out.append(b)
    if len(out) != n_out:
        raise ValueError(
            f"rANSNx16 RLE: expanded to {len(out)}, expected {n_out}")
    return bytes(out)


# --------------------------------------------------------------- public
def compress(data: bytes, order: int = 0, n32: bool = False,
             use_pack: bool = True, use_rle: bool = False,
             stripe: int = 0, cat: bool = False,
             nosz: bool = False) -> bytes:
    """Encode one rANSNx16 block.  `stripe` > 0 splits into that many
    interleaved substreams first (each recursively encoded)."""
    out = bytearray()
    fmt = 0
    n = len(data)
    if stripe and n >= stripe:
        fmt = F_STRIPE | (F_NOSZ if nosz else 0)
        out.append(fmt)
        if not nosz:
            write_uint7(n, out)
        out.append(stripe)
        arr = np.frombuffer(data, dtype=np.uint8)
        subs = [compress(arr[j::stripe].tobytes(), order=order, n32=n32,
                         use_pack=use_pack, use_rle=use_rle, nosz=True)
                for j in range(stripe)]
        for s in subs:
            write_uint7(len(s), out)
        for s in subs:
            out += s
        return bytes(out)
    if cat or n < 8:
        fmt = F_CAT | (F_NOSZ if nosz else 0)
        out.append(fmt)
        if not nosz:
            write_uint7(n, out)
        out += data
        return bytes(out)
    fmt |= F_ORDER1 if order == 1 else 0
    fmt |= F_N32 if n32 else 0
    fmt |= F_NOSZ if nosz else 0
    payload = data
    rle_meta = pack_meta = None
    lit_len = None
    if use_rle:
        r = _rle_encode(payload)
        if r is not None:
            fmt |= F_RLE
            rle_meta, payload = r
            lit_len = len(payload)   # literal-stream length, pre-PACK
    if use_pack:
        p = _pack(payload)
        if p is not None:
            fmt |= F_PACK
            pack_meta, payload = p
    out.append(fmt)
    if not nosz:
        write_uint7(n, out)
    if fmt & F_RLE:
        # metadata raw (bit0 of the uint7'd length set) — compressing the
        # metadata with a nested order-0 block is a decode-side option we
        # accept but do not emit
        write_uint7((len(rle_meta) << 1) | 1, out)
        out += rle_meta
        write_uint7(lit_len, out)
    if fmt & F_PACK:
        out += pack_meta
    n_states = 32 if n32 else 4
    if len(payload) < n_states * 2 or len(payload) < 8:
        # tiny payload after transforms: store it raw inside the block
        fmt |= F_CAT
        out[0] = fmt
        out += payload
        return bytes(out)
    if order == 1 and len(payload) >= n_states:
        out += _encode_o1(payload, n_states)
    else:
        fmt &= ~F_ORDER1
        out[0] = fmt
        out += _encode_o0(payload, n_states)
    return bytes(out)


def uncompress(blob: bytes, n_out: int | None = None) -> bytes:
    """Decode one rANSNx16 block (n_out required when NOSZ is set)."""
    pos = 0
    fmt = blob[pos]
    pos += 1
    if fmt & F_NOSZ:
        if n_out is None:
            raise ValueError("rANSNx16: NOSZ block needs external size")
        ulen = n_out
    else:
        ulen, pos = read_uint7(blob, pos)
    if ulen > (1 << 28):
        # CRAM blocks are ~MBs; a single corrupt uint7 length byte must
        # not drive a multi-GB allocation + garbage decode
        raise ValueError(f"rANSNx16 block: implausible raw size {ulen}")
    if fmt & F_STRIPE:
        n = blob[pos]
        pos += 1
        if n == 0:
            raise ValueError("rANSNx16 STRIPE: zero substreams")
        clens = []
        for _ in range(n):
            c, pos = read_uint7(blob, pos)
            clens.append(c)
        out = np.zeros(ulen, dtype=np.uint8)
        for j in range(n):
            sub_len = (ulen - j + n - 1) // n
            sub = uncompress(blob[pos:pos + clens[j]], sub_len)
            out[j::n] = np.frombuffer(sub, dtype=np.uint8)
            pos += clens[j]
        return out.tobytes()
    rle_meta = None
    lit_len = ulen
    if fmt & F_RLE:
        m, pos = read_uint7(blob, pos)
        mlen = m >> 1
        if m & 1:
            rle_meta = blob[pos:pos + mlen]
            pos += mlen
        else:
            clen, pos = read_uint7(blob, pos)
            rle_meta = uncompress(blob[pos:pos + clen], mlen)
            pos += clen
        lit_len, pos = read_uint7(blob, pos)
        if lit_len > ulen:
            raise ValueError(
                f"rANSNx16 RLE: literal stream {lit_len} > raw size {ulen}")
    pack_info = None
    if fmt & F_PACK:
        p0 = pos
        nsym = blob[pos]
        pos += 1 + nsym
        plen, pos = read_uint7(blob, pos)
        if plen > max(ulen, 16):
            raise ValueError(
                f"rANSNx16 PACK: packed stream {plen} > raw size {ulen}")
        pack_info = (p0, plen)
        dec_len = plen
    elif fmt & F_RLE:
        dec_len = lit_len
    else:
        dec_len = ulen
    n_states = 32 if fmt & F_N32 else 4
    if fmt & F_CAT:
        payload = bytes(blob[pos:pos + dec_len])
    elif fmt & F_ORDER1:
        payload = _decode_o1(blob, pos, dec_len, n_states)
    else:
        payload = _decode_o0(blob, pos, dec_len, n_states)
    if fmt & F_PACK:
        # unpacked length: literal count under RLE, else full size
        want = lit_len if fmt & F_RLE else ulen
        payload, _ = _unpack(blob, pack_info[0], payload, want)
    if fmt & F_RLE:
        payload = _rle_decode(rle_meta, payload, ulen)
    if len(payload) != ulen:
        raise ValueError(
            f"rANSNx16: decoded {len(payload)} bytes, expected {ulen}")
    return payload
