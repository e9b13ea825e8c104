"""Name-tokeniser codec (CRAM 3.1 block compression method 8, "tok3").

Read names are highly structured ("machine:run:flowcell:lane:tile:x:y"),
so the CRAM 3.1 codecs specification (hts-specs CRAMcodecs, "Name
tokenisation") compresses them by tokenising each name into typed fields
(alpha runs, digit runs with and without leading zeros, single
characters), diffing each name against the previous one token by token,
and routing every (token position, token type) pair into its own byte
stream; each stream is then compressed with rANS Nx16 or the adaptive
arithmetic coder, which see the narrow per-field distributions.

Both encode and decode are implemented.  Parity caveat, exactly as for
io/rans_nx16.py and io/arith.py: no htscodecs or CRAM 3.1 sample files
exist in this environment, so the exact stream layout below follows the
specification's token model but could not be cross-validated bit-for-bit
against the reference codec; the layout is documented here and locked by
round-trip and fuzz tests (tests/test_cram31_codecs.py).

Token types (one TYPE stream byte per name per position):
  TYPE(0)    the per-position type selector stream itself
  ALPHA(1)   run of non-digit bytes, stored NUL-terminated in the ALPHA
             stream of that position
  CHAR(2)    a single byte (used for separators), stored in CHAR
  DZLEN(3)   digit-run length stream for DIGITS0
  DIGITS0(4) digit run WITH leading zeros: value as uint32le in the
             DIGITS0 stream + length byte in DZLEN
  DUP(5)     whole name identical to the previous name (position-0 only)
  DIFF(6)    whole name differs from the previous (position-0 only; the
             token streams for positions >= 1 follow)
  DIGITS(7)  digit run, no leading zeros: value as uint32le
  DDELTA(8)  digit run whose value minus the previous name's value at
             this position fits in one byte (stored in DDELTA)
  MATCH(9)   token equal to the previous name's token at this position
  END(10)    end of name

Container layout:
  uint7  ulen          total uncompressed byte length of the name block
  uint7  n_names
  byte   sep_info      bit0: separator (0 = '\\n', 1 = '\\0');
                       bit1: trailing separator present after last name
  byte   use_arith     1 = streams arith-coded, 0 = rANS Nx16
  streams, in token-position order:
    byte  desc         bits 0-5 token type; bit 7 set on the first stream
                       of a new token position
    uint7 clen
    clen bytes         the compressed stream (rANSNx16/arith, sizes
                       embedded)
"""

from __future__ import annotations

from .rans_nx16 import read_uint7, write_uint7

T_TYPE, T_ALPHA, T_CHAR, T_DZLEN, T_DIGITS0, T_DUP, T_DIFF, T_DIGITS, \
    T_DDELTA, T_MATCH, T_END = range(11)
_N_TYPES = 11
_MAX_POS = 256   # names longer than this many tokens are rejected


def _tokenize(name: bytes) -> list[tuple[int, bytes]]:
    """Split a name into (type, payload) tokens: digit runs (DIGITS, or
    DIGITS0 when there is a leading zero / the run is > 9 digits) and
    non-digit runs (ALPHA, or CHAR when length 1)."""
    toks: list[tuple[int, bytes]] = []
    i = 0
    n = len(name)
    while i < n:
        c = name[i]
        if 0x30 <= c <= 0x39:
            j = i
            while j < n and 0x30 <= name[j] <= 0x39:
                j += 1
            run = name[i:j]
            # uint32 value streams cap the run at 9 digits; longer runs
            # or leading zeros go through DIGITS0 (value + explicit len)
            if len(run) > 9:
                for k in range(i, j, 9):
                    toks.append((T_DIGITS0, name[k:min(k + 9, j)]))
            elif run[0] == 0x30 and len(run) > 1:
                toks.append((T_DIGITS0, run))
            else:
                toks.append((T_DIGITS, run))
            i = j
        else:
            j = i
            while j < n and not (0x30 <= name[j] <= 0x39):
                j += 1
            if j - i == 1:
                toks.append((T_CHAR, name[i:j]))
            else:
                toks.append((T_ALPHA, name[i:j]))
            i = j
    toks.append((T_END, b""))
    return toks


class _Streams:
    """pos x type -> bytearray, created on demand."""

    def __init__(self) -> None:
        self.data: dict[tuple[int, int], bytearray] = {}

    def get(self, pos: int, ttype: int) -> bytearray:
        key = (pos, ttype)
        s = self.data.get(key)
        if s is None:
            s = self.data[key] = bytearray()
        return s


def compress(data: bytes, use_arith: bool = False) -> bytes:
    """Encode a block of separator-delimited read names."""
    sep = b"\0" if b"\0" in data else b"\n"
    trailing = data.endswith(sep)
    names = data.split(sep)
    if trailing:
        names = names[:-1]
    n_names = len(names)
    streams = _Streams()
    prev_toks: list[tuple[int, bytes]] = []
    for name in names:
        t0 = streams.get(0, T_TYPE)
        if prev_toks and name == _join(prev_toks):
            t0.append(T_DUP)
            continue
        t0.append(T_DIFF)
        toks = _tokenize(name)
        if len(toks) > _MAX_POS:
            raise ValueError(f"tok3: name has too many tokens ({len(toks)})")
        for p, (ttype, payload) in enumerate(toks, start=1):
            tstream = streams.get(p, T_TYPE)
            prev = prev_toks[p - 1] if p - 1 < len(prev_toks) else None
            if prev is not None and prev == (ttype, payload):
                tstream.append(T_MATCH)
                continue
            if (ttype == T_DIGITS and prev is not None
                    and prev[0] == T_DIGITS):
                delta = int(payload) - int(prev[1])
                if 0 <= delta <= 255:
                    tstream.append(T_DDELTA)
                    streams.get(p, T_DDELTA).append(delta)
                    continue
            tstream.append(ttype)
            if ttype == T_ALPHA:
                s = streams.get(p, T_ALPHA)
                s.extend(payload)
                s.append(0)
            elif ttype == T_CHAR:
                streams.get(p, T_CHAR).extend(payload)
            elif ttype == T_DIGITS:
                streams.get(p, T_DIGITS).extend(
                    int(payload).to_bytes(4, "little"))
            elif ttype == T_DIGITS0:
                streams.get(p, T_DIGITS0).extend(
                    int(payload).to_bytes(4, "little"))
                streams.get(p, T_DZLEN).append(len(payload))
            elif ttype == T_END:
                pass
            else:  # pragma: no cover — _tokenize only emits the above
                raise AssertionError(ttype)
        prev_toks = toks
    out = bytearray()
    write_uint7(len(data), out)
    write_uint7(n_names, out)
    out.append((1 if sep == b"\0" else 0) | (2 if trailing else 0))
    out.append(1 if use_arith else 0)
    if use_arith:
        from . import arith as codec
    else:
        from . import rans_nx16 as codec

    def enc(b: bytes) -> bytes:
        # per-stream distributions vary wildly (all-MATCH TYPE streams vs
        # random digit values): try order 0 and, when large enough that a
        # context table can pay for itself, order 1 — keep the smaller
        best = codec.compress(b, order=0)
        if len(b) >= 512:
            o1 = codec.compress(b, order=1)
            if len(o1) < len(best):
                best = o1
        return best
    max_pos = max((p for p, _ in streams.data), default=-1)
    for p in range(max_pos + 1):
        first = True
        for ttype in range(_N_TYPES):
            s = streams.data.get((p, ttype))
            if s is None or len(s) == 0:
                continue
            out.append((0x80 if first else 0) | ttype)
            first = False
            blob = enc(bytes(s))
            write_uint7(len(blob), out)
            out += blob
        if first:
            raise ValueError(f"tok3: empty token position {p}")
    return bytes(out)


def _join(toks: list[tuple[int, bytes]]) -> bytes:
    return b"".join(p for _, p in toks)


class _Reader:
    """Per-stream cursor over the decoded (pos, type) byte streams."""

    def __init__(self) -> None:
        self.bufs: dict[tuple[int, int], bytes] = {}
        self.pos: dict[tuple[int, int], int] = {}

    def take(self, p: int, ttype: int, n: int) -> bytes:
        key = (p, ttype)
        buf = self.bufs.get(key)
        if buf is None:
            raise ValueError(f"tok3: missing stream pos={p} type={ttype}")
        i = self.pos.get(key, 0)
        if i + n > len(buf):
            raise ValueError(f"tok3: stream pos={p} type={ttype} exhausted")
        self.pos[key] = i + n
        return buf[i:i + n]

    def take_cstr(self, p: int, ttype: int) -> bytes:
        key = (p, ttype)
        buf = self.bufs.get(key)
        if buf is None:
            raise ValueError(f"tok3: missing stream pos={p} type={ttype}")
        i = self.pos.get(key, 0)
        j = buf.find(b"\0", i)
        if j < 0:
            raise ValueError(f"tok3: unterminated ALPHA at pos={p}")
        self.pos[key] = j + 1
        return buf[i:j]


def uncompress(blob: bytes, n_out: int | None = None) -> bytes:
    """Decode a tok3 name block back to the separator-delimited bytes."""
    pos = 0
    ulen, pos = read_uint7(blob, pos)
    if n_out is not None and n_out != ulen:
        raise ValueError(f"tok3: embedded size {ulen} != block size {n_out}")
    if ulen > (1 << 28):
        raise ValueError(f"tok3: implausible raw size {ulen}")
    n_names, pos = read_uint7(blob, pos)
    if n_names > ulen + 1:
        raise ValueError(f"tok3: {n_names} names in {ulen} bytes")
    sep_info = blob[pos]
    use_arith = blob[pos + 1]
    pos += 2
    sep = b"\0" if sep_info & 1 else b"\n"
    trailing = bool(sep_info & 2)
    if use_arith:
        from . import arith as codec
    else:
        from . import rans_nx16 as codec
    rd = _Reader()
    tpos = -1
    end = len(blob)
    while pos < end:
        desc = blob[pos]
        pos += 1
        ttype = desc & 0x3F
        if ttype >= _N_TYPES:
            raise ValueError(f"tok3: bad token type {ttype}")
        if desc & 0x80:
            tpos += 1
        if tpos < 0:
            raise ValueError("tok3: first stream does not open a position")
        clen, pos = read_uint7(blob, pos)
        if pos + clen > end:
            raise ValueError("tok3: truncated stream")
        rd.bufs[(tpos, ttype)] = codec.uncompress(bytes(blob[pos:pos + clen]))
        pos += clen
    names: list[bytes] = []
    prev_toks: list[tuple[int, bytes]] = []
    for _ in range(n_names):
        sel = rd.take(0, T_TYPE, 1)[0]
        if sel == T_DUP:
            if not prev_toks:
                raise ValueError("tok3: DUP with no previous name")
            names.append(_join(prev_toks))
            continue
        if sel != T_DIFF:
            raise ValueError(f"tok3: bad name selector {sel}")
        toks: list[tuple[int, bytes]] = []
        p = 1
        while True:
            ttype = rd.take(p, T_TYPE, 1)[0]
            prev = prev_toks[p - 1] if p - 1 < len(prev_toks) else None
            if ttype == T_MATCH:
                if prev is None:
                    raise ValueError(f"tok3: MATCH beyond previous name "
                                     f"at pos {p}")
                toks.append(prev)
                if prev[0] == T_END:   # END can MATCH the previous name's
                    break              # END when token counts line up
            elif ttype == T_DDELTA:
                if prev is None or prev[0] != T_DIGITS:
                    raise ValueError(f"tok3: DDELTA without previous "
                                     f"digits at pos {p}")
                delta = rd.take(p, T_DDELTA, 1)[0]
                toks.append((T_DIGITS, b"%d" % (int(prev[1]) + delta)))
            elif ttype == T_ALPHA:
                toks.append((T_ALPHA, rd.take_cstr(p, T_ALPHA)))
            elif ttype == T_CHAR:
                toks.append((T_CHAR, rd.take(p, T_CHAR, 1)))
            elif ttype == T_DIGITS:
                v = int.from_bytes(rd.take(p, T_DIGITS, 4), "little")
                toks.append((T_DIGITS, b"%d" % v))
            elif ttype == T_DIGITS0:
                v = int.from_bytes(rd.take(p, T_DIGITS0, 4), "little")
                ln = rd.take(p, T_DZLEN, 1)[0]
                s = b"%d" % v
                if len(s) > ln:
                    raise ValueError("tok3: DIGITS0 value longer than its "
                                     "stored length")
                toks.append((T_DIGITS0, b"0" * (ln - len(s)) + s))
            elif ttype == T_END:
                toks.append((T_END, b""))
                break
            else:
                raise ValueError(f"tok3: bad token type {ttype} at pos {p}")
            p += 1
            if p > _MAX_POS:
                raise ValueError("tok3: runaway token position")
        prev_toks = toks
        names.append(_join(toks))
    out = sep.join(names)
    if trailing and names:
        out += sep
    if len(out) != ulen:
        raise ValueError(f"tok3: decoded {len(out)} bytes, expected {ulen}")
    return out
