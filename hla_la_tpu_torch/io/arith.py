"""Adaptive arithmetic codec (CRAM 3.1 block compression method 6).

The byte-wise adaptive range coder from the CRAM 3.1 codecs specification
(hts-specs CRAMcodecs, "Adaptive arithmetic coding"): an LZMA-style
carry-propagating range coder driving adaptive per-context frequency
models, with the same front-end transforms as rANS Nx16 — PACK (bit
packing of <=16 distinct symbols), RLE (run lengths coded with their own
adaptive models), STRIPE (N interleaved substreams), CAT (stored raw),
EXT (payload handed to bzip2) and NOSZ (no embedded size).

Both encode and decode are implemented (pure Python/numpy, with a native
C++ fast path for the payload decode via the native module when built).
Parity caveat, exactly as for io/rans_nx16.py: this environment has no
htslib/htscodecs and no CRAM 3.1 sample files, so the layout follows the
specification text but could not be cross-validated against the reference
codec; every section is documented inline and locked by round-trip and
fuzz tests (tests/test_cram31_codecs.py).

Stream layout implemented here:
  format byte: 0x01 ORDER1 | 0x04 EXT | 0x08 STRIPE | 0x10 NOSZ |
               0x20 CAT | 0x40 RLE | 0x80 PACK
  [uint7 ulen]                       unless NOSZ
  STRIPE: byte N; uint7 clen[0..N); N nested blocks (each with NOSZ),
          substream j holds bytes i with i % N == j
  CAT:    raw bytes follow
  EXT:    a bzip2 stream follows (applied after PACK, if any)
  PACK meta: byte nsym; nsym map bytes (the packed length is derived from
          the output size: nsym<=1 -> 0, <=2 -> ceil(n/8), <=4 ->
          ceil(n/4), else ceil(n/2) packed bytes)
  payload (range-coded unless CAT/EXT):
    order 0: one adaptive 256-symbol model
    order 1: one adaptive 256-symbol model per previous byte
    RLE:     literals use the order-0/1 byte model above; after each
             literal the remaining run length is coded base-255 with
             adaptive 256-symbol run models: first chunk from
             run_model[literal], continuation chunks (while chunk == 255)
             from a shared continuation model
  range coder: 32-bit range, 24-bit renormalisation, carry-propagating
             (cache + pending-0xFF) encoder; decoder reads a 5-byte
             initial code (first byte is the encoder's cache seed, 0).

Adaptive model: frequencies start at 1, increment by 16 per observed
symbol, halve (rounding up) when the total exceeds 2^16 - 32 so the
range//total quotient never underflows the 24-bit renorm window.
"""

from __future__ import annotations

import bz2

import numpy as np

from .rans_nx16 import pack_bits, read_uint7, unpack_bits, write_uint7

F_ORDER1 = 0x01
F_EXT = 0x04
F_STRIPE = 0x08
F_NOSZ = 0x10
F_CAT = 0x20
F_RLE = 0x40
F_PACK = 0x80

TOP = 1 << 24
STEP = 16
MAX_TOT = (1 << 16) - 32


# ------------------------------------------------------------ range coder
class RangeEncoder:
    """Carry-propagating (LZMA-style) range encoder: 32-bit range, byte
    renormalisation at 2^24, pending-0xFF carry resolution."""

    __slots__ = ("low", "range", "cache", "cache_size", "out")

    def __init__(self) -> None:
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.cache_size = 1   # seed byte; decoder skips it
        self.out = bytearray()

    def _shift_low(self) -> None:
        low = self.low
        if (low & 0xFFFFFFFF) < 0xFF000000 or low >> 32:
            carry = low >> 32
            out = self.out
            out.append((self.cache + carry) & 0xFF)
            if self.cache_size > 1:
                out.extend(bytes([(0xFF + carry) & 0xFF])
                           * (self.cache_size - 1))
            self.cache = (low >> 24) & 0xFF
            self.cache_size = 0
        self.cache_size += 1
        self.low = (low << 8) & 0xFFFFFFFF

    def encode(self, cum: int, freq: int, tot: int) -> None:
        r = self.range // tot
        self.low += r * cum
        self.range = r * freq
        while self.range < TOP:
            self.range <<= 8
            self._shift_low()

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class RangeDecoder:
    __slots__ = ("buf", "pos", "range", "code", "_r")

    def __init__(self, buf, pos: int) -> None:
        self.buf = buf
        self.range = 0xFFFFFFFF
        code = 0
        end = len(buf)
        # 5 init bytes: the first is the encoder's zero cache seed
        for i in range(5):
            code = (code << 8) | (buf[pos + i] if pos + i < end else 0)
        self.code = code & 0xFFFFFFFF
        self.pos = pos + 5
        self._r = 0

    def get_freq(self, tot: int) -> int:
        self._r = self.range // tot
        f = self.code // self._r
        return tot - 1 if f >= tot else f

    def decode(self, cum: int, freq: int) -> None:
        r = self._r
        self.code -= cum * r
        self.range = r * freq
        buf, pos, end = self.buf, self.pos, len(self.buf)
        while self.range < TOP:
            self.code = ((self.code << 8)
                         | (buf[pos] if pos < end else 0)) & 0xFFFFFFFFFF
            pos += 1
            self.range <<= 8
        self.pos = pos
        self.code &= 0xFFFFFFFF


class SimpleModel:
    """Adaptive frequency model over `nsym` symbols (freq 1 start, +STEP
    per hit, halved when the total would overflow the coder)."""

    __slots__ = ("freq", "tot", "nsym")

    def __init__(self, nsym: int) -> None:
        self.freq = [1] * nsym
        self.tot = nsym
        self.nsym = nsym

    def encode(self, enc: RangeEncoder, sym: int) -> None:
        freq = self.freq
        cum = 0
        for s in range(sym):
            cum += freq[s]
        enc.encode(cum, freq[sym], self.tot)
        self._bump(sym)

    def decode(self, dec: RangeDecoder) -> int:
        freq = self.freq
        f = dec.get_freq(self.tot)
        cum = 0
        sym = 0
        while cum + freq[sym] <= f:
            cum += freq[sym]
            sym += 1
        dec.decode(cum, freq[sym])
        self._bump(sym)
        return sym

    def _bump(self, sym: int) -> None:
        self.freq[sym] += STEP
        self.tot += STEP
        if self.tot > MAX_TOT:
            freq = self.freq
            tot = 0
            for s in range(self.nsym):
                freq[s] = (freq[s] + 1) >> 1
                tot += freq[s]
            self.tot = tot


# --------------------------------------------------------------- payloads
def _native_encode(data: bytes, order1: bool, rle: bool) -> bytes | None:
    from .. import native
    enc = getattr(native, "arith_encode", None)
    if enc is None or not native.available():
        return None
    return enc(data, 1 if order1 else 0, 1 if rle else 0)


def _encode_payload(data: bytes, order1: bool, rle: bool) -> bytes:
    res = _native_encode(data, order1, rle)
    if res is not None:
        return res
    enc = RangeEncoder()
    n = len(data)
    if order1:
        models = [SimpleModel(256) for _ in range(256)]
    else:
        models = [SimpleModel(256)]
    if not rle:
        last = 0
        for b in data:
            models[last].encode(enc, b)
            if order1:
                last = b
        return enc.finish()
    run_models = [SimpleModel(256) for _ in range(256)]
    cont_model = SimpleModel(256)
    i = 0
    last = 0
    while i < n:
        b = data[i]
        run = 1
        while i + run < n and data[i + run] == b:
            run += 1
        models[last].encode(enc, b)
        if order1:
            last = b
        rem = run - 1
        chunk = min(rem, 255)
        run_models[b].encode(enc, chunk)
        rem -= chunk
        while chunk == 255:
            chunk = min(rem, 255)
            cont_model.encode(enc, chunk)
            rem -= chunk
        i += run
    return enc.finish()


def _decode_payload(buf, pos: int, n_out: int, order1: bool,
                    rle: bool) -> bytes:
    dec = RangeDecoder(buf, pos)
    out = bytearray(n_out)
    if order1:
        models = [SimpleModel(256) for _ in range(256)]
    else:
        models = [SimpleModel(256)]
    if not rle:
        last = 0
        for i in range(n_out):
            b = models[last].decode(dec)
            out[i] = b
            if order1:
                last = b
        return bytes(out)
    run_models = [SimpleModel(256) for _ in range(256)]
    cont_model = SimpleModel(256)
    i = 0
    last = 0
    while i < n_out:
        b = models[last].decode(dec)
        if order1:
            last = b
        chunk = run_models[b].decode(dec)
        run = 1 + chunk
        while chunk == 255:
            chunk = cont_model.decode(dec)
            run += chunk
        if run > n_out - i:
            raise ValueError("arith RLE: run overflows output")
        for k in range(run):
            out[i + k] = b
        i += run
    return bytes(out)


def _native_decode(buf, pos: int, n_out: int, order1: bool,
                   rle: bool) -> bytes | None:
    from .. import native
    dec = getattr(native, "arith_decode", None)
    if dec is None or not native.available():
        return None
    return dec(bytes(buf), pos, n_out, 1 if order1 else 0, 1 if rle else 0)


# -------------------------------------------------------------- PACK bits
def _packed_len(nsym: int, n_out: int) -> int:
    if nsym <= 1:
        return 0
    if nsym <= 2:
        return (n_out + 7) // 8
    if nsym <= 4:
        return (n_out + 3) // 4
    return (n_out + 1) // 2


def _pack(data: bytes) -> tuple[bytes, bytes] | None:
    """PACK meta here is nsym + map only (no packed-length field): the
    packed byte count is derived from the output size."""
    arr = np.frombuffer(data, dtype=np.uint8)
    syms = np.unique(arr)
    if len(syms) > 16:
        return None
    meta = bytearray([len(syms)])
    meta += bytes(int(s) for s in syms)
    inv = np.zeros(256, dtype=np.uint8)
    inv[syms] = np.arange(len(syms), dtype=np.uint8)
    return bytes(meta), pack_bits(inv[arr], len(syms))


def _unpack(mp: np.ndarray, packed: bytes, n_out: int) -> bytes:
    return unpack_bits(mp, packed, n_out, label="arith")


# ----------------------------------------------------------------- public
def compress(data: bytes, order: int = 0, use_pack: bool = True,
             use_rle: bool = False, ext: bool = False, stripe: int = 0,
             cat: bool = False, nosz: bool = False) -> bytes:
    """Encode one adaptive-arithmetic block."""
    out = bytearray()
    n = len(data)
    if stripe and n >= stripe:
        out.append(F_STRIPE | (F_NOSZ if nosz else 0))
        if not nosz:
            write_uint7(n, out)
        out.append(stripe)
        arr = np.frombuffer(data, dtype=np.uint8)
        subs = [compress(arr[j::stripe].tobytes(), order=order,
                         use_pack=use_pack, use_rle=use_rle, ext=ext,
                         nosz=True)
                for j in range(stripe)]
        for s in subs:
            write_uint7(len(s), out)
        for s in subs:
            out += s
        return bytes(out)
    if cat or n < 4:
        out.append(F_CAT | (F_NOSZ if nosz else 0))
        if not nosz:
            write_uint7(n, out)
        out += data
        return bytes(out)
    fmt = (F_ORDER1 if order == 1 else 0) | (F_NOSZ if nosz else 0)
    payload = data
    pack_meta = None
    if use_pack:
        p = _pack(payload)
        if p is not None:
            fmt |= F_PACK
            pack_meta, payload = p
    if use_rle:
        fmt |= F_RLE
    if ext:
        fmt |= F_EXT
        fmt &= ~(F_RLE | F_ORDER1)
    out.append(fmt)
    if not nosz:
        write_uint7(n, out)
    if fmt & F_PACK:
        out += pack_meta
    if fmt & F_EXT:
        out += bz2.compress(payload)
    else:
        out += _encode_payload(payload, bool(fmt & F_ORDER1),
                               bool(fmt & F_RLE))
    return bytes(out)


def uncompress(blob: bytes, n_out: int | None = None) -> bytes:
    """Decode one adaptive-arithmetic block (n_out required under NOSZ)."""
    pos = 0
    fmt = blob[pos]
    pos += 1
    if fmt & F_NOSZ:
        if n_out is None:
            raise ValueError("arith: NOSZ block needs external size")
        ulen = n_out
    else:
        ulen, pos = read_uint7(blob, pos)
    if ulen > (1 << 28):
        raise ValueError(f"arith block: implausible raw size {ulen}")
    if fmt & F_STRIPE:
        n = blob[pos]
        pos += 1
        if n == 0:
            raise ValueError("arith STRIPE: zero substreams")
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
    if fmt & F_CAT:
        payload = bytes(blob[pos:pos + ulen])
        if len(payload) != ulen:
            raise ValueError("arith CAT: truncated block")
        return payload
    mp = None
    if fmt & F_PACK:
        nsym = blob[pos]
        pos += 1
        mp = np.frombuffer(bytes(blob[pos:pos + nsym]), dtype=np.uint8)
        if len(mp) != nsym:
            raise ValueError("arith PACK: truncated symbol map")
        pos += nsym
        dec_len = _packed_len(nsym, ulen)
    else:
        dec_len = ulen
    if fmt & F_EXT:
        try:
            # bounded decompress: a crafted bz2 bomb must not allocate
            # past the declared size before the length check runs
            dec = bz2.BZ2Decompressor()
            payload = dec.decompress(bytes(blob[pos:]), dec_len + 1)
        except Exception as e:  # noqa: BLE001
            raise ValueError(f"arith EXT: corrupt bzip2 payload ({e})") from e
        if len(payload) != dec_len or not dec.eof or dec.unused_data:
            raise ValueError(
                f"arith EXT: decoded {len(payload)} bytes, expected "
                f"{dec_len}")
    else:
        payload = _native_decode(blob, pos, dec_len,
                                 bool(fmt & F_ORDER1), bool(fmt & F_RLE))
        if payload is None:
            payload = _decode_payload(blob, pos, dec_len,
                                      bool(fmt & F_ORDER1),
                                      bool(fmt & F_RLE))
    if fmt & F_PACK:
        payload = _unpack(mp, payload, ulen)
    if len(payload) != ulen:
        raise ValueError(
            f"arith: decoded {len(payload)} bytes, expected {ulen}")
    return payload
