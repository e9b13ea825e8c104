"""rANS 4x8 codec (CRAM 3.0 block compression method 4).

Implements the interleaved 4-state byte-wise range-ANS coder from the CRAM
3.0 specification (order-0 and order-1), encode and decode, pure numpy/
Python.  The native library provides a faster decode (hla_rans4x8_decode);
this module is the reference implementation and fallback.

Format (per the CRAM 3.0 spec §13.4-13.7 / htslib rANS_static):
  byte order (0|1), uint32le compressed size (excl. 5-byte header? — the
  sizes here follow the spec: n_in = compressed bytes after the 9-byte
  header, n_out = raw size), uint32le raw size, frequency table, 4
  big-endian uint32 initial states interleaved with data.
"""

from __future__ import annotations

import numpy as np

RANS_BYTE_L = 1 << 23
TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT      # 4096


# ----------------------------------------------------------- freq tables
def _normalize_freqs(counts: np.ndarray, total: int = TOTFREQ) -> np.ndarray:
    """Scale counts so they sum to `total`, every nonzero count >= 1."""
    n = counts.sum()
    assert n > 0
    freqs = np.zeros_like(counts)
    nz = counts > 0
    scaled = counts[nz].astype(np.float64) * (total / n)
    f = np.maximum(1, np.floor(scaled)).astype(np.int64)
    # fix rounding so the sum is exactly total: adjust the largest symbol
    diff = total - f.sum()
    order = np.argsort(-counts[nz])
    i = 0
    while diff != 0:
        j = order[i % len(order)]
        if f[j] + diff >= 1:
            f[j] += diff
            diff = 0
        else:
            take = f[j] - 1
            f[j] = 1
            diff += take
            i += 1
    freqs[nz] = f
    return freqs


def _write_uint7(f: int, out: bytearray) -> None:
    """Frequency value: 1 byte if <128 else 2 bytes with top bit set."""
    if f < 128:
        out.append(f)
    else:
        assert f < (1 << 15)
        out.append(0x80 | (f >> 8))
        out.append(f & 0xFF)


def _read_uint7(buf: bytes, pos: int) -> tuple[int, int]:
    b = buf[pos]
    if b < 128:
        return b, pos + 1
    return ((b & 0x7F) << 8) | buf[pos + 1], pos + 2


def _write_sym_freq_table(freqs: np.ndarray, out: bytearray) -> None:
    """Symbol+frequency table with the spec's run-length scheme: a symbol
    that directly follows another present symbol is emitted once with a
    run-length byte counting how many further consecutive symbols follow;
    those are then implicit.  Terminated by a 0 symbol byte."""
    rle = 0
    for j in range(256):
        if freqs[j] == 0:
            continue
        if rle > 0:
            rle -= 1
        else:
            out.append(j)
            if j > 0 and freqs[j - 1] > 0:
                # count consecutive present symbols after j
                run = 0
                while j + run + 1 < 256 and freqs[j + run + 1] > 0:
                    run += 1
                out.append(run)
                rle = run
        _write_uint7(int(freqs[j]), out)
    out.append(0)  # terminator


def _read_sym_freq_table(buf: bytes, pos: int) -> tuple[np.ndarray, int]:
    freqs = np.zeros(256, dtype=np.int64)
    j = buf[pos]
    pos += 1
    rle = 0
    while True:
        f, pos = _read_uint7(buf, pos)
        freqs[j] = f
        if rle == 0 and pos < len(buf) and buf[pos] == j + 1:
            # next symbol is consecutive: symbol byte + run-length byte
            j = buf[pos]
            rle = buf[pos + 1]
            pos += 2
        elif rle > 0:
            rle -= 1
            j += 1
        else:
            j = buf[pos]
            pos += 1
            if j == 0:
                break
    return freqs, pos


# ------------------------------------------------------------ order 0
def encode_o0(data: bytes) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    counts = np.bincount(arr, minlength=256).astype(np.int64)
    freqs = _normalize_freqs(counts)
    cum = np.concatenate([[0], np.cumsum(freqs)])[:256]

    header = bytearray()
    _write_sym_freq_table(freqs, header)

    # encode in reverse, 4 interleaved states
    states = [RANS_BYTE_L] * 4
    out_rev = bytearray()
    n = len(arr)
    for i in range(n - 1, -1, -1):
        j = i & 3
        s = int(arr[i])
        f = int(freqs[s])
        c = int(cum[s])
        x = states[j]
        x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * f
        while x >= x_max:
            out_rev.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << TF_SHIFT) + (x % f) + c
    body = bytearray()
    for j in range(4):
        body += int(states[j]).to_bytes(4, "little")
    body += bytes(reversed(out_rev))

    comp = bytes(header) + bytes(body)
    return (b"\x00" + len(comp).to_bytes(4, "little")
            + n.to_bytes(4, "little") + comp)


def decode_o0(comp: bytes, freqs: np.ndarray, n_out: int) -> bytes:
    cum = np.concatenate([[0], np.cumsum(freqs)])
    # symbol lookup table over the 4096 slots
    sym_of = np.repeat(np.arange(256, dtype=np.uint8),
                       freqs.astype(np.int64))
    assert len(sym_of) == TOTFREQ
    pos = 0
    states = []
    for j in range(4):
        states.append(int.from_bytes(comp[pos:pos + 4], "little"))
        pos += 4
    out = bytearray(n_out)
    L = RANS_BYTE_L
    mask = TOTFREQ - 1
    f = freqs.astype(np.int64)
    c = cum.astype(np.int64)
    ln = len(comp)
    for i in range(n_out):
        j = i & 3
        x = states[j]
        slot = x & mask
        s = int(sym_of[slot])
        out[i] = s
        x = int(f[s]) * (x >> TF_SHIFT) + slot - int(c[s])
        while x < L and pos < ln:
            x = (x << 8) | comp[pos]
            pos += 1
        states[j] = x
    return bytes(out)


# ------------------------------------------------------------ order 1
def encode_o1(data: bytes) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    # 4 interleaved streams over quarters: stream j handles
    # arr[j*(n//4) : (j+1)*(n//4)], stream 3 also the remainder
    q = n >> 2
    counts = np.zeros((256, 256), dtype=np.int64)
    ctx = np.empty(n, dtype=np.uint8)
    for j in range(4):
        lo = j * q
        hi = (j + 1) * q if j < 3 else n
        ctx[lo] = 0
        ctx[lo + 1:hi] = arr[lo:hi - 1]
    np.add.at(counts, (ctx.astype(np.int64), arr.astype(np.int64)), 1)
    freqs = np.zeros_like(counts)
    for r in range(256):
        if counts[r].sum() > 0:
            freqs[r] = _normalize_freqs(counts[r])
    cums = np.zeros((256, 257), dtype=np.int64)
    cums[:, 1:] = np.cumsum(freqs, axis=1)

    header = bytearray()
    # context table: same RLE scheme over context bytes, each context
    # followed by its own order-0 style symbol table
    present = counts.sum(axis=1) > 0
    rle = 0
    for cx in range(256):
        if not present[cx]:
            continue
        if rle > 0:
            rle -= 1
        else:
            header.append(cx)
            if cx > 0 and present[cx - 1]:
                run = 0
                while cx + run + 1 < 256 and present[cx + run + 1]:
                    run += 1
                header.append(run)
                rle = run
        _write_sym_freq_table(freqs[cx], header)
    header.append(0)

    states = [RANS_BYTE_L] * 4
    out_rev = bytearray()
    # encode all four streams in reverse simultaneously is complex; encode
    # per-stream in reverse into one reversed buffer by processing global
    # reverse order with stream-local contexts
    bounds = [(j * q, (j + 1) * q if j < 3 else n) for j in range(4)]
    idx = [hi - 1 for (lo, hi) in bounds]
    # process: repeatedly take the stream with the largest remaining
    # (they must interleave in a fixed order for the decoder: decoder
    # reads symbol i of each stream round-robin... htslib processes
    # streams independently with shared output buffer in reverse of
    # encode-order; we mimic: encode in reverse global order j=3..0 per
    # step t = max_len-1..0)
    max_len = max(hi - lo for lo, hi in bounds)
    for t in range(max_len - 1, -1, -1):
        for j in range(3, -1, -1):
            lo, hi = bounds[j]
            if t >= hi - lo:
                continue
            i = lo + t
            s = int(arr[i])
            cx = int(ctx[i])
            f = int(freqs[cx, s])
            c = int(cums[cx, s])
            x = states[j]
            x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * f
            while x >= x_max:
                out_rev.append(x & 0xFF)
                x >>= 8
            states[j] = ((x // f) << TF_SHIFT) + (x % f) + c
    body = bytearray()
    for j in range(4):
        body += int(states[j]).to_bytes(4, "little")
    body += bytes(reversed(out_rev))
    comp = bytes(header) + bytes(body)
    return (b"\x01" + len(comp).to_bytes(4, "little")
            + n.to_bytes(4, "little") + comp)


def _read_o1_tables(comp: bytes) -> tuple[np.ndarray, int]:
    freqs = np.zeros((256, 256), dtype=np.int64)
    cx = comp[0]
    pos = 1
    rle = 0
    while True:
        tab, pos = _read_sym_freq_table(comp, pos)
        freqs[cx] = tab
        if rle == 0 and pos < len(comp) and comp[pos] == cx + 1:
            cx = comp[pos]
            rle = comp[pos + 1]
            pos += 2
        elif rle > 0:
            rle -= 1
            cx += 1
        else:
            cx = comp[pos]
            pos += 1
            if cx == 0:
                break
    return freqs, pos


def decode_o1(comp: bytes, n_out: int) -> bytes:
    freqs, pos = _read_o1_tables(comp)
    cums = np.zeros((256, 257), dtype=np.int64)
    cums[:, 1:] = np.cumsum(freqs, axis=1)
    sym_of = np.zeros((256, TOTFREQ), dtype=np.uint8)
    for r in range(256):
        if freqs[r].sum() > 0:
            sym_of[r] = np.repeat(np.arange(256, dtype=np.uint8),
                                  freqs[r])
    states = []
    for j in range(4):
        states.append(int.from_bytes(comp[pos:pos + 4], "little"))
        pos += 4
    n = n_out
    q = n >> 2
    bounds = [(j * q, (j + 1) * q if j < 3 else n) for j in range(4)]
    out = bytearray(n)
    last = [0, 0, 0, 0]
    L = RANS_BYTE_L
    mask = TOTFREQ - 1
    ln = len(comp)
    max_len = max(hi - lo for lo, hi in bounds)
    for t in range(max_len):
        for j in range(4):
            lo, hi = bounds[j]
            if t >= hi - lo:
                continue
            x = states[j]
            cx = last[j]
            slot = x & mask
            s = int(sym_of[cx, slot])
            out[lo + t] = s
            x = int(freqs[cx, s]) * (x >> TF_SHIFT) + slot - int(cums[cx, s])
            while x < L and pos < ln:
                x = (x << 8) | comp[pos]
                pos += 1
            states[j] = x
            last[j] = s
    return bytes(out)


# ------------------------------------------------------------- public
def compress(data: bytes, order: int = 0) -> bytes:
    if len(data) == 0:
        return (bytes([order]) + (0).to_bytes(4, "little")
                + (0).to_bytes(4, "little"))
    if order == 0 or len(data) < 8:
        # tiny inputs: order-1 quartering degenerates; use order-0
        return encode_o0(data)
    return encode_o1(data)


def uncompress(blob: bytes) -> bytes:
    """Decode a full rANS4x8 block (with its 9-byte header)."""
    order = blob[0]
    n_in = int.from_bytes(blob[1:5], "little")
    n_out = int.from_bytes(blob[5:9], "little")
    if n_out == 0:
        return b""
    if n_out > (1 << 31):
        raise ValueError(f"rANS block: implausible raw size {n_out}")
    comp = blob[9:9 + n_in]
    from .. import native
    dec = getattr(native, "rans4x8_decode", None)
    if dec is not None and native.available():
        res = dec(bytes(blob))
        if res is not None:
            return res
    if order == 0:
        freqs, pos = _read_sym_freq_table(comp, 0)
        return decode_o0(comp[pos:], freqs, n_out)
    return decode_o1(comp, n_out)
