"""ctypes bindings for the native host runtime (native/hla_native.cpp).

Every function has a pure-Python fallback; `available()` reports whether the
shared library was found/built.  Build with `make -C native`."""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _ensure_built(native_dir: str) -> None:
    """Build (or rebuild) libhla_native.so when it is missing or older than
    its source.  A fresh checkout has no .so (it is gitignored); without
    this the whole host hot path silently degrades to the Python fallbacks.
    Race-safe under the spawn worker pool via an exclusive flock; failures
    are swallowed — the fallbacks remain correct."""
    src = os.path.join(native_dir, "hla_native.cpp")
    so = os.path.join(native_dir, "libhla_native.so")
    if not os.path.exists(src):
        return
    try:
        fresh = (os.path.exists(so)
                 and os.path.getmtime(so) >= os.path.getmtime(src))
    except OSError:
        fresh = False
    if fresh:
        return
    import fcntl
    import subprocess
    lock_path = os.path.join(native_dir, ".build.lock")
    try:
        with open(lock_path, "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            # another process may have finished the build while we waited
            if (os.path.exists(so)
                    and os.path.getmtime(so) >= os.path.getmtime(src)):
                return
            subprocess.run(["make", "-C", native_dir],
                           capture_output=True, timeout=300, check=False)
    except Exception:  # noqa: BLE001 — no make/g++/flock: use fallbacks
        pass


def _find_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    override = os.environ.get("HLA_NATIVE_LIB")  # e.g. the ASan build
    if not override:
        _ensure_built(os.path.join(here, "native"))
    for cand in ([override] if override else []) + [
            os.path.join(here, "native", "libhla_native.so"),
            os.path.join(here, "libhla_native.so")]:
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
            except OSError:
                continue
            try:
                lib.hla_bgzf_inflate_all.restype = ctypes.c_int
                lib.hla_bgzf_inflate_all.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
                vp, i64, i32p = (ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_int64))
                lib.hla_bam_count.restype = ctypes.c_int64
                lib.hla_bam_count.argtypes = [vp, i64, i32p, i32p, i32p]
                lib.hla_bam_parse.restype = ctypes.c_int64
                lib.hla_bam_parse.argtypes = [vp, i64] + [vp] * 14
                lib.hla_nw_backtrace_batch.restype = None
                lib.hla_nw_backtrace_batch.argtypes = [
                    vp, i64, i64, i64, vp, vp, vp, vp, i64, vp]
                f32 = ctypes.c_float
                lib.hla_nw_forward.restype = None
                lib.hla_nw_forward.argtypes = [
                    vp, vp, vp, i64, i64, i64, f32, f32, f32, f32,
                    vp, vp, vp, vp, ctypes.c_int]
                lib.hla_free.restype = None
                lib.hla_free.argtypes = [vp]
                f64 = ctypes.c_double
                i64pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))
                lib.hla_seed_chain.restype = i64
                lib.hla_seed_chain.argtypes = (
                    [vp, i64, vp, vp, i64, vp, i64, i64, vp, i64, vp, i64, vp]
                    + [i64] * 5 + [i64pp] * 5)
                lib.hla_select_pairs.restype = None
                lib.hla_select_pairs.argtypes = (
                    [i64] + [vp] * 11 + [i64] + [f64, f64, f64] + [vp] * 6)
                lib.hla_walk_haplotype.restype = ctypes.c_int
                lib.hla_walk_haplotype.argtypes = (
                    [vp, i64] + [vp] * 8 + [i64, i64, i64, vp])
                lib.hla_rans4x8_decode.restype = ctypes.c_int
                lib.hla_rans4x8_decode.argtypes = [vp, i64, vp, i64]
                lib.hla_ransnx16_decode.restype = ctypes.c_int
                lib.hla_ransnx16_decode.argtypes = [
                    vp, i64, i64, i64, i64, ctypes.c_int, ctypes.c_int,
                    vp, i64, vp]
                lib.hla_arith_decode.restype = ctypes.c_int
                lib.hla_arith_decode.argtypes = [
                    vp, i64, i64, vp, i64, ctypes.c_int, ctypes.c_int]
                lib.hla_arith_encode.restype = i64
                lib.hla_arith_encode.argtypes = [
                    vp, i64, ctypes.c_int, ctypes.c_int, vp, i64]
                lib.hla_ransnx16_encode.restype = i64
                lib.hla_ransnx16_encode.argtypes = [
                    vp, i64, vp, vp, i64, vp, ctypes.c_int, vp, i64]
                lib.hla_fqz_encode.restype = i64
                lib.hla_fqz_encode.argtypes = (
                    [vp, i64, vp, i64, vp, vp, vp, ctypes.c_int,
                     ctypes.c_int] + [vp] * 5 + [vp, i64])
                lib.hla_fqz_decode.restype = ctypes.c_int
                lib.hla_fqz_decode.argtypes = (
                    [vp, i64, i64, vp, i64, ctypes.c_int, ctypes.c_int]
                    + [vp] * 6)
                lib.hla_itf8_decode_all.restype = i64
                lib.hla_itf8_decode_all.argtypes = [vp, i64, vp, vp]
                lib.hla_encode_kmers.restype = None
                lib.hla_encode_kmers.argtypes = (
                    [vp, i64, i64, vp, vp, ctypes.c_int])
                lib.hla_encode_kmers_c.restype = None
                lib.hla_encode_kmers_c.argtypes = (
                    [vp, i64, i64, vp, vp, ctypes.c_int, ctypes.c_int])
                lib.hla_gather_windows.restype = None
                lib.hla_gather_windows.argtypes = (
                    [vp] * 5 + [i64, i64, vp, ctypes.c_int])
                lib.hla_seed_select.restype = None
                lib.hla_seed_select.argtypes = (
                    [vp] * 6 + [i64] * 4 + [vp] * 2)
                lib.hla_project_count.restype = i64
                lib.hla_project_count.argtypes = [vp] * 7 + [i64, i64, vp, vp]
                lib.hla_project_fill.restype = None
                lib.hla_project_fill.argtypes = (
                    [vp] * 6 + [i64] + [vp] * 3 + [i64, i64] + [vp] * 5
                    + [f64, f64] + [vp] * 9 + [ctypes.c_int])
                lib.hla_graph_extend.restype = i64
                lib.hla_graph_extend.argtypes = (
                    [vp] * 17 + [i64, i64, vp, i64, i64, i64, i64,
                    ctypes.c_int, i64, i64] + [f64] * 6 + [i64, f64]
                    + [vp] * 3 + [i64, vp, vp])
                lib.hla_pair_ll.restype = None
                lib.hla_pair_ll.argtypes = [vp, i64, i64, vp,
                                            ctypes.c_int]
                lib.hla_pair_ll_f32.restype = None
                lib.hla_pair_ll_f32.argtypes = [vp, i64, i64, vp,
                                                ctypes.c_int]
                lib.hla_cluster_ll_delta.restype = None
                lib.hla_cluster_ll_delta.argtypes = (
                    [vp] * 6 + [i64, i64, i64, i64, vp, vp, ctypes.c_int])
                u64pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))
                lib.hla_kmer_count_build.restype = i64
                lib.hla_kmer_count_build.argtypes = [
                    vp, i64, i64, ctypes.c_int, u64pp, i64pp]
                u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
                i32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))
                lib.hla_parse_prg_nodes.restype = i64
                lib.hla_parse_prg_nodes.argtypes = [
                    vp, i64, ctypes.c_int, i64pp, i64pp, u8pp]
                lib.hla_parse_prg_edges.restype = i64
                lib.hla_parse_prg_edges.argtypes = [
                    vp, i64, ctypes.c_int, i64pp, i64pp, u8pp, i32pp,
                    u8pp, u8pp, i64pp, ctypes.POINTER(i64),
                    u8pp, i64pp, ctypes.POINTER(i64)]
                lib.hla_parse_prg_code.restype = i64
                lib.hla_parse_prg_code.argtypes = [
                    vp, i64, ctypes.c_int, vp, vp, i64,
                    i64pp, i64pp, u8pp, i64pp]
                lib.hla_chain_record.restype = i64
                lib.hla_chain_record.argtypes = (
                    [vp] * 5 + [i64] + [vp, vp, i64] + [vp] * 10)
                lib.hla_build_read_tensors.restype = None
                lib.hla_build_read_tensors.argtypes = (
                    [vp] * 4 + [i64] + [vp] * 7 + [f64, i64, i64,
                    ctypes.c_int, vp, vp, ctypes.c_int])
                lib.hla_repr_double.restype = ctypes.c_int
                lib.hla_repr_double.argtypes = [f64, vp]
                lib.hla_format_pairs.restype = ctypes.c_int
                lib.hla_format_pairs.argtypes = (
                    [vp] * 5 + [i64, vp, vp, i64,
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int])
            except AttributeError:
                # stale previously-built .so missing a newer symbol:
                # treat as unusable and fall back (next candidate or
                # pure Python) instead of crashing available()
                continue
            _LIB = lib
            break
    return _LIB


def available() -> bool:
    return _find_lib() is not None


def default_threads(cap: int = 8) -> int:
    """Worker processes must stay single-threaded (the process pool already
    saturates the cores); serial runs use the machine."""
    if os.environ.get("HLA_LA_IN_WORKER"):
        return 1
    return max(1, min(os.cpu_count() or 1, cap))


def bgzf_inflate_all(data: bytes, n_threads: int = 4) -> bytes | None:
    lib = _find_lib()
    if lib is None:
        return None
    out = ctypes.c_void_p()
    out_len = ctypes.c_int64()
    rc = lib.hla_bgzf_inflate_all(data, len(data), ctypes.byref(out),
                                  ctypes.byref(out_len), n_threads)
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out.value, out_len.value)
    finally:
        lib.hla_free(out)


def bam_parse_packed(record_stream: bytes):
    """Parse a decompressed BAM record stream into packed numpy arrays.
    Returns dict or None when the native lib is unavailable."""
    lib = _find_lib()
    if lib is None:
        return None
    data = np.frombuffer(record_stream, dtype=np.uint8)
    dp = data.ctypes.data_as(ctypes.c_void_p)
    tn = ctypes.c_int64()
    ts = ctypes.c_int64()
    tc = ctypes.c_int64()
    n = lib.hla_bam_count(dp, len(data), ctypes.byref(tn), ctypes.byref(ts),
                          ctypes.byref(tc))
    if n < 0:
        return None
    n = int(n)
    arrs = dict(
        ref_id=np.empty(n, np.int32), pos=np.empty(n, np.int32),
        mapq=np.empty(n, np.uint8), flag=np.empty(n, np.uint16),
        mate_ref_id=np.empty(n, np.int32), mate_pos=np.empty(n, np.int32),
        tlen=np.empty(n, np.int32),
        name_off=np.empty(n + 1, np.int64),
        name_buf=np.empty(int(tn.value), np.uint8),
        seq_off=np.empty(n + 1, np.int64),
        seq_buf=np.empty(int(ts.value), np.uint8),
        qual_buf=np.empty(int(ts.value), np.uint8),
        cigar_off=np.empty(n + 1, np.int64),
        cigar_buf=np.empty(int(tc.value), np.uint32),
    )
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    got = lib.hla_bam_parse(
        dp, len(data), c(arrs["ref_id"]), c(arrs["pos"]), c(arrs["mapq"]),
        c(arrs["flag"]), c(arrs["mate_ref_id"]), c(arrs["mate_pos"]),
        c(arrs["tlen"]), c(arrs["name_off"]), c(arrs["name_buf"]),
        c(arrs["seq_off"]), c(arrs["seq_buf"]), c(arrs["qual_buf"]),
        c(arrs["cigar_off"]), c(arrs["cigar_buf"]))
    arrs["n"] = int(got)
    return arrs


def scratch_array(scratch: dict | None, key: str, shape,
                  dtype) -> np.ndarray:
    """Reused buffer from a caller-owned pool (NOT zeroed).  Fresh 100MB+
    allocations per call intermittently cost seconds of page-fault stime
    on shared VMs (first-touch after free/re-mmap churn) — hot callers
    pass a dict that persists across calls; scratch=None allocates fresh
    (callers that retain results across calls MUST use None)."""
    n = 1
    for s in shape:
        n *= int(s)
    if scratch is None:
        return np.empty(shape, dtype=dtype)
    buf = scratch.get(key)
    if buf is None or buf.dtype != np.dtype(dtype) or buf.size < n:
        buf = np.empty(max(n, 1), dtype=dtype)
        scratch[key] = buf
    return buf[:n].reshape(shape)


def nw_forward(reads: np.ndarray, lens: np.ndarray, refs: np.ndarray,
               match: float, mismatch: float, gap_open: float,
               gap_extend: float, n_threads: int | None = None,
               scratch: dict | None = None):
    """C++ banded NW forward (exact port of banded_nw_forward).  Returns
    (scores, end_k, end_state, pointers) or None if the lib is missing.
    scratch: optional pool — the pointer tensor is ~150 MB at production
    batch sizes and dominated wrapper time when freshly allocated."""
    lib = _find_lib()
    if lib is None:
        return None
    B, L = reads.shape
    W = refs.shape[1] - L
    reads_c = np.ascontiguousarray(reads, dtype=np.uint8)
    refs_c = np.ascontiguousarray(refs, dtype=np.uint8)
    lens_c = np.ascontiguousarray(lens, dtype=np.int64)
    scores = scratch_array(scratch, "nw_scores", (B,), np.float32)
    end_k = scratch_array(scratch, "nw_end_k", (B,), np.int32)
    end_state = scratch_array(scratch, "nw_end_state", (B,), np.int32)
    pointers = scratch_array(scratch, "nw_pointers", (B, L + 1, W),
                             np.uint8)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.hla_nw_forward(c(reads_c), c(lens_c), c(refs_c), B, L, W,
                       match, mismatch, gap_open, gap_extend,
                       c(scores), c(end_k), c(end_state), c(pointers),
                       default_threads() if n_threads is None else n_threads)
    return scores, end_k, end_state, pointers


def seed_chain(cat: np.ndarray,
               sorted_codes: np.ndarray, sorted_pos: np.ndarray,
               max_occ: int, seq_offsets: np.ndarray,
               prefix_starts: np.ndarray | None = None,
               prefix_bits: int = 0, *,
               slot_offsets: np.ndarray, slot_to_read: np.ndarray | None,
               n_reads: int, slack: int, min_chain: int, k: int,
               stride: int = 1):
    """C++ k-mer encode + index query + diagonal chaining (hla_seed_chain;
    semantics of encode_kmers + KmerIndex.query_codes + Seeder group stats).
    Returns (read, seq, ref_start, n_kmers, span) int64 arrays or None."""
    lib = _find_lib()
    if lib is None:
        return None
    cd = np.ascontiguousarray(cat, dtype=np.uint8)
    sc = np.ascontiguousarray(sorted_codes, dtype=np.uint64)
    sp = np.ascontiguousarray(sorted_pos, dtype=np.int64)
    so = np.ascontiguousarray(seq_offsets, dtype=np.int64)
    sl = np.ascontiguousarray(slot_offsets, dtype=np.int64)
    s2r = (np.ascontiguousarray(slot_to_read, dtype=np.int64)
           if slot_to_read is not None else None)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    outs = [ctypes.POINTER(ctypes.c_int64)() for _ in range(5)]
    ps = (np.ascontiguousarray(prefix_starts, dtype=np.int64)
          if prefix_starts is not None else None)
    ng = lib.hla_seed_chain(
        c(cd), len(cd), c(sc), c(sp), len(sc),
        c(ps) if ps is not None else None,
        prefix_bits if ps is not None else 0, max_occ,
        c(so), len(so) - 1, c(sl), len(sl) - 1,
        c(s2r) if s2r is not None else None,
        n_reads, slack, min_chain, k, stride,
        *[ctypes.byref(o) for o in outs])
    ng = int(ng)
    if ng == 0:
        res = tuple(np.zeros(0, dtype=np.int64) for _ in range(5))
    else:
        res = tuple(np.ctypeslib.as_array(o, shape=(ng,)).copy()
                    for o in outs)
    for o in outs:
        if o:
            lib.hla_free(ctypes.cast(o, ctypes.c_void_p))
    return res


def select_pairs(n1: np.ndarray, n2: np.ndarray, ll: np.ndarray,
                 f_lv: np.ndarray, l_lv: np.ndarray, lv2: np.ndarray,
                 rev: np.ndarray, key_off: np.ndarray, keys: np.ndarray,
                 tr_cat: np.ndarray, tr_off: np.ndarray,
                 insert_mean: float, insert_sd: float, max_pen_log: float):
    """C++ pair-combination selection (hla_select_pairs; semantics of
    aligner._select_pair).  Returns (b1, b2, pair_mapq, mapq1, mapq2,
    conf-flat) or None when the lib is unavailable."""
    lib = _find_lib()
    if lib is None:
        return None
    P = len(n1)
    a64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)
    af = lambda a: np.ascontiguousarray(a, dtype=np.float64)
    n1c, n2c = a64(n1), a64(n2)
    llc, flc, llc2 = af(ll), a64(f_lv), a64(l_lv)
    lv2c = a64(lv2)
    revc = np.ascontiguousarray(rev, dtype=np.uint8)
    koc, kc = a64(key_off), a64(keys)
    tcc, toc = a64(tr_cat), a64(tr_off)
    b1 = np.empty(P, dtype=np.int64)
    b2 = np.empty(P, dtype=np.int64)
    pm = np.empty(P, dtype=np.float64)
    m1 = np.empty(P, dtype=np.float64)
    m2 = np.empty(P, dtype=np.float64)
    conf = np.zeros(len(kc), dtype=np.float64)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.hla_select_pairs(P, c(n1c), c(n2c), c(llc), c(flc), c(llc2),
                         c(lv2c), c(revc), c(koc), c(kc), c(tcc), c(toc),
                         len(toc) - 1, float(insert_mean), float(insert_sd),
                         float(max_pen_log),
                         c(b1), c(b2), c(pm), c(m1), c(m2), c(conf))
    return b1, b2, pm, m1, m2, conf


def itf8_decode_all(buf: bytes, offset: int = 0
                    ) -> tuple[np.ndarray, np.ndarray] | None:
    """Decode every ITF8 value from buf[offset:]: (values, end_offsets)
    where end_offsets are absolute positions after each value.  None when
    the lib is unavailable."""
    lib = _find_lib()
    if lib is None:
        return None
    n = len(buf) - offset
    if n <= 0:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
    vals = np.empty(n, dtype=np.int64)
    ends = np.empty(n, dtype=np.int64)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    bb = np.frombuffer(buf, dtype=np.uint8)[offset:]
    bb = np.ascontiguousarray(bb)
    cnt = lib.hla_itf8_decode_all(c(bb), n, c(vals), c(ends))
    return vals[:cnt], ends[:cnt] + offset


def ransnx16_decode(comp: bytes, pos: int, n_out: int, n_states: int,
                    order: int, shift: int,
                    freqs: np.ndarray) -> bytes | None:
    """C++ rANS Nx16 payload decode (CRAM 3.1 method 5; the symbol stream
    after the Python layer has parsed tables/transforms) or None."""
    lib = _find_lib()
    if lib is None:
        return None
    freqs_c = np.ascontiguousarray(freqs, dtype=np.int64)
    out = np.empty(max(n_out, 1), dtype=np.uint8)
    rc = lib.hla_ransnx16_decode(
        comp, len(comp), pos, n_out, n_states, order, shift,
        freqs_c.ctypes.data_as(ctypes.c_void_p), freqs_c.shape[0],
        out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        return None
    return out[:n_out].tobytes()


def arith_decode(blob: bytes, pos: int, n_out: int, order1: int,
                 rle: int) -> bytes | None:
    """C++ adaptive-arithmetic payload decode (CRAM 3.1 method 6; the
    range-coded stream after the Python layer has parsed the format byte
    and transforms) or None."""
    lib = _find_lib()
    if lib is None:
        return None
    out = np.empty(max(n_out, 1), dtype=np.uint8)
    rc = lib.hla_arith_decode(blob, len(blob), pos,
                              out.ctypes.data_as(ctypes.c_void_p), n_out,
                              order1, rle)
    if rc != 0:
        return None
    return out[:n_out].tobytes()


def ransnx16_encode(arr: np.ndarray, freqs: np.ndarray, cums: np.ndarray,
                    n_states: int, ctx: np.ndarray | None,
                    shift: int) -> bytes | None:
    """C++ rANS Nx16 payload encode (byte-identical to the Python
    encoder) or None."""
    lib = _find_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    f = np.ascontiguousarray(freqs, dtype=np.int64)
    c = np.ascontiguousarray(cums, dtype=np.int64)
    cap = 2 * len(a) + 16 * n_states + 64
    out = np.empty(cap, dtype=np.uint8)
    ctx_p = None
    if ctx is not None:
        ctx_a = np.ascontiguousarray(ctx, dtype=np.uint8)
        ctx_p = ctx_a.ctypes.data_as(ctypes.c_void_p)
    n = lib.hla_ransnx16_encode(
        a.ctypes.data_as(ctypes.c_void_p), len(a),
        f.ctypes.data_as(ctypes.c_void_p),
        c.ctypes.data_as(ctypes.c_void_p), n_states, ctx_p, shift,
        out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def arith_encode(data: bytes, order1: int, rle: int) -> bytes | None:
    """C++ adaptive-arithmetic payload encode (byte-identical to the
    Python encoder) or None."""
    lib = _find_lib()
    if lib is None:
        return None
    cap = 3 * len(data) + 64
    out = np.empty(cap, dtype=np.uint8)
    n = lib.hla_arith_encode(data, len(data), order1, rle,
                             out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def fqz_encode(codes_cat: np.ndarray, lens, sels, revs, dups, nparam: int,
               gflags: int, pm: np.ndarray, qtab: np.ndarray,
               ptab: np.ndarray, dtab: np.ndarray,
               stab: np.ndarray) -> bytes | None:
    """C++ fqzcomp coded-stream encode (byte-identical to the Python
    encoder) or None."""
    lib = _find_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes_cat, dtype=np.uint8)
    lens_a = np.ascontiguousarray(lens, dtype=np.int64)
    n_rec = len(lens_a)
    sels_a = (np.ascontiguousarray(sels, dtype=np.uint8)
              if sels is not None else np.zeros(n_rec, dtype=np.uint8))
    revs_a = (np.asarray(revs, dtype=bool).astype(np.uint8)
              if revs is not None else np.zeros(n_rec, dtype=np.uint8))
    dups_a = np.ascontiguousarray(dups, dtype=np.uint8)
    tabs = [np.ascontiguousarray(a, dtype=np.int32)
            for a in (pm, qtab, ptab, dtab, stab)]
    cap = 3 * len(codes) + 16 * n_rec + 64
    out = np.empty(cap, dtype=np.uint8)
    n = lib.hla_fqz_encode(
        codes.ctypes.data_as(ctypes.c_void_p), len(codes),
        lens_a.ctypes.data_as(ctypes.c_void_p), n_rec,
        sels_a.ctypes.data_as(ctypes.c_void_p),
        revs_a.ctypes.data_as(ctypes.c_void_p),
        dups_a.ctypes.data_as(ctypes.c_void_p),
        nparam, gflags,
        *[a.ctypes.data_as(ctypes.c_void_p) for a in tabs],
        out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def fqz_decode(blob: bytes, pos: int, n_out: int, nparam: int, gflags: int,
               pm: np.ndarray, qmap: np.ndarray, qtab: np.ndarray,
               ptab: np.ndarray, dtab: np.ndarray,
               stab: np.ndarray) -> bytes | None:
    """C++ fqzcomp coded-stream decode (CRAM 3.1 method 7; the record loop
    after the Python layer has parsed the parameter block) or None.  Raises
    ValueError on a corrupt stream the C++ side detects (overflowing
    record, bad selector) so the caller reports it instead of falling back
    to an equally-doomed Python decode."""
    lib = _find_lib()
    if lib is None:
        return None
    arrs = [np.ascontiguousarray(a, dtype=np.int32)
            for a in (pm, qmap, qtab, ptab, dtab, stab)]
    out = np.empty(max(n_out, 1), dtype=np.uint8)
    rc = lib.hla_fqz_decode(
        blob, len(blob), pos, out.ctypes.data_as(ctypes.c_void_p), n_out,
        nparam, gflags,
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrs])
    if rc == -1:
        return None               # implausible header: let Python decide
    if rc != 0:
        raise ValueError(f"fqzcomp: corrupt coded stream (native rc {rc})")
    return out[:n_out].tobytes()


def rans4x8_decode(blob: bytes) -> bytes | None:
    """C++ rANS 4x8 block decode (CRAM method 4) or None on failure/
    unavailable lib."""
    lib = _find_lib()
    if lib is None or len(blob) < 9:
        return None
    import struct
    n_out = struct.unpack_from("<I", blob, 5)[0]
    out = np.empty(max(n_out, 1), dtype=np.uint8)
    rc = lib.hla_rans4x8_decode(blob, len(blob),
                                out.ctypes.data_as(ctypes.c_void_p), n_out)
    if rc != 0:
        return None
    return out[:n_out].tobytes()


def encode_kmers(seq_bytes: np.ndarray, k: int, canonical: bool = False
                 ) -> tuple[np.ndarray, np.ndarray] | None:
    """C++ rolling k-mer encode (kmer_index.encode_kmers semantics;
    canonical=True returns min(code, revcomp code)) or None when the lib
    is unavailable."""
    lib = _find_lib()
    if lib is None:
        return None
    n = len(seq_bytes)
    n_out = n - k + 1
    if n_out <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    sb = np.ascontiguousarray(seq_bytes, dtype=np.uint8)
    out = np.empty(n_out, dtype=np.uint64)
    valid = np.empty(n_out, dtype=np.uint8)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.hla_encode_kmers_c(c(sb), n, k, c(out), c(valid), default_threads(),
                           1 if canonical else 0)
    return out, valid.astype(bool)


def _take_free(lib, ptr, n, ctype, dtype):
    """Copy a malloc'd C array into numpy and free it."""
    try:
        if n == 0:
            return np.zeros(0, dtype=dtype)
        return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype,
                                                             copy=True)
    finally:
        if ptr:
            lib.hla_free(ctypes.cast(ptr, ctypes.c_void_p))


def parse_prg_nodes(sec: bytes):
    """C++ NODES-section parse -> (orig, level, terminal) arrays, or None
    (unavailable / malformed: caller falls back to the python parsers)."""
    lib = _find_lib()
    if lib is None:
        return None
    o = ctypes.POINTER(ctypes.c_int64)()
    lv = ctypes.POINTER(ctypes.c_int64)()
    tm = ctypes.POINTER(ctypes.c_uint8)()
    n = int(lib.hla_parse_prg_nodes(sec, len(sec), default_threads(),
                                    ctypes.byref(o), ctypes.byref(lv),
                                    ctypes.byref(tm)))
    if n < 0:
        return None
    return (_take_free(lib, o, n, ctypes.c_int64, np.int64),
            _take_free(lib, lv, n, ctypes.c_int64, np.int64),
            _take_free(lib, tm, n, ctypes.c_uint8, np.uint8))


def parse_prg_edges(sec: bytes):
    """C++ EDGES-section parse -> (from, to, cc, locus_id, pgf, labels,
    locus_names) with labels/locus_names as python lists, or None."""
    lib = _find_lib()
    if lib is None:
        return None
    fr = ctypes.POINTER(ctypes.c_int64)()
    to = ctypes.POINTER(ctypes.c_int64)()
    cc = ctypes.POINTER(ctypes.c_uint8)()
    lc = ctypes.POINTER(ctypes.c_int32)()
    pg = ctypes.POINTER(ctypes.c_uint8)()
    lab_b = ctypes.POINTER(ctypes.c_uint8)()
    lab_o = ctypes.POINTER(ctypes.c_int64)()
    lab_n = ctypes.c_int64()
    loc_b = ctypes.POINTER(ctypes.c_uint8)()
    loc_o = ctypes.POINTER(ctypes.c_int64)()
    loc_n = ctypes.c_int64()
    n = int(lib.hla_parse_prg_edges(
        sec, len(sec), default_threads(),
        ctypes.byref(fr), ctypes.byref(to), ctypes.byref(cc),
        ctypes.byref(lc), ctypes.byref(pg),
        ctypes.byref(lab_b), ctypes.byref(lab_o), ctypes.byref(lab_n),
        ctypes.byref(loc_b), ctypes.byref(loc_o), ctypes.byref(loc_n)))
    if n < 0:
        return None
    fr_a = _take_free(lib, fr, n, ctypes.c_int64, np.int64)
    to_a = _take_free(lib, to, n, ctypes.c_int64, np.int64)
    cc_a = _take_free(lib, cc, n, ctypes.c_uint8, np.uint8)
    lc_a = _take_free(lib, lc, n, ctypes.c_int32, np.int32)
    pg_a = _take_free(lib, pg, n, ctypes.c_uint8, np.uint8)
    lab_off = _take_free(lib, lab_o, n + 1, ctypes.c_int64, np.int64)
    lab_blob = _take_free(lib, lab_b, int(lab_n.value), ctypes.c_uint8,
                          np.uint8).tobytes()
    loc_off = _take_free(lib, loc_o, int(loc_n.value) + 1, ctypes.c_int64,
                         np.int64)
    loc_blob = _take_free(lib, loc_b, int(loc_off[-1]), ctypes.c_uint8,
                          np.uint8).tobytes()
    if lab_off[-1] == 0:
        labels = [""] * n
    else:
        lo_l = lab_off.tolist()
        labels = [""] * n
        for i in np.nonzero(np.diff(lab_off))[0].tolist():
            labels[i] = lab_blob[lo_l[i]:lo_l[i + 1]].decode()
    lo2 = loc_off.tolist()
    if loc_blob.isascii():
        s_blob = loc_blob.decode()
        locus_names = [s_blob[lo2[i]:lo2[i + 1]]
                       for i in range(int(loc_n.value))]
    else:
        locus_names = [loc_blob[lo2[i]:lo2[i + 1]].decode()
                       for i in range(int(loc_n.value))]
    return (fr_a, to_a, cc_a, lc_a, pg_a, labels, locus_names,
            loc_blob, loc_off)


def parse_prg_code(sec: bytes, loc_blob: bytes, loc_off: np.ndarray):
    """C++ CODE-section parse against the edge locus table ->
    (locus_file_id [-1 = unknown], code, allele_first_byte, allele_len)
    arrays, or None (unavailable / malformed)."""
    lib = _find_lib()
    if lib is None:
        return None
    off = np.ascontiguousarray(loc_off, dtype=np.int64)
    fid = ctypes.POINTER(ctypes.c_int64)()
    cd = ctypes.POINTER(ctypes.c_int64)()
    a0 = ctypes.POINTER(ctypes.c_uint8)()
    al = ctypes.POINTER(ctypes.c_int64)()
    n = int(lib.hla_parse_prg_code(
        sec, len(sec), default_threads(), loc_blob,
        off.ctypes.data_as(ctypes.c_void_p), len(off) - 1,
        ctypes.byref(fid), ctypes.byref(cd), ctypes.byref(a0),
        ctypes.byref(al)))
    if n < 0:
        return None
    return (_take_free(lib, fid, n, ctypes.c_int64, np.int64),
            _take_free(lib, cd, n, ctypes.c_int64, np.int64),
            _take_free(lib, a0, n, ctypes.c_uint8, np.uint8),
            _take_free(lib, al, n, ctypes.c_int64, np.int64))


def chain_record(seq_c, graph_c, levels, qual, mqp, lut_g, lut_q,
                 qid_empty: int, n_rec: int, scratch: dict | None = None):
    """C++ per-chain record build (hla_chain_record; the column walk of
    typer._chain_records).  Caller guarantees contiguous arrays of the
    right dtypes and n_rec == (levels >= 0).sum().  Returns the record
    arrays + (cols_nongap, ins_record_indices), or None when the lib is
    unavailable or an unseen byte needs interning (python path)."""
    lib = _find_lib()
    if lib is None:
        return None
    n = len(seq_c)
    # one int64 block for the five integer outputs (records retain the
    # views); worst/mqp separate; the 3 tiny outputs reuse scratch
    blk = np.empty(5 * n_rec, np.int64)
    out_levels = blk[:n_rec]
    out_gid = blk[n_rec:2 * n_rec]
    out_qid = blk[2 * n_rec:3 * n_rec]
    out_q0 = blk[3 * n_rec:4 * n_rec]
    out_rn = blk[4 * n_rec:]
    out_worst = np.empty(n_rec, np.uint8)
    out_mqp = np.empty(n_rec, np.float64)
    if scratch is not None:
        small = scratch.get("cr_small")
        if small is None or len(small) < n_rec + 2:
            small = scratch["cr_small"] = np.empty(
                max(n_rec + 2, 256), np.int64)
    else:
        small = np.empty(n_rec + 2, np.int64)
    base = blk.ctypes.data
    r = lib.hla_chain_record(
        seq_c.ctypes.data, graph_c.ctypes.data, levels.ctypes.data,
        qual.ctypes.data,
        mqp.ctypes.data if mqp is not None else None, n,
        lut_g.ctypes.data, lut_q.ctypes.data, qid_empty,
        base, out_worst.ctypes.data,
        base + 8 * n_rec, base + 16 * n_rec, base + 24 * n_rec,
        out_mqp.ctypes.data, base + 32 * n_rec, small.ctypes.data,
        small.ctypes.data + 16, small.ctypes.data + 8)
    if r < 0:
        return None
    assert r == n_rec, (r, n_rec)
    return (out_levels, out_worst, out_gid, out_qid, out_q0, out_mqp,
            out_rn, int(small[0]), small[2:2 + int(small[1])])


def build_read_tensors(r_idx, j_idx, gid, q0, gap_tbl, chf_tbl, sing_tbl,
                       tail_tbl, chgap_tbl, vmatch_q, vmis_q,
                       log_del: float, R: int, J: int, transposed: bool,
                       contrib: np.ndarray, mismatch: np.ndarray) -> bool:
    """C++ per-observation channel-cell writer (hla_build_read_tensors;
    bit-identical to typer._build_read_tensors' numpy scatter).  Writes
    into the caller's zeroed contrib/mismatch; returns False when the lib
    is unavailable."""
    lib = _find_lib()
    if lib is None:
        return False
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    args = [np.ascontiguousarray(r_idx, dtype=np.int64),
            np.ascontiguousarray(j_idx, dtype=np.int64),
            np.ascontiguousarray(gid, dtype=np.int64),
            np.ascontiguousarray(q0, dtype=np.uint8)]
    tbls = [np.ascontiguousarray(gap_tbl, dtype=np.uint8),
            np.ascontiguousarray(chf_tbl, dtype=np.int8),
            np.ascontiguousarray(sing_tbl, dtype=np.uint8),
            np.ascontiguousarray(tail_tbl, dtype=np.float64),
            np.ascontiguousarray(chgap_tbl, dtype=np.float64),
            np.ascontiguousarray(vmatch_q, dtype=np.float64),
            np.ascontiguousarray(vmis_q, dtype=np.float64)]
    assert contrib.dtype == np.float32 and contrib.flags.c_contiguous
    assert mismatch.dtype == np.float32 and mismatch.flags.c_contiguous
    lib.hla_build_read_tensors(
        *[c(a) for a in args], len(args[0]), *[c(a) for a in tbls],
        float(log_del), R, J, 1 if transposed else 0,
        c(contrib), c(mismatch), default_threads())
    return True


def kmer_count_build(seq_bytes: np.ndarray, k: int
                     ) -> tuple[np.ndarray, np.ndarray] | None:
    """C++ canonical k-mer count index build (hla_kmer_count_build):
    sorted unique canonical codes + counts, identical to
    sort+run-length-count of the canonical encode_kmers output
    (typer.KmerCountIndex.build semantics).  None when unavailable."""
    lib = _find_lib()
    if lib is None or k > 32:   # 2-bit codes pack into uint64
        return None
    sb = np.ascontiguousarray(seq_bytes, dtype=np.uint8)
    oc = ctypes.POINTER(ctypes.c_uint64)()
    on = ctypes.POINTER(ctypes.c_int64)()
    nu = int(lib.hla_kmer_count_build(
        sb.ctypes.data_as(ctypes.c_void_p), len(sb), k, default_threads(),
        ctypes.byref(oc), ctypes.byref(on)))
    if nu < 0:
        return None
    if nu == 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.int64)
    try:
        codes = np.ctypeslib.as_array(oc, shape=(nu,)).copy()
        counts = np.ctypeslib.as_array(on, shape=(nu,)).copy()
    finally:
        lib.hla_free(ctypes.cast(oc, ctypes.c_void_p))
        lib.hla_free(ctypes.cast(on, ctypes.c_void_p))
    return codes, counts


def gather_windows(enc_cat: np.ndarray, hap_offsets: np.ndarray,
                   hap_lens: np.ndarray, job_seq: np.ndarray,
                   win_start: np.ndarray, w: int) -> np.ndarray | None:
    """C++ reference-window gather ([nb, w] uint8, pad code 4) or None."""
    lib = _find_lib()
    if lib is None:
        return None
    nb = len(job_seq)
    out = np.empty((nb, w), dtype=np.uint8)
    ec = np.ascontiguousarray(enc_cat, dtype=np.uint8)
    # converted arrays MUST be bound to locals for the duration of the
    # call: c_void_p does not keep the numpy temporary alive, so
    # c(ascontiguousarray(x)) would hand the C code a freed pointer
    # whenever the conversion copies
    ho = np.ascontiguousarray(hap_offsets, dtype=np.int64)
    hl = np.ascontiguousarray(hap_lens, dtype=np.int64)
    js = np.ascontiguousarray(job_seq, dtype=np.int64)
    ws = np.ascontiguousarray(win_start, dtype=np.int64)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.hla_gather_windows(c(ec), c(ho), c(hl), c(js), c(ws), nb, w,
                           c(out), default_threads())
    return out


def walk_haplotype(cprg, row: np.ndarray, lv_lo: int = 0,
                   lv_hi: int | None = None):
    """C++ haplotype walk (hla_walk_haplotype; graph_fallback.walk_haplotype
    semantics).  row: [lv_hi - lv_lo] uint8 wanted emissions, WINDOW-LOCAL
    (row[i] = emission at level lv_lo+i).  Returns the node path over
    levels [lv_lo, lv_hi] (default: whole graph) or None (no path / lib
    unavailable)."""
    lib = _find_lib()
    if lib is None:
        return None
    if lv_hi is None:
        lv_hi = cprg.n_levels - 1
    lo = np.ascontiguousarray(cprg.level_offsets, dtype=np.int64)
    oo = np.ascontiguousarray(cprg.out_offsets, dtype=np.int64)
    oe = np.ascontiguousarray(cprg.out_edges, dtype=np.int32)
    io_ = np.ascontiguousarray(cprg.in_offsets, dtype=np.int64)
    ie = np.ascontiguousarray(cprg.in_edges, dtype=np.int32)
    ef = np.ascontiguousarray(cprg.edge_from, dtype=np.int32)
    et = np.ascontiguousarray(cprg.edge_to, dtype=np.int32)
    em = np.ascontiguousarray(cprg.edge_emission, dtype=np.uint8)
    rw = np.ascontiguousarray(row, dtype=np.uint8)
    path = np.empty(lv_hi - lv_lo + 1, dtype=np.int64)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    ok = lib.hla_walk_haplotype(c(lo), cprg.n_levels, c(oo), c(oe),
                                c(io_), c(ie), c(ef), c(et), c(em), c(rw),
                                len(cprg.node_level), int(lv_lo), int(lv_hi),
                                c(path))
    return path if ok else None


def graph_extend(cprg, sequence: str, start_seq: int, start_level: int,
                 start_z: int, positive: bool, lim_level: int, lim_seq: int,
                 sc):
    """C++ graph-space extension DP (hla_graph_extend; the exact
    extend_graph_dp semantics incl. tie-breaking).  Returns
    (graph_chars, levels, seq_chars, score, end_level, end_seq, end_z),
    False when the DP found no positive-score extension, or None when the
    lib is unavailable / the problem doesn't fit (caller falls back)."""
    lib = _find_lib()
    if lib is None:
        return None
    arrs = getattr(cprg, "_gx_arrays", None)
    if arrs is None:
        arrs = tuple(np.ascontiguousarray(a, dtype=d) for a, d in (
            (cprg.level_offsets, np.int64),
            (cprg.node_level, np.int32), (cprg.node_z, np.int32),
            (cprg.edge_from, np.int32), (cprg.edge_to, np.int32),
            (cprg.edge_emission, np.uint8),
            (cprg.out_offsets, np.int64), (cprg.out_edges, np.int32),
            (cprg.in_offsets, np.int64), (cprg.in_edges, np.int32),
            (cprg.jump_from, np.int32), (cprg.jump_to, np.int32),
            (cprg.jump_len, np.int32),
            (cprg.jump_out_offsets, np.int64), (cprg.jump_out, np.int32),
            (cprg.jump_in_offsets, np.int64), (cprg.jump_in, np.int32)))
        cprg._gx_arrays = arrs
        cprg._gx_zmul = int(np.max(np.diff(arrs[0]))) + 1
        # cached ctypes pointers: arrs is pinned on cprg for its lifetime,
        # so the 17 data_as conversions per call are pure overhead
        cprg._gx_ptrs = tuple(
            a.ctypes.data_as(ctypes.c_void_p) for a in arrs)
        cprg._gx_scratch = {}
    zmul = cprg._gx_zmul
    seq_b = np.frombuffer(sequence.encode(), dtype=np.uint8)
    # 64-bit cell-key capacity check (x * (len+2) * zmul must fit)
    if (cprg.n_levels + 1) * (len(seq_b) + 2) * zmul >= (1 << 62):
        return None
    cap = abs(int(lim_level) - int(start_level)) \
        + abs(int(lim_seq) - int(start_seq)) + 8
    scr = cprg._gx_scratch
    if scr.get("cap", -1) < cap:
        scr["cap"] = cap
        scr["g"] = np.empty(cap, dtype=np.uint8)
        scr["s"] = np.empty(cap, dtype=np.uint8)
        scr["l"] = np.empty(cap, dtype=np.int64)
        scr["end"] = np.empty(3, dtype=np.int64)
    out_g, out_s, out_l, out_end = scr["g"], scr["s"], scr["l"], scr["end"]
    out_score = ctypes.c_double()
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    n = lib.hla_graph_extend(
        *cprg._gx_ptrs, cprg.n_levels, zmul,
        c(seq_b), len(seq_b), int(start_seq), int(start_level),
        int(start_z), 1 if positive else 0, int(lim_level), int(lim_seq),
        float(sc.match), float(sc.mismatch), float(sc.open_gap),
        float(sc.extend_gap), float(sc.graph_gap),
        float(sc.diagonal_filter), int(sc.max_nonincrease_diagonals),
        float(sc.stop_threshold),
        c(out_g), c(out_s), c(out_l), cap,
        ctypes.byref(out_score), c(out_end))
    if n == -1:
        return False
    if n < 0:
        return None
    return (out_g[:n].tobytes().decode(), out_l[:n].tolist(),
            out_s[:n].tobytes().decode(), float(out_score.value),
            int(out_end[0]), int(out_end[1]), int(out_end[2]))


def seed_select(read_of: np.ndarray, seq_idx: np.ndarray,
                reverse: np.ndarray, ref_start: np.ndarray,
                n_kmers: np.ndarray, span: np.ndarray, n_reads: int,
                max_cands: int, slack2: int):
    """C++ greedy top-candidate selection (seeder.py:_select semantics).
    Returns (out_idx [n_reads, max_cands] group indices, out_counts) or
    None when the lib is unavailable."""
    lib = _find_lib()
    if lib is None:
        return None
    n = len(read_of)
    a64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)
    rv = np.ascontiguousarray(reverse, dtype=np.uint8)
    out_idx = np.zeros((n_reads, max_cands), dtype=np.int64)
    out_counts = np.zeros(n_reads, dtype=np.int64)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    args = [a64(read_of), a64(seq_idx), rv, a64(ref_start), a64(n_kmers),
            a64(span)]
    lib.hla_seed_select(*(c(a) for a in args), n, n_reads, max_cands,
                        slack2, c(out_idx), c(out_counts))
    return out_idx, out_counts


def project_score_batch(ops: np.ndarray, n_ops: np.ndarray,
                        job_seq: np.ndarray, window_start: np.ndarray,
                        reads_ascii: np.ndarray, quals_ascii: np.ndarray,
                        hap_codes_cat: np.ndarray, hap_levels_cat: np.ndarray,
                        hap_offsets: np.ndarray, hap_lens: np.ndarray,
                        reverse: np.ndarray,
                        log_match_tab: np.ndarray, log_mismatch_tab: np.ndarray,
                        log_ins: float, log_del: float,
                        n_threads: int | None = None):
    """Two-pass C++ projection+scoring (see hla_project_count/fill in
    native/hla_native.cpp; semantics of alignment.py:project_and_score_batch).

    Returns (levels, graph_c, seq_c, qual_c, pos_keys, col_counts,
    col_starts, ll, first_lv, last_lv, lv2 [B,4], bad) or None when the
    lib is unavailable."""
    lib = _find_lib()
    if lib is None:
        return None
    B, max_ops, _ = ops.shape
    Lr = reads_ascii.shape[1]
    ops_c = np.ascontiguousarray(ops, dtype=np.int32)
    n_ops_c = np.ascontiguousarray(n_ops, dtype=np.int64)
    seq_c_ = np.ascontiguousarray(job_seq, dtype=np.int64)
    ws_c = np.ascontiguousarray(window_start, dtype=np.int64)
    reads_c = np.ascontiguousarray(reads_ascii, dtype=np.uint8)
    quals_c = np.ascontiguousarray(quals_ascii, dtype=np.uint8)
    hc_c = np.ascontiguousarray(hap_codes_cat, dtype=np.uint8)
    hl_c = np.ascontiguousarray(hap_levels_cat, dtype=np.int64)
    ho_c = np.ascontiguousarray(hap_offsets, dtype=np.int64)
    hn_c = np.ascontiguousarray(hap_lens, dtype=np.int64)
    lmt = np.ascontiguousarray(log_match_tab, dtype=np.float64)
    lmm = np.ascontiguousarray(log_mismatch_tab, dtype=np.float64)
    col_counts = np.empty(B, dtype=np.int64)
    bad = np.empty(B, dtype=np.uint8)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    total = lib.hla_project_count(c(ops_c), c(n_ops_c), c(seq_c_), c(ws_c),
                                  c(hl_c), c(ho_c), c(hn_c), B, max_ops,
                                  c(col_counts), c(bad))
    col_starts = np.concatenate([[0], np.cumsum(col_counts)])[:-1]
    col_starts = np.ascontiguousarray(col_starts, dtype=np.int64)
    rv_c = np.ascontiguousarray(reverse, dtype=np.uint8)
    levels = np.empty(int(total), dtype=np.int64)
    graph_c = np.empty(int(total), dtype=np.uint8)
    seq_col = np.empty(int(total), dtype=np.uint8)
    qual_col = np.empty(int(total), dtype=np.uint8)
    pos_keys = np.empty(int(total), dtype=np.int64)
    ll = np.empty(B, dtype=np.float64)
    first_lv = np.empty(B, dtype=np.int64)
    last_lv = np.empty(B, dtype=np.int64)
    lv2 = np.empty((B, 4), dtype=np.int64)
    lib.hla_project_fill(c(ops_c), c(n_ops_c), c(seq_c_), c(ws_c),
                         c(reads_c), c(quals_c), Lr,
                         c(hc_c), c(hl_c), c(ho_c), B, max_ops,
                         c(col_starts), c(bad), c(rv_c), c(lmt), c(lmm),
                         float(log_ins), float(log_del),
                         c(levels), c(graph_c), c(seq_col), c(qual_col),
                         c(pos_keys), c(ll), c(first_lv), c(last_lv),
                         c(lv2),
                         default_threads() if n_threads is None else n_threads)
    return (levels, graph_c, seq_col, qual_col, pos_keys, col_counts,
            col_starts, ll, first_lv, last_lv, lv2, bad)


def nw_backtrace_batch(pointers: np.ndarray, lens: np.ndarray,
                       end_k: np.ndarray, end_state: np.ndarray,
                       scratch: dict | None = None
                       ) -> tuple[np.ndarray, np.ndarray] | None:
    """Batched backtrace: returns (ops [B, max_ops, 3] int32, n_ops [B]).
    Only ops[b, :n_ops[b]] are written (the tail is uninitialised when a
    scratch pool is passed)."""
    lib = _find_lib()
    if lib is None:
        return None
    B, Lp1, W = pointers.shape
    L = Lp1 - 1
    max_ops = 2 * L + W
    pointers = np.ascontiguousarray(pointers, dtype=np.uint8)
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    ek = np.ascontiguousarray(end_k, dtype=np.int32)
    es = np.ascontiguousarray(end_state, dtype=np.int32)
    if scratch is None:        # legacy zeroed tails (lazy calloc pages)
        out_ops = np.zeros((B, max_ops, 3), dtype=np.int32)
        out_n = np.zeros(B, dtype=np.int32)
    else:
        out_ops = scratch_array(scratch, "bt_ops", (B, max_ops, 3),
                                np.int32)
        out_n = scratch_array(scratch, "bt_n", (B,), np.int32)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.hla_nw_backtrace_batch(c(pointers), B, L, W, c(lens64), c(ek), c(es),
                               c(out_ops), max_ops, c(out_n))
    return out_ops, out_n


def pair_ll(L: np.ndarray, n_threads: int | None = None
            ) -> np.ndarray | None:
    """C^2 diploid pair reduction (hla_pair_ll; HLATyper.cpp:2280-2364):
    out[c1,c2] = sum_r logavg(L[c1,r], L[c2,r]).  AVX-512 tiled kernel
    with f64 |a-b| accumulation and an f32 softplus tail (skipped when
    every lane is past the 17.0 cutoff, softplus < 4.2e-8).  Deterministic
    for any thread count (each pair is summed by one thread in fixed
    chunk order)."""
    lib = _find_lib()
    if lib is None:
        return None
    C, R = L.shape
    out = np.empty((C, C), dtype=np.float64)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    nt = default_threads() if n_threads is None else n_threads
    if L.dtype == np.float32:
        # f32 path converts on load in-kernel — bit-identical to the f64
        # path on the converted matrix, minus the ~300 MB up-front copy
        L32 = np.ascontiguousarray(L, dtype=np.float32)
        lib.hla_pair_ll_f32(c(L32), C, R, c(out), nt)
    else:
        L64 = np.ascontiguousarray(L, dtype=np.float64)
        lib.hla_pair_ll(c(L64), C, R, c(out), nt)
    return out


def cluster_ll_delta(contrib_T: np.ndarray, mismatch_T: np.ndarray,
                     base_cols: np.ndarray, plus_cols: np.ndarray,
                     minus_cols: np.ndarray, starts: np.ndarray,
                     n_threads: int | None = None,
                     out_ll: np.ndarray | None = None,
                     out_mm: np.ndarray | None = None
                     ) -> tuple[np.ndarray, np.ndarray] | None:
    """Sparse-delta cluster_read_ll (hla_cluster_ll_delta): LL[c,:] =
    consensus base row + sum over the cluster's differing columns of
    (T[plus]-T[minus]) rows of the transposed [J*6, R] tensors — the
    delta replacement for the dense one-hot sgemm (HLATyper.cpp:
    2089-2277 lowering).  f64 accumulation; deterministic for any
    thread count (each cluster row is built by one thread).

    out_ll/out_mm: optional preallocated [C, R] f32 outputs; may be
    column slices of a wider matrix (row stride is passed through, the
    read axis must be contiguous).  Fresh 100MB+ allocations per call
    intermittently cost seconds of page-fault stime on shared VMs —
    callers should reuse buffers."""
    lib = _find_lib()
    if lib is None:
        return None
    J6, R = contrib_T.shape
    C = len(starts) - 1
    T = np.ascontiguousarray(contrib_T, dtype=np.float32)
    M = np.ascontiguousarray(mismatch_T, dtype=np.float32)
    bc = np.ascontiguousarray(base_cols, dtype=np.int64)
    pc = np.ascontiguousarray(plus_cols, dtype=np.int64)
    mc = np.ascontiguousarray(minus_cols, dtype=np.int64)
    st = np.ascontiguousarray(starts, dtype=np.int64)
    LL = np.empty((C, R), dtype=np.float32) if out_ll is None else out_ll
    MM = np.empty((C, R), dtype=np.float32) if out_mm is None else out_mm
    assert LL.shape == (C, R) and MM.shape == (C, R)
    assert LL.dtype == np.float32 and MM.dtype == np.float32
    # read axis contiguous; identical row stride for both outputs
    assert LL.strides[1] == 4 and MM.strides[1] == 4
    assert LL.strides[0] == MM.strides[0] and LL.strides[0] % 4 == 0
    stride = LL.strides[0] // 4
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    nt = default_threads() if n_threads is None else n_threads
    lib.hla_cluster_ll_delta(c(T), c(M), c(bc), c(pc), c(mc), c(st),
                             C, J6 // 6, R, stride, c(LL), c(MM), nt)
    return LL, MM


def repr_double(v: float) -> str | None:
    """CPython-repr of a double via the native formatter (test surface for
    hla_format_pairs's number layout)."""
    lib = _find_lib()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(40)
    n = lib.hla_repr_double(float(v), ctypes.cast(buf, ctypes.c_void_p))
    return buf.raw[:n].decode()


def format_pairs(a_idx: np.ndarray, b_idx: np.ndarray, P: np.ndarray,
                 LL: np.ndarray, MM: np.ndarray, ids: list[bytes],
                 n_threads: int | None = None) -> bytes | None:
    """Bulk-format the R1_PP_<locus>_pairs.txt body (HLATyper.cpp:2382-2404
    output contract): per line `ids[a]/ids[b]\\tP\\tLL\\tMM\\n` with floats
    in exact CPython repr (byte-parity locked in tests/test_native_parity).
    Returns the whole body as bytes, or None if the lib is missing."""
    lib = _find_lib()
    if lib is None:
        return None
    n = len(P)
    a_c = np.ascontiguousarray(a_idx, dtype=np.int32)
    b_c = np.ascontiguousarray(b_idx, dtype=np.int32)
    P_c = np.ascontiguousarray(P, dtype=np.float64)
    LL_c = np.ascontiguousarray(LL, dtype=np.float64)
    MM_c = np.ascontiguousarray(MM, dtype=np.float64)
    blob = b"".join(ids)
    off = np.zeros(len(ids) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in ids], out=off[1:])
    blob_a = np.frombuffer(blob, dtype=np.uint8) if blob else \
        np.empty(0, np.uint8)
    out = ctypes.c_void_p()
    out_len = ctypes.c_int64()
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    rc = lib.hla_format_pairs(
        c(a_c), c(b_c), c(P_c), c(LL_c), c(MM_c), n,
        c(blob_a), c(off), len(ids), ctypes.byref(out),
        ctypes.byref(out_len),
        default_threads() if n_threads is None else n_threads)
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out.value, out_len.value)
    finally:
        lib.hla_free(out)
