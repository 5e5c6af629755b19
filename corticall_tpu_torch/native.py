"""ctypes binding for the C++ native core (csrc/host/corticall_native.cpp).

Copy of corticall_tpu/native.py over the port's own copy of the C++ source.
Builds the shared library on first use (g++ -O3) into the git-ignored
build/native/ at the repository root; every consumer falls back to the numpy implementation when the
toolchain or the library is unavailable, so the native path is an accelerator,
never a requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "host", "corticall_native.cpp")
_SO = os.path.join(os.path.dirname(_PKG), "build", "native", "corticall_native.so")

_lib = None
_tried = False


def _build() -> bool:
    """Compile the shared library ATOMICALLY: g++ writes to a process-unique
    temp name, then os.replace publishes it.  An fcntl lock serializes
    concurrent builders (two processes racing g++ onto the same output path
    was the only unfenced way a process could dlopen a half-written .so —
    the round-2 silent-kmer-loss suspect)."""
    tmp = f"{_SO}.{os.getpid()}.tmp"
    lock_path = _SO + ".lock"
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    try:
        import fcntl
        lock = open(lock_path, "w")
        fcntl.flock(lock.fileno(), fcntl.LOCK_EX)
    except Exception:
        lock = None
    try:
        # another process may have finished the build while we waited
        if (os.path.exists(_SO) and os.path.exists(_SRC)
                and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
            return True
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, _SO)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    finally:
        if lock is not None:
            lock.close()


def _self_test(lib) -> bool:
    """Validate the loaded code actually computes: count the kmers of a known
    string and check the exact result.  A corrupted .so (partial write,
    interleaved concurrent builds) either fails dlopen or fails here — it
    never silently miscounts a production graph."""
    try:
        lib.ct_count_kmers.restype = ctypes.c_int64
        seq = b"ACGTACGTTTACG"  # k=5 -> 9 windows, known unique count
        offsets = np.array([0, len(seq)], dtype=np.int64)
        hi = ctypes.POINTER(ctypes.c_uint64)()
        lo = ctypes.POINTER(ctypes.c_uint64)()
        cov = ctypes.POINTER(ctypes.c_uint32)()
        im = ctypes.POINTER(ctypes.c_uint8)()
        om = ctypes.POINTER(ctypes.c_uint8)()
        n = lib.ct_count_kmers(
            ctypes.c_char_p(seq),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(1), ctypes.c_int32(5),
            ctypes.byref(hi), ctypes.byref(lo), ctypes.byref(cov),
            ctypes.byref(im), ctypes.byref(om))
        if n <= 0 or n > 9:
            return False
        total = sum(cov[i] for i in range(n))
        for p in (hi, lo, cov, im, om):
            lib.ct_free(p)
        # 9 windows, 7 unique canonicals (ACGTA and CGTAC each appear twice)
        return total == 9 and n == 7
    except Exception:
        return False


_warned_fallback = False


def warn_fallback(reason: str) -> None:
    """One-time loud stderr warning whenever a native consumer silently falls
    back to the numpy path — a fallback must never be invisible again."""
    global _warned_fallback
    if not _warned_fallback:
        _warned_fallback = True
        print(f"[corticall_tpu_torch] WARNING: native core unavailable ({reason}); "
              "using numpy fallback (slower, same results)", file=sys.stderr)


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) or (os.path.exists(_SRC) and
                                   os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        if not _build():
            warn_fallback("build failed")
            return None
    try:
        lib = ctypes.CDLL(_SO)
        lib.ct_free.argtypes = [ctypes.c_void_p]
        if not _self_test(lib):
            # stale or corrupted artifact: rebuild once, atomically, and retry
            try:
                os.unlink(_SO)
            except OSError:
                pass
            if not _build():
                warn_fallback("self-test failed, rebuild failed")
                return None
            lib = ctypes.CDLL(_SO)
            lib.ct_free.argtypes = [ctypes.c_void_p]
            if not _self_test(lib):
                warn_fallback("self-test failed after rebuild")
                return None
    except OSError:
        warn_fallback("dlopen failed")
        return None
    lib.ct_count_kmers.restype = ctypes.c_int64
    lib.ct_count_kmers.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ]
    lib.ct_free.argtypes = [ctypes.c_void_p]
    _u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.ct_merge_runs.restype = ctypes.c_int64
    lib.ct_merge_runs.argtypes = [
        _u64p, _u64p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(_u64p), ctypes.POINTER(_u64p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
    ]
    lib.ct_walk_table_build.restype = ctypes.c_void_p
    lib.ct_walk_table_build.argtypes = [
        _u64p, _u64p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_int32,
    ]
    lib.ct_walk_table_free.argtypes = [ctypes.c_void_p]
    lib.ct_walk.argtypes = [
        ctypes.c_void_p, _u64p, _u64p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _f64 = ctypes.POINTER(ctypes.c_double)
    _i8 = ctypes.POINTER(ctypes.c_int8)
    lib.ct_gotoh_fill.restype = ctypes.c_int32
    lib.ct_gotoh_fill.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32, _f64, _i8, _i8, _i8,
    ]
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    _i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ct_infer_edges.restype = None
    lib.ct_infer_edges.argtypes = [
        _u64p, _u64p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.ct_thread_scan.restype = ctypes.c_int64
    lib.ct_thread_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, _i64p, ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(_u64p), ctypes.POINTER(_u64p),
        ctypes.POINTER(_u8p), ctypes.POINTER(_i64p), ctypes.POINTER(_u8p),
    ]
    lib.ct_unitig_roots.restype = None
    lib.ct_unitig_roots.argtypes = [
        _u64p, _u64p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_int32, _i64p,
    ]
    lib.ct_links_walker_build.restype = ctypes.c_void_p
    lib.ct_links_walker_build.argtypes = [
        _u64p, _u64p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_int32, _i64p, ctypes.POINTER(ctypes.c_uint8), _i64p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.ct_links_walker_free.argtypes = [ctypes.c_void_p]
    lib.ct_walk_links_host.argtypes = [
        ctypes.c_void_p, _u64p, _u64p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ct_dfs_dest.restype = ctypes.c_int64
    lib.ct_dfs_dest.argtypes = [
        ctypes.c_void_p, _u64p, _u64p, _u64p, _u64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(_i64p), ctypes.POINTER(_u64p), ctypes.POINTER(_u64p),
        ctypes.POINTER(_i32p), ctypes.POINTER(_u64p), ctypes.POINTER(_u64p),
        ctypes.POINTER(_i32p),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def gotoh_fill_native(q: str, s: str, local: bool):
    """Native twin of models/sw.py::_gotoh.  Returns (H, None, None, tbH, tbE,
    tbF) — E/F matrices are rolling buffers inside the C++ fill (the traceback
    never reads them) — or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n, m = len(q), len(s)
    H = np.empty((n + 1, m + 1), dtype=np.float64)
    tbH = np.empty((n + 1, m + 1), dtype=np.int8)
    tbE = np.empty_like(tbH)
    tbF = np.empty_like(tbH)
    f64 = ctypes.POINTER(ctypes.c_double)
    i8 = ctypes.POINTER(ctypes.c_int8)
    lib.ct_gotoh_fill(
        q.encode(), n, s.encode(), m, int(local), H.ctypes.data_as(f64),
        tbH.ctypes.data_as(i8), tbE.ctypes.data_as(i8), tbF.ctypes.data_as(i8))
    return H, None, None, tbH, tbE, tbF


def count_kmers_native(sequences, k: int):
    """Native twin of build.count_kmers: returns (kmers uint32[N, W],
    coverage uint32[N], in_mask uint8[N], out_mask uint8[N]) or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None or k > 64:
        return None
    from . import kmer as km

    seqs = list(sequences)
    blob = "".join(seqs).encode()
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])

    hi = ctypes.POINTER(ctypes.c_uint64)()
    lo = ctypes.POINTER(ctypes.c_uint64)()
    cov = ctypes.POINTER(ctypes.c_uint32)()
    im = ctypes.POINTER(ctypes.c_uint8)()
    om = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.ct_count_kmers(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(seqs), k,
        ctypes.byref(hi), ctypes.byref(lo), ctypes.byref(cov),
        ctypes.byref(im), ctypes.byref(om))
    if n < 0:
        return None
    def grab(ptr, ctype, dtype):
        # np.frombuffer over a ctypes view copies at memcpy speed;
        # np.ctypeslib.as_array(...).copy() goes through a ~150 MB/s
        # element-wise path
        if not n:
            return np.zeros(0, dtype)
        buf = (ctype * n).from_address(
            ctypes.cast(ptr, ctypes.c_void_p).value)
        return np.frombuffer(buf, dtype=dtype).copy()

    try:
        hi_a = grab(hi, ctypes.c_uint64, np.uint64)
        lo_a = grab(lo, ctypes.c_uint64, np.uint64)
        cov_a = grab(cov, ctypes.c_uint32, np.uint32)
        im_a = grab(im, ctypes.c_uint8, np.uint8)
        om_a = grab(om, ctypes.c_uint8, np.uint8)
    finally:
        for p in (hi, lo, cov, im, om):
            lib.ct_free(p)

    # (hi, lo) right-aligned 128-bit value -> uint32 words [N, W], filled
    # directly at the target width (no 4-wide scratch + strided recopy)
    w = km.words_per_kmer(k)
    cols = [(hi_a >> np.uint64(32)).astype(np.uint32),
            (hi_a & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (lo_a >> np.uint64(32)).astype(np.uint32),
            (lo_a & np.uint64(0xFFFFFFFF)).astype(np.uint32)][4 - w:]
    kmers = np.empty((n, w), dtype=np.uint32)
    for i, c in enumerate(cols):
        kmers[:, i] = c
    return kmers, cov_a, im_a, om_a


def _words_to_hilo(words: np.ndarray):
    """uint32[N, W] big-to-little words -> right-aligned (hi, lo) uint64[N]."""
    n, w = words.shape
    full = np.zeros((n, 4), dtype=np.uint64)
    full[:, 4 - w:] = words.astype(np.uint64)
    hi = (full[:, 0] << np.uint64(32)) | full[:, 1]
    lo = (full[:, 2] << np.uint64(32)) | full[:, 3]
    return np.ascontiguousarray(hi), np.ascontiguousarray(lo)


def merge_runs_native(key_runs: list):
    """K-way merge of sorted (hi, lo) key runs.  key_runs: list of uint32[N, W]
    word matrices, each sorted.  Returns (union_words uint32[U, W],
    idx int64[total]) mapping each concatenated input key to its union row,
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None or not key_runs:
        return None
    w = key_runs[0].shape[1]
    his, los = [], []
    offsets = np.zeros(len(key_runs) + 1, dtype=np.int64)
    for i, kr in enumerate(key_runs):
        hi, lo = _words_to_hilo(kr)
        his.append(hi)
        los.append(lo)
        offsets[i + 1] = offsets[i] + len(hi)
    hi_all = np.concatenate(his) if his else np.zeros(0, np.uint64)
    lo_all = np.concatenate(los) if los else np.zeros(0, np.uint64)

    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    ohi, olo, oidx = u64p(), u64p(), i64p()
    n = lib.ct_merge_runs(
        hi_all.ctypes.data_as(u64p), lo_all.ctypes.data_as(u64p),
        offsets.ctypes.data_as(i64p), len(key_runs),
        ctypes.byref(ohi), ctypes.byref(olo), ctypes.byref(oidx))
    if n < 0:
        return None

    def grab(ptr, ctype, dtype, count):
        if not count:
            return np.zeros(0, dtype)
        buf = (ctype * count).from_address(
            ctypes.cast(ptr, ctypes.c_void_p).value)
        return np.frombuffer(buf, dtype=dtype).copy()

    try:
        uhi = grab(ohi, ctypes.c_uint64, np.uint64, n)
        ulo = grab(olo, ctypes.c_uint64, np.uint64, n)
        idx = grab(oidx, ctypes.c_int64, np.int64, int(offsets[-1]))
    finally:
        for p in (ohi, olo, oidx):
            lib.ct_free(p)

    full = np.empty((n, 4), dtype=np.uint32)
    full[:, 0] = (uhi >> np.uint64(32)).astype(np.uint32)
    full[:, 1] = (uhi & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    full[:, 2] = (ulo >> np.uint64(32)).astype(np.uint32)
    full[:, 3] = (ulo & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.ascontiguousarray(full[:, 4 - w:]), idx


def _hilo_to_words(hi: np.ndarray, lo: np.ndarray, w: int) -> np.ndarray:
    """Inverse of _words_to_hilo."""
    n = len(hi)
    cols = [(hi >> np.uint64(32)).astype(np.uint32),
            (hi & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (lo >> np.uint64(32)).astype(np.uint32),
            (lo & np.uint64(0xFFFFFFFF)).astype(np.uint32)][4 - w:]
    words = np.empty((n, w), dtype=np.uint32)
    for i, c in enumerate(cols):
        words[:, i] = c
    return words


def infer_edges_native(graph_kmers: np.ndarray, present: np.ndarray,
                       edges_color: np.ndarray, k: int, restrict: bool):
    """Native twin of one color of build.infer_edges.  Returns the new edge
    byte array, or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None or k > 64:
        return None
    khi, klo = _words_to_hilo(graph_kmers)
    edges = np.ascontiguousarray(edges_color, dtype=np.uint8).copy()
    pres = np.ascontiguousarray(present, dtype=np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ct_infer_edges(
        khi.ctypes.data_as(u64p), klo.ctypes.data_as(u64p),
        pres.ctypes.data_as(u8p), edges.ctypes.data_as(u8p),
        len(khi), k, 1 if restrict else 0)
    return edges


def unitig_roots_native(graph_kmers: np.ndarray, edges_color: np.ndarray,
                        k: int):
    """Per-record unitig root ids (union-find over unambiguous adjacencies),
    or None when the native library is unavailable.  See ct_unitig_roots."""
    lib = get_lib()
    if lib is None or k > 64:
        return None
    khi, klo = _words_to_hilo(graph_kmers)
    roots = np.empty(len(khi), dtype=np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.ct_unitig_roots(
        khi.ctypes.data_as(u64p), klo.ctypes.data_as(u64p),
        np.ascontiguousarray(edges_color, dtype=np.uint8)
        .ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(khi), k, roots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return roots


def thread_scan_native(graph_kmers: np.ndarray, edges_color: np.ndarray,
                       k: int, sequences: list,
                       chunk_bases: int = 48_000_000):
    """Native twin of the scan inside build.thread_reads: returns the
    link_map {canonical key kmer string: set[(fw, choices)]} or None when the
    native library is unavailable.  graph_kmers/edges_color must already be
    filtered to records with coverage > 0 in the threading color."""
    lib = get_lib()
    if lib is None or k > 64:
        return None
    from . import kmer as km

    khi, klo = _words_to_hilo(graph_kmers)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    handle = lib.ct_walk_table_build(
        khi.ctypes.data_as(u64p), klo.ctypes.data_as(u64p),
        np.ascontiguousarray(edges_color, dtype=np.uint8).ctypes.data_as(u8p),
        len(khi), k)
    if not handle:
        return None

    link_map: dict[str, set] = {}

    def run_chunk(chunk: list) -> None:
        blob = "".join(chunk).encode()
        offsets = np.zeros(len(chunk) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in chunk], out=offsets[1:])
        ohi, olo = u64p(), u64p()
        ofw, ochoff, och = u8p(), i64p(), u8p()
        n = lib.ct_thread_scan(
            handle, blob, offsets.ctypes.data_as(i64p), len(chunk), k,
            ctypes.byref(ohi), ctypes.byref(olo), ctypes.byref(ofw),
            ctypes.byref(ochoff), ctypes.byref(och))
        if n < 0:
            raise RuntimeError("ct_thread_scan failed")
        def grab(ptr, ctype, dtype, count):
            if not count:
                return np.zeros(0, dtype)
            buf = (ctype * count).from_address(
                ctypes.cast(ptr, ctypes.c_void_p).value)
            return np.frombuffer(buf, dtype=dtype).copy()
        try:
            hi_a = grab(ohi, ctypes.c_uint64, np.uint64, n)
            lo_a = grab(olo, ctypes.c_uint64, np.uint64, n)
            fw_a = grab(ofw, ctypes.c_uint8, np.uint8, n)
            choff = grab(ochoff, ctypes.c_int64, np.int64, n + 1)
            ch = grab(och, ctypes.c_uint8, np.uint8,
                      int(choff[-1]) if n else 0)
        finally:
            for p in (ohi, olo, ofw, ochoff, och):
                lib.ct_free(p)
        if not n:
            return
        words = _hilo_to_words(hi_a, lo_a, km.words_per_kmer(k))
        keys = km.codes_to_strings(km.unpack_words(words, k))
        chb = ch.tobytes()
        for i in range(n):
            link_map.setdefault(keys[i], set()).add(
                (bool(fw_a[i]), chb[choff[i]:choff[i + 1]].decode()))

    try:
        batch, nb = [], 0
        for s in sequences:
            batch.append(s)
            nb += len(s)
            if nb >= chunk_bases:
                run_chunk(batch)
                batch, nb = [], 0
        if batch:
            run_chunk(batch)
    finally:
        lib.ct_walk_table_free(handle)
    return link_map


def walk_forward_host(graph_kmers: np.ndarray, edges_combined: np.ndarray,
                      seeds_words: np.ndarray, k: int, max_steps: int):
    """Batched host walks with exact device-kernel semantics (see ct_walk):
    returns (bases int8[max_steps, B], cycled bool[B], steps int32[B]) or
    None when the native library is unavailable.  The fast small-batch path —
    no XLA compile, ~50M steps/s single-thread — for Partition-style callers."""
    lib = get_lib()
    if lib is None or k > 64:
        return None
    khi, klo = _words_to_hilo(graph_kmers)
    shi, slo = _words_to_hilo(seeds_words)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    handle = lib.ct_walk_table_build(
        khi.ctypes.data_as(u64p), klo.ctypes.data_as(u64p),
        np.ascontiguousarray(edges_combined, dtype=np.uint8).ctypes.data_as(u8p),
        len(khi), k)
    if not handle:
        return None
    b = len(shi)
    bases = np.empty((b, max_steps), dtype=np.int8)
    cycled = np.zeros(b, dtype=np.uint8)
    steps = np.zeros(b, dtype=np.int32)
    try:
        lib.ct_walk(handle, shi.ctypes.data_as(u64p), slo.ctypes.data_as(u64p),
                    b, max_steps,
                    bases.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                    cycled.ctypes.data_as(u8p),
                    steps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.ct_walk_table_free(handle)
    return bases.T.copy(), cycled.astype(bool), steps


class LinksWalkerNative:
    """Host link-assisted walker: exact unbounded LinkStore semantics
    (ct_walk_links_host; twin of traversal/linkstore.py + the engine cursor).
    No capacity caps, no XLA compile — the production path for small seed
    batches and for device-cap overflow replay.

    graph/colors/links_list mirror ops/walk_links.LinkedWalker; link records
    are packed per graph record in links-file order (the engine's
    _add_links_for insertion order)."""

    def __init__(self, graph, colors, links_list):
        lib = get_lib()
        if lib is None or graph.kmer_size > 64:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.k = graph.kmer_size
        import numpy as _np

        edges = _np.bitwise_or.reduce(graph.edges[:, list(colors)], axis=1)
        n = graph.num_records

        # CSR of link records aligned with graph record order
        from . import kmer as km
        per_record: dict[int, list] = {}
        samples = {graph.sample_name(c) for c in colors}
        for lm in links_list:
            if lm.sample_name not in samples:
                continue
            # materialize each links file exactly once: lm.records is a
            # full-scan *property* on LinksRandomAccess, so per-key access
            # through it is O(N^2) bgzf reads
            recs = getattr(lm, "records", None)
            if recs is None:
                recs = {kk: lm.get(kk) for kk in lm.index}
            if not recs:
                continue
            keys = list(recs)
            recs_idx = graph.find_records(
                km.pack_codes(km.strings_to_codes(keys), self.k))
            for s, rec in zip(keys, recs_idx):
                if rec < 0:
                    continue
                per_record.setdefault(int(rec), []).extend(recs[s])

        loff = _np.zeros(n + 1, dtype=_np.int64)
        fw_l, ch_l, choff_l = [], [], [0]
        total = 0
        code = {"A": 0, "C": 1, "G": 2, "T": 3}
        pos = 0
        for r in range(n):
            loff[r] = pos
            for jr in per_record.get(r, ()):
                fw_l.append(1 if jr.forward else 0)
                ch_l.extend(code[c] for c in jr.choices)
                total += len(jr.choices)
                choff_l.append(total)
                pos += 1
        loff[n] = pos

        fw = _np.asarray(fw_l, dtype=_np.uint8)
        choff = _np.asarray(choff_l, dtype=_np.int64)
        chpool = _np.asarray(ch_l, dtype=_np.uint8)
        khi, klo = _words_to_hilo(_np.ascontiguousarray(graph.kmers))
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        self._handle = lib.ct_links_walker_build(
            khi.ctypes.data_as(u64p), klo.ctypes.data_as(u64p),
            _np.ascontiguousarray(edges, dtype=_np.uint8).ctypes.data_as(u8p),
            n, self.k, loff.ctypes.data_as(i64p),
            fw.ctypes.data_as(u8p) if len(fw) else u8p(),
            choff.ctypes.data_as(i64p), len(fw),
            chpool.ctypes.data_as(u8p) if len(chpool) else u8p(),
            len(chpool))

    def walk(self, seeds: list, max_steps: int):
        """Forward link-assisted extensions from walk-orientation seed kmer
        strings.  Returns (ext strings, junctions int32[B])."""
        from . import kmer as km
        b = len(seeds)
        if not b:
            return [], np.zeros(0, np.int32)
        shi, slo = _words_to_hilo(
            km.pack_codes(km.strings_to_codes(seeds), self.k))
        bases = np.empty((b, max_steps), dtype=np.int8)
        steps = np.zeros(b, dtype=np.int32)
        junctions = np.zeros(b, dtype=np.int32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        self._lib.ct_walk_links_host(
            self._handle, shi.ctypes.data_as(u64p), slo.ctypes.data_as(u64p),
            b, max_steps,
            bases.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            steps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            junctions.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        exts = [lut[bases[i, :steps[i]]].tobytes().decode() for i in range(b)]
        return exts, junctions

    def dfs_dest(self, sources: list, sinks: list, max_branch: int = 75000,
                 use_links: bool = True):
        """Batched closeGaps probes (Call.java:2232-2263): FORWARD dfs with
        DestinationStopper from each walk-orientation source kmer toward its
        sink.  REVERSE probes = pass revcomped source/sink and flip the
        returned edges.  Returns (success bool[B], edges list[B]) where each
        probe's edges are [((u_kmer, u_copy), (v_kmer, v_copy)), ...] in walk
        orientation; use_links mirrors whether the engine config had links."""
        from . import kmer as km
        b = len(sources)
        if not b:
            return np.zeros(0, bool), []
        shi, slo = _words_to_hilo(
            km.pack_codes(km.strings_to_codes(sources), self.k))
        thi, tlo = _words_to_hilo(
            km.pack_codes(km.strings_to_codes(sinks), self.k))
        success = np.zeros(b, dtype=np.uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        eoff_p = i64p()
        uh_p, ul_p, vh_p, vl_p = u64p(), u64p(), u64p(), u64p()
        uc_p, vc_p = i32p(), i32p()
        E = self._lib.ct_dfs_dest(
            self._handle, shi.ctypes.data_as(u64p), slo.ctypes.data_as(u64p),
            thi.ctypes.data_as(u64p), tlo.ctypes.data_as(u64p),
            b, max_branch, 1 if use_links else 0,
            success.ctypes.data_as(u8p), ctypes.byref(eoff_p),
            ctypes.byref(uh_p), ctypes.byref(ul_p), ctypes.byref(uc_p),
            ctypes.byref(vh_p), ctypes.byref(vl_p), ctypes.byref(vc_p))
        if E < 0:
            raise MemoryError("ct_dfs_dest allocation failed")

        def grab(ptr, ctype, dtype, count):
            if not count:
                return np.zeros(0, dtype)
            buf = (ctype * count).from_address(
                ctypes.cast(ptr, ctypes.c_void_p).value)
            return np.frombuffer(buf, dtype=dtype).copy()

        try:
            eoff = grab(eoff_p, ctypes.c_int64, np.int64, b + 1)
            uh = grab(uh_p, ctypes.c_uint64, np.uint64, E)
            ul = grab(ul_p, ctypes.c_uint64, np.uint64, E)
            uc = grab(uc_p, ctypes.c_int32, np.int32, E)
            vh = grab(vh_p, ctypes.c_uint64, np.uint64, E)
            vl = grab(vl_p, ctypes.c_uint64, np.uint64, E)
            vc = grab(vc_p, ctypes.c_int32, np.int32, E)
        finally:
            for p in (eoff_p, uh_p, ul_p, uc_p, vh_p, vl_p, vc_p):
                self._lib.ct_free(p)

        w = km.words_per_kmer(self.k)
        u_strs = km.codes_to_strings(
            km.unpack_words(_hilo_to_words(uh, ul, w), self.k)) if E else []
        v_strs = km.codes_to_strings(
            km.unpack_words(_hilo_to_words(vh, vl, w), self.k)) if E else []
        edges = []
        for i in range(b):
            lo_i, hi_i = int(eoff[i]), int(eoff[i + 1])
            edges.append([((u_strs[j], int(uc[j])), (v_strs[j], int(vc[j])))
                          for j in range(lo_i, hi_i)])
        return success.astype(bool), edges

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.ct_links_walker_free(self._handle)
        except Exception:
            pass


class WalkTableNative:
    """Reusable native walk table (build once, walk many seed batches)."""

    def __init__(self, graph_kmers: np.ndarray, edges_combined: np.ndarray,
                 k: int):
        lib = get_lib()
        if lib is None or k > 64:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        khi, klo = _words_to_hilo(graph_kmers)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        self._handle = lib.ct_walk_table_build(
            khi.ctypes.data_as(u64p), klo.ctypes.data_as(u64p),
            np.ascontiguousarray(edges_combined, dtype=np.uint8)
            .ctypes.data_as(u8p), len(khi), k)
        self.k = k

    def walk(self, seeds_words: np.ndarray, max_steps: int):
        shi, slo = _words_to_hilo(seeds_words)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        b = len(shi)
        bases = np.empty((b, max_steps), dtype=np.int8)
        cycled = np.zeros(b, dtype=np.uint8)
        steps = np.zeros(b, dtype=np.int32)
        self._lib.ct_walk(
            self._handle, shi.ctypes.data_as(u64p), slo.ctypes.data_as(u64p),
            b, max_steps,
            bases.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            cycled.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            steps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return bases.T.copy(), cycled.astype(bool), steps

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.ct_walk_table_free(self._handle)
        except Exception:
            pass
