#!/usr/bin/env python3
"""Times of ctk_segment_reduce and ctk_count_windows (csrc/count.cu),
ctk_ht_lookup and ctk_spec_walk (csrc/walk_table.cu) on one GPU, at
chip_smoke.py's phase 9 and 10 sizes.

    python3 corticall_tpu_torch/tools/table_probe.py [--repo DIR] [--ablate]
    python3 corticall_tpu_torch/tools/table_probe.py --count [--repo DIR] [--ablate]
    python3 corticall_tpu_torch/tools/table_probe.py --spec [--repo DIR]
    python3 corticall_tpu_torch/tools/table_probe.py --spec --inputs-only \
        --device cpu --spec-bases 20000 --spec-seeds 256

Inputs, made from a seed: for the reduction, sorted k = 47 rows shaped as
phase 10's first chunk (17,714,008 rows drawn uniformly from 3,546,522 keys,
so runs average 5 rows; coverage 1) and as its largest merge (4,480,202 keys,
967,538 of them twice, coverage near 2^31); for the lookup, 21,003,902
random k = 47 keys in the JAX package's slot table (`hashtable.build` on the
host, ~15 s) and its probe tables, queried by every key and as many keys with
a flipped bit, in record order as phase 9 queries, and shuffled.  Every
output is held against its plain twin; a time is the mean CUDA-event time of
5 launches after a warm-up.

This checkout's lookup is timed at 1, 2, 4 and 8 lanes a query over key and
tag entries.  --repo DIR times another checkout's `reduce_kernel` and
`lookup_kernel` wrappers (for example the parent unpacked with `git
archive`; a checkout whose lookup takes the slot table gets it) in turns
with this one: other, this, this, other.

--spec times the speculative walk alone, on phase 9's inputs: bench.py's
graph (demo.build_bench_graph(47, 21,000,000), ~2 min on the host), its walk
table (the jump table's placement with colour 0's edge byte as payload) and
262,144 seeds of 256 steps (phase 6's); this checkout's walk_forward_spec
launch and another checkout's in turns with --repo, then this checkout's
two paths (the rows as vectors, and a copy of the table off their
alignment, read a word at a time: chip_smoke.word_path_table), each with
its registers, spills, resident lanes and waves; each beside the bucket
rows a second and the rows the second probes read (chip_smoke.spec_reads),
every output against the twin.  --inputs-only builds the inputs (on
--device, the card by default), prints their sizes as one JSON line and
stops.  --spec --ablate also times csrc/walk_table.cu rebuilt with one
choice changed at a time (SPEC_ABLATIONS): the 32-register cap lifted; two
walks a thread at 64 registers; the warp-cooperative tail (a warp iterates
until its last walk ends); the card's L2 fetch granularity set to 32 bytes
ahead of each launch (a hint to fetch a row's one sector, not 64 bytes; it
stays set for the rest of the process, so it runs last).

--count times the device build's count on a kid-shaped trio sample: 20x
150 bp reads with 0.2% errors (simulate.simulate_reads) of a random 2 Mbp
genome, and their first chunk (chip_smoke.first_chunk: 170,327 reads,
33,554,372 bytes, 17,714,008 valid windows at k = 47).  For each checkout in
turns (other, this, this, other): the path from the chunk's string to its
compacted rows on the card (host clock, synchronized: here encode, upload
and count_windows; in a checkout that packs on the host, pack_piece,
words_tensor, extract_windows and live_windows), its count kernel alone
(CUDA events; a packing checkout's windows kernel and its compaction
apart), and the sample's build_graph_from_reads(use_device=True) seconds;
rows and graphs equal across checkouts, the kernel's rows equal to the
twin's.  --count --ablate also times csrc/count.cu's ctk_count_windows
rebuilt with one choice changed at a time (COUNT_ABLATIONS): each tile's
rows placed by one atomicAdd, out of order (compared as sorted rows: the
cost of keeping the order); keys and masks stored from registers at their
rows, no staging (the cost of staging); tiles of half and double the
windows; each with its registers, spills and shared memory.

--ablate: csrc/count.cu rebuilt with one choice changed at a time (status
words stored with release and loaded with acquire semantics; each tile's
copies waited on at once instead of behind the tile before; no sleep in the
spin), and with the warps' scans of the threads' spans or the look-back's
waits compiled out (the outputs are then wrong: time only), each launched
through its own library.  Builds go to the git-ignored build/probe/.

JSON lines on stdout, then the card's name and power limit.
"""

import argparse
import ctypes
import importlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, HERE)
sys.modules["jax"] = None

K = 47
CHUNK_ROWS, CHUNK_KEYS = 17_714_008, 3_546_522          # phase 10's first chunk
MERGE_KEYS, MERGE_TWICE = 4_480_202, 967_538           # its largest merge
RECORDS = 21_003_902                                    # phase 9's graph
SPEC_BASES, SPEC_SEEDS = 21_000_000, 262_144            # phase 6's genome and seeds
REPS = 5

# spec walk variant -> [(text of csrc/walk_table.cu, its replacement)]
SPEC_ABLATIONS = {
    "uncapped": [("constexpr int kSpecMinBlocks = 16;", "constexpr int kSpecMinBlocks = 1;")],
    "pair": [("constexpr int kSpecWalks = 1;", "constexpr int kSpecWalks = 2;"),
             ("constexpr int kSpecMinBlocks = 16;", "constexpr int kSpecMinBlocks = 8;")],
    "warp_tail": [("    if (!live) break;\n", "    if (!__any_sync(kFullMask, live)) break;\n")],
    "L2 fetch granularity 32 bytes": [(
        "  const SpecKernel fn = spec_kernel_for(buckets, bs, w);\n",
        "  cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, 32);\n"
        "  const SpecKernel fn = spec_kernel_for(buckets, bs, w);\n")],
}

GENOME_BASES, READ_LENGTH, COVERAGE, READ_ERROR = 2_000_000, 150, 20, 0.002   # phase 4's kid

# ctk_count_windows with each thread computing the tile's valid windows by
# rank (their positions listed in shared memory first), not its 16 striped
# windows with the invalid ones idle
DENSE = [
    ("  uint8_t masks[kCountTile];          // and their masks (in << 4 | out)\n",
     "  uint8_t masks[kCountTile];          // and their masks (in << 4 | out)\n"
     "  uint16_t pos[kCountTile];\n"),
    ("""  // the valid windows, staged at their ranks
  const int s = 32 * W - 2 * k;
  const unsigned below = (1u << lane) - 1u;
  for (int j = 0; j < kCountItems; ++j) {
    if (!(mine >> j & 1u)) continue;
    const int span = j * kCountWarps + warp;
    const int rank = (int)b.before[span] + __popc(b.ballots[span] & below);
    const int p = kLead + j * kCountThreads + t;
""", """  const unsigned below = (1u << lane) - 1u;
  for (int j = 0; j < kCountItems; ++j) {
    if (!(mine >> j & 1u)) continue;
    const int span = j * kCountWarps + warp;
    b.pos[(int)b.before[span] + __popc(b.ballots[span] & below)] =
        (uint16_t)(j * kCountThreads + t);
  }
  __syncthreads();
  const int s = 32 * W - 2 * k;
  for (int rank = t; rank < b.rows; rank += kCountThreads) {
    const int p = kLead + b.pos[rank];
""")]

# count_windows variant -> [(text of csrc/count.cu, its replacement)]
COUNT_ABLATIONS = {
    "atomic compaction (rows out of order)": [
        ("""    const uint32_t before = look_back(status, tile, epoch);
    if (lane == 0) {
      if (tile) st_status(status + tile, status_word(epoch, kPrefix, before + rows));
      if (tile == ntiles - 1) *count = (int)(before + rows);
      b.out = before;
""", """    if (lane == 0) {
      b.out = atomicAdd(reinterpret_cast<unsigned*>(status) - 2, rows);
"""),
        ("\n      counters[0] = 0u;  // every block has taken its last tile\n",
         "\n      *count = (int)atomicExch(counters + 2, 0u);\n      counters[0] = 0u;\n")],
    "keys from registers (no staging)": [
        ("  uint32_t keys[kCountTile * W];      // the tile's valid windows' keys, at their ranks\n",
         "  uint32_t keys[4];\n"),
        ("  uint8_t masks[kCountTile];          // and their masks (in << 4 | out)\n",
         "  uint8_t masks[16];\n"),
        ("  // the valid windows, staged at their ranks\n", "  __syncthreads();\n"),
        ("    for (int w = 0; w < W; ++w) b.keys[rank * W + w] = canon[w];\n"
         "    b.masks[rank] = (uint8_t)((in_m << 4) | out_m);\n",
         "    for (int w = 0; w < W; ++w) keys[(b.out + rank) * W + w] = canon[w];\n"
         "    masks[b.out + rank] = (uint8_t)((in_m << 4) | out_m);\n"),
        ("  write_rows<W>(b, keys, masks);\n", "")],
    "dense (valid windows by rank)": DENSE,
    "no canonicalization (wrong outputs)": [(
        "    const bool flip = canonicalize<W>(v, canon, k);\n",
        "    const bool flip = false;\n#pragma unroll\n    for (int w = 0; w < W; ++w) canon[w] = v[w];\n")],
    "no key arithmetic (wrong outputs)": [("    if (!(mine >> j & 1u)) continue;\n", "    continue;\n")],
    "half tile (2,048 windows)": [("constexpr int kCountItems = 16;",
                                   "constexpr int kCountItems = 8;")],
    "double tile (8,192 windows)": [("constexpr int kCountItems = 16;",
                                     "constexpr int kCountItems = 32;")],
}

# variant -> ([(text of csrc/count.cu, its replacement)], tile rows)
ABLATIONS = {
    "release / acquire status words": ([("st.relaxed.gpu.b64", "st.release.gpu.b64"),
                                        ("ld.relaxed.gpu.b64", "ld.acquire.gpu.b64")], 2048),
    "no prefetch": ([("cp.async.wait_group 1;", "cp.async.wait_group 0;")], 2048),
    "no sleep in the spin": ([("    __nanosleep(32);\n", "")], 2048),
    "no warp scans (wrong outputs)": (
        [("  Span inc = own;\n#pragma unroll\n  for (int d = 1; d < 32; d <<= 1) {",
          "  Span inc = own;\n#pragma unroll\n  for (int d = 32; d < 32; d <<= 1) {")], 2048),
    "no look-back waits (wrong outputs)": (
        [("bool hdone = tile == 0, cdone = tile == 0 || !lead;",
          "bool hdone = true, cdone = true;"),
         ("sh.out = (long long)before - (lead ? 1 : 0);", "sh.out = 0;")], 2048),
}


def count_case(dev):
    """A kid-shaped sample's reads (phase 4's: GENOME_BASES, COVERAGE x
    READ_LENGTH reads at READ_ERROR), its first chunk and the chunk's rows
    by the twin (on the card)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from corticall_tpu_torch import simulate as sim
    from corticall_tpu_torch.ops import build_device as bdv
    genome = "".join(np.random.default_rng(5).choice(list("ACGT"), GENOME_BASES))
    reads = sim.simulate_reads([genome], COVERAGE, READ_LENGTH, READ_ERROR, seed=1)
    chunk = cs.first_chunk(reads, K)
    bases = torch.from_numpy(np.frombuffer(chunk.encode(), np.uint8).copy()).to(dev)
    want = bdv.count_windows_plain(bases, 0, len(chunk), K)
    return {"reads": reads, "chunk": chunk, "bases": bases, "want": want,
            "sizes": {"reads": len(reads), "chunk_reads": chunk.count("N" * K) + 1,
                      "bytes": len(chunk), "windows": int(want[0].shape[0])}}


def count_path(bdv, chunk: str, dev):
    """A checkout's rows of a chunk's string on the card: this one's (bytes
    up, one count_windows launch), or one that packs on the host."""
    if hasattr(bdv, "pack_piece"):
        stream, valid, own, n = bdv.pack_piece(chunk, None, bdv.CHUNK_BASES)
        return bdv.live_windows(*bdv.extract_windows(
            *(bdv.words_tensor(x, dev) for x in (stream, valid, own)), K, n))
    return bdv.count_windows(bdv.upload(bdv.encode([chunk], K), dev), 0, len(chunk), K)


def time_count_kernel(cs, bdv, case, dev) -> dict:
    """A checkout's count kernel alone on the chunk (CUDA events): this
    one's into poisoned buffers, held against the twin; a packing one's
    windows kernel, and its compaction apart."""
    import torch
    chunk, n, w = case["chunk"], len(case["chunk"]), case["want"][0].shape[1]
    if hasattr(bdv, "pack_piece"):
        stream, valid, own, _ = bdv.pack_piece(chunk, None, bdv.CHUNK_BASES)
        st, vt, ot = (bdv.words_tensor(x, dev) for x in (stream, valid, own))
        keys = torch.empty((n, w), dtype=torch.int32, device=dev)
        masks = torch.empty(n, dtype=torch.uint8, device=dev)
        ms = cs.event_ms(lambda: bdv.windows_kernel(st, vt, ot, K, n, keys, masks), REPS)
        compact_ms = cs.event_ms(lambda: bdv.live_windows(keys, masks), REPS)
        return {"ms": round(ms, 4), "compact_ms": round(compact_ms, 4)}
    keys, masks, count = count_buffers(case, dev)
    ms = cs.event_ms(lambda: bdv.count_kernel(case["bases"], 0, n, K, keys, masks, count), REPS)
    check_count(cs, keys, masks, count, case["want"], "count_windows")
    return {"ms": round(ms, 4), **bdv.count_kernel_info(K)}


def count_buffers(case, dev):
    """Poisoned keys and masks with room for every window, and the count."""
    import torch
    n, w = len(case["chunk"]), case["want"][0].shape[1]
    return (torch.full((n - K + 1, w), 0x5A5A5A5A, dtype=torch.int32, device=dev),
            torch.full((n - K + 1,), 0x5A, dtype=torch.uint8, device=dev),
            torch.full((1,), -7, dtype=torch.int32, device=dev))


def check_count(cs, keys, masks, count, want, what: str, in_order: bool = True) -> None:
    """The kernel's rows against the twin's (as sorted rows when not
    `in_order`), and nothing written past its count."""
    import torch
    from corticall_tpu_torch.ops import build_device as bdv
    m = int(count.item())
    if m != want[0].shape[0]:
        raise AssertionError(f"{what}: {m} rows, the twin {want[0].shape[0]}")
    if in_order:
        cs.same(keys[:m], want[0], f"{what} keys")
        cs.same(masks[:m], want[1], f"{what} masks")
    else:
        a, b = (torch.cat([k, mk.to(torch.int32)[:, None]], dim=1)
                for k, mk in ((keys[:m], masks[:m]), want))
        cs.same(a[bdv.sort_order(a)], b[bdv.sort_order(b)], f"{what} sorted rows")
    if not ((keys[m:] == 0x5A5A5A5A).all() and (masks[m:] == 0x5A).all()):
        raise AssertionError(f"{what}: a row past the count was written")


def count_libraries() -> dict:
    """{variant: a library of csrc/count.cu so changed (COUNT_ABLATIONS)},
    built into build/probe/."""
    from corticall_tpu_torch.ops import _kernels
    out_dir = os.path.join(HERE, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_kernels.CSRC_DIR, "count.cu")) as f:
        original = f.read()
    procs, libs = [], []
    for index, edits in enumerate(COUNT_ABLATIONS.values()):
        src = original
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"count.cu no longer has {old!r} once")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"count_windows_ablate{index}.cu")
        with open(path, "w") as f:
            f.write(src)
        libs.append(os.path.join(out_dir, f"count_windows_ablate{index}.so"))
        procs.append(subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I",
                                       _kernels.CSRC_DIR, "-shared", "-o", libs[-1], path]))
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed")
    out = {}
    for name, path in zip(COUNT_ABLATIONS, libs):
        lib = ctypes.CDLL(path)
        for entry in ("ctk_count_windows", "ctk_count_windows_info"):
            fn = getattr(lib, entry)
            fn.argtypes = list(_kernels._SIGNATURES[entry])
            fn.restype = ctypes.c_int
        out[name] = lib
    return out


def count_main(cs, order, dev, ablate: bool = False) -> None:
    """--count: each checkout's path, kernel and sample in turns, then with
    --ablate each COUNT_ABLATIONS library."""
    import importlib
    import time
    import numpy as np
    import torch
    from corticall_tpu_torch.ops import _kernels, build_device as this_bdv
    case = count_case(dev)
    print(json.dumps({"count_case": case["sizes"]}), flush=True)
    builds = {}
    for name, bdv, _, _ in order:                     # first use: the library, torch.sort
        bdv.count_kmers_device([case["chunk"][:5000]], K, device=dev)
        builds[name] = importlib.import_module(bdv.__name__.rsplit(".", 2)[0] + ".build")
    first = None
    for turn, (name, bdv, _, _) in enumerate(order):
        path_ms = []
        for _ in range(3):
            ms, rows = cs.host_ms(lambda: count_path(bdv, case["chunk"], dev))
            path_ms.append(round(ms, 2))
        for a, b, what in zip(rows, case["want"], ("keys", "masks")):
            cs.same(a, b, f"{name} path, {what}")
        del rows
        kernel = time_count_kernel(cs, bdv, case, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = builds[name].build_graph_from_reads(case["reads"], K, "kid", use_device=True,
                                                device=dev)
        sample_s = time.perf_counter() - t0
        graph = (g.kmers, g.coverages, g.edges)
        if first is None:
            first = graph
        elif not all(np.array_equal(a, b) for a, b in zip(graph, first)):
            raise AssertionError(f"{name}: the sample's graph differs from {order[0][0]}'s")
        del g, graph
        print(json.dumps({"kernel": "count_windows", "version": name, "turn": turn,
                          "path_ms": path_ms, "count_kernel": kernel,
                          "sample_device_s": round(sample_s, 3)}), flush=True)
        torch.cuda.empty_cache()
    if ablate:
        n = len(case["chunk"])
        scratch = torch.zeros(2 + n // 1024 + 2, dtype=torch.int64, device=dev)
        epoch = 0
        for variant, lib in count_libraries().items():
            keys, masks, count = count_buffers(case, dev)

            def run():
                nonlocal epoch
                epoch += 1
                _kernels.check(lib.ctk_count_windows(
                    case["bases"].data_ptr(), n, 0, n, keys.shape[1], K, keys.data_ptr(),
                    masks.data_ptr(), count.data_ptr(), scratch.data_ptr(),
                    scratch.numel() - 2, epoch, _kernels.stream(dev)), variant)

            ms = cs.event_ms(run, REPS)
            if "wrong outputs" in variant:            # time only
                if int(count.item()) != case["want"][0].shape[0]:
                    raise AssertionError(f"{variant}: the count differs from the twin's")
            else:
                check_count(cs, keys, masks, count, case["want"], variant,
                            in_order="out of order" not in variant)
            print(json.dumps({"kernel": "count_windows", "version": ".", "variant": variant,
                              "ms": round(ms, 4), **this_bdv.count_kernel_info(K, lib)}),
                  flush=True)
            del keys, masks, count
    del case
    torch.cuda.empty_cache()


def load_ops(repo: str):
    """(build_device, hashtable, cuckoo) of `repo`'s corticall_tpu_torch;
    another checkout's package is loaded as `other_corticall_tpu_torch`."""
    if os.path.abspath(repo) == HERE:
        name = "corticall_tpu_torch"
    else:
        name = "other_corticall_tpu_torch"
        pkg_dir = os.path.join(repo, "corticall_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return tuple(importlib.import_module(f"{name}.ops.{m}")
                 for m in ("build_device", "hashtable", "cuckoo"))


def words(gen, n: int, dev):
    """n random k = 47 keys: int32 [n, 3], uint32 bit patterns, the top word
    30 bits."""
    import torch
    from corticall_tpu_torch.ops import kmer as tk
    w = torch.randint(0, 1 << 32, (n, 3), generator=gen, device=dev, dtype=torch.int64)
    w[:, 0] &= (1 << 30) - 1
    return tk.to_bits32(w)


def reduce_cases(dev):
    import torch
    from corticall_tpu_torch.ops import build_device as bdv, kmer as tk
    gen = torch.Generator(device=dev).manual_seed(12)
    cases = {}
    keys = words(gen, CHUNK_KEYS, dev)
    keys = keys[torch.randint(0, CHUNK_KEYS, (CHUNK_ROWS,), generator=gen, device=dev)]
    cov = torch.ones(CHUNK_ROWS, dtype=torch.int32, device=dev)
    cases["chunk"] = (keys, cov)
    keys = words(gen, MERGE_KEYS, dev)
    keys = torch.cat([keys, keys[:MERGE_TWICE]])
    cov = torch.randint(1 << 31, 1 << 32, (keys.shape[0],), generator=gen, device=dev,
                        dtype=torch.int64)
    cases["merge"] = (keys, tk.to_bits32(cov))
    out = {}
    for name, (keys, cov) in cases.items():
        masks = torch.randint(0, 256, (keys.shape[0],), generator=gen, device=dev,
                              dtype=torch.int64).to(torch.uint8)
        order = bdv.sort_order(keys)
        keys, cov, masks = keys[order], cov[order], masks[order]
        want = bdv.reduce_plain(keys, cov, masks)
        bound = bdv_bound(keys, cov, masks, want)
        out[name] = {"args": (keys, cov, masks), "want": want, "bound": bound}
    return out


def bdv_bound(keys, cov, masks, want):
    """chip_smoke's bound: each input byte once, each unique row's bytes
    once."""
    import chip_smoke as cs
    return cs.bound_fields(cs.bound_ms(cs.nbytes(keys, cov, masks) + 4 + cs.nbytes(*want)))


def check_reduce(out, count, want, what: str) -> None:
    import chip_smoke as cs
    n = int(count.item())
    if n != want[0].shape[0]:
        raise AssertionError(f"{what}: {n} unique rows, the twin {want[0].shape[0]}")
    for a, b in zip(out, want):
        cs.same(a[:n], b, what)


def time_reduce(cs, run, case, what: str, check: bool = True) -> dict:
    import torch
    keys, cov, masks = case["args"]
    out = (torch.empty_like(keys), torch.empty_like(cov), torch.empty_like(masks))
    count = torch.empty(1, dtype=torch.int32, device=keys.device)
    ms = cs.event_ms(lambda: run(keys, cov, masks, *out, count), REPS)
    if check:
        check_reduce(out, count, case["want"], what)
    return {"rows": keys.shape[0], "unique": case["want"][0].shape[0], "ms": round(ms, 4),
            **case["bound"]}


def lookup_case(dev):
    import numpy as np
    import torch
    import time
    from corticall_tpu_torch.ops import hashtable as ht, kmer as tk
    rng = np.random.default_rng(9)
    kmers = rng.integers(0, 1 << 32, size=(RECORDS, 3), dtype=np.uint64).astype(np.uint32)
    kmers[:, 0] &= np.uint32((1 << 30) - 1)
    t0 = time.perf_counter()
    table = ht.build(kmers)
    build_s = time.perf_counter() - t0
    miss = kmers.copy()
    miss[:, -1] ^= np.uint32(1)
    slots = torch.from_numpy(table.slots).to(dev)
    keys = tk.words_tensor(kmers, dev)
    queries = tk.words_tensor(np.concatenate([kmers, miss]), dev)
    want = ht.lookup_plain(slots, keys, queries, table.max_probe)
    shuffle = torch.randperm(queries.shape[0], generator=torch.Generator().manual_seed(3))
    shuffle = shuffle.to(dev)
    return {"slots": slots, "keys": keys, "max_probe": table.max_probe,
            "queries": {"in record order": (queries, want),
                        "shuffled": (queries[shuffle], want[shuffle])},
            "host_build_s": round(build_s, 2),
            "tables": {form: ht.probe_table(slots, keys, form) for form in ("key", "tag")}}


def time_lookup(cs, ht, case, order: str, form=None, group=None) -> dict:
    """One lookup wrapper's time on the queries in `order`: this checkout's
    over a probe table, or another's (form None) over what its
    lookup_kernel takes."""
    import inspect
    import torch
    queries, want = case["queries"][order]
    out = torch.empty_like(want)
    args = (case["keys"], queries, case["max_probe"], out)
    if form is None and "table" not in inspect.signature(ht.lookup_kernel).parameters:
        ms = cs.event_ms(lambda: ht.lookup_kernel(case["slots"], *args), REPS)
        row = {"form": "slots"}
    else:
        form = form or ht.PROBE_FORM
        group = group or ht.LOOKUP_GROUP
        table = case["tables"][form]
        ms = cs.event_ms(lambda: ht.lookup_kernel(table, *args, group), REPS)
        row = {"form": form, "group": group}
    cs.same(out, want, f"ht_lookup {row}, queries {order}")
    return {**row, "queries": queries.shape[0], "order": order, "ms": round(ms, 4)}


def spec_case(dev, n_bases: int, n_seeds: int) -> dict:
    """Phase 9's walk: the bench graph's walk table on `dev` and phase 6's
    seeds (genome windows at the positions rng 11 draws)."""
    import time
    import numpy as np
    from corticall_tpu_torch import kmer as km
    from corticall_tpu_torch.demo import build_bench_graph
    from corticall_tpu_torch.ops import jump as tj, kmer as tk
    t0 = time.perf_counter()
    g, genome = build_bench_graph(K, n_bases)
    graph_s = time.perf_counter() - t0
    nb, bucket_of, pos_of = tj.place(g.kmers)
    buckets, _ = tj.scatter_buckets(g.kmers, nb, bucket_of * 2 + pos_of, dev,
                                    payload=np.ascontiguousarray(g.edges[:, 0]))
    starts = np.random.default_rng(11).integers(0, len(genome) - K, size=n_seeds)
    seeds = km.pack_codes(km.strings_to_codes([genome[i:i + K] for i in starts]), K)
    return {"buckets": buckets, "seeds": tk.words_tensor(seeds, dev),
            "sizes": {"records": g.num_records, "buckets": nb, "seeds": n_seeds,
                      "graph_s": round(graph_s, 1), "device": str(dev)}}


def time_spec(cs, ck, case, want, version: str, buckets=None) -> dict:
    """One ctk_spec_walk launch's time (a checkout's wrapper, over `buckets`
    or the case's table), its outputs, launched into poisoned buffers,
    against the twin's `want`."""
    import torch
    buckets = case["buckets"] if buckets is None else buckets
    bufs = cs.poison(tuple(torch.empty_like(x) for x in want))
    ms = cs.event_ms(lambda: ck.spec_walk_kernel(buckets, case["seeds"], K, cs.SPEC_STEPS, *bufs),
                     REPS)
    for name, a, b in zip(("bases", "cycled", "steps"), bufs, want):
        cs.same(a, b, f"{version} spec_walk {name}")
    return {"ms": round(ms, 4), "rows_per_s": round(case["rows"] / ms * 1e3)}


def spec_libraries() -> dict:
    """{variant: a library of csrc/walk_table.cu so changed (SPEC_ABLATIONS),
    with this checkout's argtypes}, built into build/probe/."""
    from corticall_tpu_torch.ops import _kernels
    out_dir = os.path.join(HERE, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_kernels.CSRC_DIR, "walk_table.cu")) as f:
        original = f.read()
    procs, libs = [], []
    for index, edits in enumerate(SPEC_ABLATIONS.values()):
        src = original
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"walk_table.cu no longer has {old!r} once")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"walk_table_ablate{index}.cu")
        with open(path, "w") as f:
            f.write(src)
        libs.append(os.path.join(out_dir, f"walk_table_ablate{index}.so"))
        procs.append(subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I",
                                       _kernels.CSRC_DIR, "-shared", "-o", libs[-1], path,
                                       os.path.join(_kernels.CSRC_DIR, "sw_banded.cu")]))
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed")
    out = {}
    for name, path in zip(SPEC_ABLATIONS, libs):
        lib = ctypes.CDLL(path)
        for entry in ("ctk_spec_walk", "ctk_spec_walk_info"):
            fn = getattr(lib, entry)
            fn.argtypes = list(_kernels._SIGNATURES[entry])
            fn.restype = ctypes.c_int
        lib.ctk_error_string.argtypes = [ctypes.c_int]
        lib.ctk_error_string.restype = ctypes.c_char_p
        out[name] = lib
    return out


def spec_main(cs, order, ck, dev, ablate: bool = False) -> None:
    """--spec: the walk of each checkout in `order`, in turns, then each
    path of this checkout's (its cuckoo module `ck`), then with --ablate
    each SPEC_ABLATIONS library through this checkout's wrapper."""
    import torch
    case = spec_case(dev, SPEC_BASES, SPEC_SEEDS)
    want = ck.spec_walk_plain(case["buckets"], case["seeds"], K, cs.SPEC_STEPS)
    rows, iterations, second = cs.spec_reads(case["buckets"], case["seeds"], K, want[0])
    case["rows"] = iterations
    bound = cs.bound_fields(cs.bound_ms(cs.nbytes(case["seeds"], *want) + int(rows.sum())
                                        * case["buckets"][0].numel() * 4))
    print(json.dumps({"spec_case": {**case["sizes"], "steps": int(want[2].sum()),
                                    "row_reads": iterations, "second_probe_rows": second,
                                    "distinct_rows": int(rows.sum()), **bound}}), flush=True)
    for turn, (name, _, _, version) in enumerate(order):
        print(json.dumps({"kernel": "spec_walk", "version": name, "turn": turn,
                          **time_spec(cs, version, case, want, name)}), flush=True)
    for table in (case["buckets"], cs.word_path_table(case["buckets"])):
        info = ck.kernel_info(table, SPEC_SEEDS)
        print(json.dumps({"kernel": "spec_walk", "version": ".", "variant": info["path"],
                          **time_spec(cs, ck, case, want, f"{info['path']} path", table),
                          **info}), flush=True)
    if ablate:
        kern = ck._kernels
        for variant, lib in spec_libraries().items():
            saved, kern._lib = kern._lib, lib
            try:
                row = {**time_spec(cs, ck, case, want, variant),
                       **ck.kernel_info(case["buckets"], SPEC_SEEDS)}
            finally:
                kern._lib = saved
            print(json.dumps({"kernel": "spec_walk", "version": ".", "variant": variant,
                              **row}), flush=True)
    del case, want
    torch.cuda.empty_cache()


def ablated_libraries() -> dict:
    """{variant: (ctk_segment_reduce of csrc/count.cu so changed, tile rows)}."""
    from corticall_tpu_torch.ops import _kernels
    out_dir = os.path.join(HERE, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_kernels.CSRC_DIR, "count.cu")) as f:
        original = f.read()
    procs, libs = [], []
    for index, (edits, _) in enumerate(ABLATIONS.values()):
        src = original
        for old, new in edits:
            if src.count(old) < 1:
                raise RuntimeError(f"count.cu no longer has {old!r}")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"count_ablate{index}.cu")
        with open(path, "w") as f:
            f.write(src)
        libs.append(os.path.join(out_dir, f"count_ablate{index}.so"))
        procs.append(subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I",
                                       _kernels.CSRC_DIR, "-shared", "-o", libs[-1], path]))
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed")
    out = {}
    for (name, (_, tile_rows)), path in zip(ABLATIONS.items(), libs):
        fn = ctypes.CDLL(path).ctk_segment_reduce
        fn.argtypes = list(_kernels._SIGNATURES["ctk_segment_reduce"])
        fn.restype = ctypes.c_int
        out[name] = (fn, tile_rows)
    return out


def ablated_run(fn, tile_rows: int, scratch, epoch: list):
    """A launch helper for an ablated library, with its own scratch."""
    from corticall_tpu_torch.ops import _kernels

    def run(keys, cov, masks, ok, oc, om, count):
        epoch[0] += 1
        tiles = (scratch.numel() - 2) // 2
        _kernels.check(fn(keys.data_ptr(), cov.data_ptr(), masks.data_ptr(), keys.shape[0],
                          keys.shape[1], ok.data_ptr(), oc.data_ptr(), om.data_ptr(),
                          count.data_ptr(), scratch.data_ptr(), tiles, epoch[0],
                          _kernels.stream(keys.device)), "segment_reduce (ablated)")
    return run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", help="another checkout whose kernels are timed in turns")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--spec", action="store_true", help="time the speculative walk alone")
    ap.add_argument("--count", action="store_true", help="time the device build's count alone")
    ap.add_argument("--spec-bases", type=int, default=SPEC_BASES)
    ap.add_argument("--spec-seeds", type=int, default=SPEC_SEEDS)
    ap.add_argument("--device", help="where --inputs-only builds (default: the card)")
    ap.add_argument("--inputs-only", action="store_true")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from corticall_tpu_torch.device import require_cuda, resolve

    if args.inputs_only:
        case = spec_case(resolve(args.device), args.spec_bases, args.spec_seeds)
        print(json.dumps({"inputs": case["sizes"]}), flush=True)
        return 0
    dev = require_cuda()
    this = (".", *load_ops(HERE))
    order = [this, this]
    if args.repo:
        other = (os.path.relpath(os.path.abspath(args.repo), HERE),
                 *load_ops(os.path.abspath(args.repo)))
        order = [other, this, this, other]
    if args.spec:
        spec_main(cs, order, this[3], dev, args.ablate)
        print(cs.nvidia_smi(), flush=True)
        return 0
    if args.count:
        count_main(cs, order, dev, args.ablate)
        print(cs.nvidia_smi(), flush=True)
        return 0

    cases = reduce_cases(dev)
    for turn, (name, bdv, _, _) in enumerate(order):
        for what, case in cases.items():
            row = time_reduce(cs, bdv.reduce_kernel, case, f"{name} segment_reduce, {what}")
            print(json.dumps({"kernel": "segment_reduce", "version": name, "turn": turn,
                              "input": what, **row}), flush=True)
    if args.ablate:
        scratch = torch.zeros(2 + 2 * (CHUNK_ROWS // 1024 + 2), dtype=torch.int64, device=dev)
        epoch = [0]
        for variant, (fn, tile_rows) in ablated_libraries().items():
            run = ablated_run(fn, tile_rows, scratch, epoch)
            for what, case in cases.items():
                row = time_reduce(cs, run, case, f"{variant}, {what}",
                                  check="wrong outputs" not in variant)
                print(json.dumps({"kernel": "segment_reduce", "variant": variant,
                                  "tile_rows": tile_rows, "input": what, **row}), flush=True)
    del cases
    torch.cuda.empty_cache()

    case = lookup_case(dev)
    print(json.dumps({"lookup_case": {"records": RECORDS, "slots": case["slots"].numel(),
                                      "max_probe": case["max_probe"],
                                      "host_build_s": case["host_build_s"]}}), flush=True)
    for queries in case["queries"]:
        for turn, (name, _, ht, _) in enumerate(order):
            print(json.dumps({"kernel": "ht_lookup", "version": name, "turn": turn,
                              **time_lookup(cs, ht, case, queries)}), flush=True)
        ht = this[2]
        for form in ("key", "tag"):
            for group in ht.GROUPS:
                print(json.dumps({"kernel": "ht_lookup", "version": ".", "variant": "ablation",
                                  **time_lookup(cs, ht, case, queries, form, group)}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
