#!/usr/bin/env python3
"""Times of ctk_segment_reduce (csrc/count.cu) and ctk_ht_lookup
(csrc/walk_table.cu) on one GPU, at chip_smoke.py's phase 9 and 10 sizes.

    python3 corticall_tpu_torch/tools/table_probe.py [--repo DIR] [--ablate]

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
REPS = 5

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


def load_ops(repo: str):
    """(build_device, hashtable) of `repo`'s corticall_tpu_torch; another
    checkout's package is loaded as `other_corticall_tpu_torch`."""
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
    return (importlib.import_module(f"{name}.ops.build_device"),
            importlib.import_module(f"{name}.ops.hashtable"))


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
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from corticall_tpu_torch.device import require_cuda

    dev = require_cuda()
    this = (".", *load_ops(HERE))
    order = [this, this]
    if args.repo:
        other = (os.path.relpath(os.path.abspath(args.repo), HERE),
                 *load_ops(os.path.abspath(args.repo)))
        order = [other, this, this, other]

    cases = reduce_cases(dev)
    for turn, (name, bdv, _) in enumerate(order):
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
        for turn, (name, _, ht) in enumerate(order):
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
