"""A tiny CPU rehearsal of chip_smoke.py's phases 9 (walk_table_vs_plain),
10 (build_device), 11 (link_walk_vs_plain) and 12 (mesh_vs_plain): a 20 kbp
bench graph, 300 walks of 64 steps, three small read sets and chunks of 2^14
bases; a small trio with threaded links, its ROI-like seeds and 400 linked
walks of 256 steps; the sharded graph on four CPU shards, the trio's
partitions and calls.  The kernel launches are replaced by fakes that write their plain
twins' results and count a launch, and the CUDA events by host timers.  It
runs in fresh processes, since chip_smoke.py makes jax and corticall_tpu
unimportable in the process that imports it.  The phases' own checks (twins
against the outputs, launch counts, identical graphs and counts, linked
contigs against the native walker) must pass, and what phases 9 and 11 count
for their bounds must equal a count made one query and one lane at a
time."""

import json
import os
import subprocess
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))


def scalar_reads(g, bench, seed_strs) -> dict:
    """The slots, key rows and bucket rows that phase 9's lookups and walks
    read, counted one query and one lane at a time on strings and numpy
    words, for the phase's vectorised counts to be held against."""
    import numpy as np
    import torch

    from corticall_tpu_torch import kmer as km
    from corticall_tpu_torch.device import DeviceGraph
    from corticall_tpu_torch.ops import cuckoo as ck, jump as tj
    from corticall_tpu_torch.ops.placement import np_h2, np_hash_words

    k = 47
    dg = DeviceGraph.from_arrays(k, g.kmers, g.coverages, g.edges, device="cpu")
    slots, m = dg.slots.numpy(), dg.slots.shape[0]
    miss = g.kmers.copy()
    miss[:, -1] ^= np.uint32(1)
    queries = np.concatenate([g.kmers, miss])
    slots_read, sectors = set(), 0
    for q, h in zip(queries, np_hash_words(queries)):
        # the kernel's rounds: LOOKUP_GROUP slots aligned on the group, one
        # 32-byte sector a round of two 16-byte entries
        first = int(h) & (m - 1)
        rounds = set()
        for p in range(dg.max_probe):
            slot = (int(h) + p) & (m - 1)
            slots_read.add(slot)
            rounds.add((first - first % 2 + p + first % 2) // 2)
            r = slots[slot]
            if r < 0 or (g.kmers[r] == q).all():
                break
        sectors += len(rounds)
    key_rows = sum(1 for slot in slots_read if slots[slot] >= 0)

    edges = np.ascontiguousarray(g.edges[:, 0])
    buckets, _ = tj.scatter_buckets(g.kmers, bench["nb"], bench["entry"], "cpu", payload=edges)
    bases = ck.spec_walk_plain(buckets, torch.from_numpy(bench["seeds"].view(np.int32)), k,
                               64)[0].numpy()
    table = buckets.numpy().view(np.uint32)
    mask = np.uint32(table.shape[0] - 1)
    rows_read, iterations, second = set(), 0, 0
    for lane, s in enumerate(seed_strs):
        probe = False
        for t in range(bases.shape[0]):
            canon = min(s, km.revcomp(s))
            words = km.pack_codes(km.strings_to_codes([canon]), k)
            h = np_hash_words(words)
            idx = int((np_h2(h) if probe else h)[0] & mask)
            rows_read.add(idx)
            iterations += 1
            second += probe
            held = any(e[-1] >> 31 and (e[:-1] == words[0]).all() for e in table[idx])
            b = int(bases[t, lane])
            if b >= 0:
                s, probe = s[1:] + "ACGT"[b], False
            elif not held and not probe:
                probe = True
            else:
                break
    return {"slots": len(slots_read), "key_rows": key_rows, "bucket_rows": len(rows_read),
            "iterations": iterations, "second_probes": second, "sectors": sectors}


def rehearse() -> dict:
    """Phases 9 and 10 at a tiny size on the CPU; returns their fields."""
    import time

    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(TESTS))
    import chip_smoke as cs
    from corticall_tpu_torch import kmer as km, simulate as sim
    from corticall_tpu_torch.demo import build_bench_graph
    from corticall_tpu_torch.ops import build_device as bdv, cuckoo as ck, hashtable as ht
    from corticall_tpu_torch.ops import jump as tj, kmer as tk

    def lookup_kernel(table, keys, queries, max_probe, out, group=ht.LOOKUP_GROUP):
        out.copy_(ht.lookup_rounds_plain(table, keys, queries, max_probe, group))
        ht.LAUNCHES["ht_lookup"] += 1

    def spec_walk_kernel(buckets, seeds, k, num_steps, *out):
        for o, w in zip(out, ck.spec_walk_plain(buckets, seeds, k, num_steps)):
            o.copy_(w)
        ck.LAUNCHES["spec_walk"] += 1

    def kernel_info(buckets, batch):
        # what ctk_spec_walk_info reports, for a card of 132 SMs
        align = 16 if (buckets.shape[2] - 1) % 2 else 8
        vec = buckets.shape[1] == 2 and buckets.data_ptr() % align == 0
        return {"path": "vector" if vec else "words", "threads": 128, "registers": 32,
                "local_bytes": 0, "blocks_per_sm": 16, "walks_per_thread": 1,
                "resident_lanes": 128 * 16 * 132, "waves": 1}

    def count_kernel_info(k, lib=None):
        # what ctk_count_windows_info reports at W = 3, for a card of 132 SMs
        return {"threads": 256, "registers": 64, "blocks_per_sm": 4, "local_bytes": 0,
                "shared_bytes": 55864, "tile_windows": 4096, "sms": 132}

    def lookup(slots, keys, queries, max_probe, table=None):
        out = torch.empty(queries.shape[0], dtype=torch.int32)
        ht.lookup_kernel(ht.probe_table(slots, keys) if table is None else table, keys, queries,
                         max_probe, out)
        return out

    def walk_forward_spec(buckets, seeds, k, num_steps):
        b = seeds.shape[0]
        out = (torch.empty((ck.spec_iters(num_steps), b), dtype=torch.int8),
               torch.empty(b, dtype=torch.bool), torch.empty(b, dtype=torch.int32))
        ck.spec_walk_kernel(buckets, seeds, k, num_steps, *out)
        return out

    def entry_timers(kernels=None, entries=None):
        # the fakes launch nothing: each launch helper's call on the host clock
        helpers = {"ht_lookup": (ht, "lookup_kernel"), "segment_reduce": (bdv, "reduce_kernel"),
                   "count_windows": (bdv, "count_kernel")}
        timers = {name: [] for name in entries}
        saved = {name: getattr(*helpers[name]) for name in entries}

        def timed(name, fn):
            def run(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                dt = (time.perf_counter() - t0) * 1e3
                timers[name].append(lambda: dt)
                return out
            return run

        for name, fn in saved.items():
            setattr(*helpers[name], timed(name, fn))
        return (timers, dict.fromkeys(entries, 0),
                lambda: [setattr(*helpers[name], fn) for name, fn in saved.items()])

    fake_timers(cs, torch)
    cs.entry_timers = entry_timers
    cs.SPEC_STEPS = 64
    ht.lookup_kernel, ht.lookup = lookup_kernel, lookup
    ck.spec_walk_kernel, ck.walk_forward_spec = spec_walk_kernel, walk_forward_spec
    ck.kernel_info = kernel_info
    install_count_fakes(bdv, tk, torch)
    bdv.count_kernel_info = count_kernel_info
    small = 1 << 14                             # chunks small enough to merge
    bdv.CHUNK_BASES = small
    bdv.DeviceCounter.__init__.__defaults__ = (small, None)
    bdv.count_kmers_device.__defaults__ = (small, None)

    cpu = torch.device("cpu")
    g, genome = build_bench_graph(47, 20000)
    nb, bucket_of, pos_of = tj.place(g.kmers)
    rng = np.random.default_rng(11)
    starts = rng.integers(0, len(genome) - 47, 300)
    seed_strs = [genome[i:i + 47] for i in starts]
    bench = {"g": g, "genome": genome, "nb": nb, "entry": bucket_of * 2 + pos_of,
             "seeds": km.pack_codes(km.strings_to_codes(seed_strs), 47)}
    walk = cs.walk_table_phase(cpu, bench)
    walk["scalar_reads"] = scalar_reads(g, bench, seed_strs)
    reads = {s: sim.simulate_reads([genome[:8000]], 5, 150, 0.002, seed=i)
             for i, s in enumerate(("kid", "mom", "dad"))}
    build = cs.build_phase(cpu, reads, genome)
    return {"walk": walk, "build": build}


def install_count_fakes(bdv, tk, torch):
    """The count kernels' launch helpers replaced by fakes that write their
    plain twins' results and count a launch, and their wrappers by ones that
    call the fakes on CPU tensors."""

    def count_kernel(bases, own_lo, own_hi, k, keys, masks, count):
        want = bdv.count_windows_plain(bases, own_lo, own_hi, k)
        m = want[0].shape[0]
        keys[:m] = want[0]
        masks[:m] = want[1]
        count.fill_(m)
        bdv.LAUNCHES["count_windows"] += 1

    def reduce_kernel(keys, cov, masks, *out_count):
        *out, count = out_count
        want = bdv.reduce_tiles_plain(keys, cov, masks)
        n = want[0].shape[0]
        for o, w in zip(out, want):
            o[:n] = w
        count.fill_(n)
        bdv.LAUNCHES["segment_reduce"] += 1

    def count_windows(bases, own_lo, own_hi, k):
        rows = max(0, min(own_hi, bases.shape[0] - k + 1) - own_lo)
        keys = torch.empty((rows, tk.words(k)), dtype=torch.int32)
        masks = torch.empty(rows, dtype=torch.uint8)
        count = torch.empty(1, dtype=torch.int32)
        bdv.count_kernel(bases, own_lo, own_hi, k, keys, masks, count)
        return keys[:int(count)], masks[:int(count)]

    def segment_reduce(keys, cov, masks):
        out = (torch.empty_like(keys), torch.empty_like(cov), torch.empty_like(masks))
        count = torch.empty(1, dtype=torch.int32)
        bdv.reduce_kernel(keys, cov, masks, *out, count)
        return tuple(x[:int(count)] for x in out)

    bdv.count_kernel, bdv.count_windows = count_kernel, count_windows
    bdv.reduce_kernel, bdv.segment_reduce = reduce_kernel, segment_reduce


def fake_timers(cs, torch):
    import time

    def event_ms(fn, reps):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    torch.cuda.synchronize = torch.cuda.empty_cache = lambda *a: None
    cs.event_ms = event_ms


def link_trio(k=31):
    """The port's graph of a small trio whose child has a hub sequence every
    150 bases, the child's links threaded from 300 bp reads, and ROI-like
    seeds (a graph of child k-mers, sample "kid")."""
    import numpy as np

    from corticall_tpu_torch import fixtures
    from corticall_tpu_torch.io import links as tlinks

    rng = np.random.default_rng(5)
    mom = "".join(rng.choice(list("ACGT"), 3000))
    dad = mom[:1500] + "".join(rng.choice(list("ACGT"), 1500))
    hub = "".join(rng.choice(list("ACGT"), k + 12))
    kid = hub.join((mom[:1600] + dad[1600:])[i:i + 150] for i in range(0, 3000, 150))
    g = fixtures.build_graph({"mom": [mom], "dad": [dad], "kid": [kid]}, k)
    links = tlinks.build_links(g, {"kid": [kid[i:i + 300] for i in range(0, len(kid) - 300, 60)]},
                               "kid")
    rois = fixtures.build_graph({"kid": [kid[i:i + k] for i in range(0, len(kid) - k, 53)]}, k)
    return {"graph": g, "rois": rois, "links": [links], "haplotypes": {"mom": mom, "dad": dad}}


def scalar_link_reads(out, seeds, num_steps) -> dict:
    """The bucket rows, records, CSR offsets and pool rows the bulk linked
    walks read, their walk steps, and the steps' operations (by
    chip_smoke.link_step_ops, with the twin's store sizes), counted one lane
    at a time on strings from the twin's output."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from corticall_tpu_torch import kmer as km
    from corticall_tpu_torch.ops import walk_links as wl
    from corticall_tpu_torch.ops.placement import np_h2, np_hash_words

    g, links = out["graph"], out["links"]
    k = g.kmer_size
    walker = wl.LinkedWalker(g, [g.color_for_sample("kid")], links, device="cpu")
    sizes = torch.full((num_steps, seeds.shape[0]), -1, dtype=torch.int8)
    emitted = wl.walk_links_forward_plain(*walker.args, seeds, k, num_steps,
                                          store_sizes=sizes)[0].numpy()
    sizes = sizes.numpy()
    mask = np.uint32(walker.args[0].shape[0] - 1)
    edges, offsets, fw = (walker.args[i].numpy() for i in (1, 2, 5))
    rows, recs, steps, per_step = set(), set(), 0, []
    for lane, words in enumerate(seeds):
        cur = km.codes_to_string(km.unpack_words(words[None], k)[0])
        for t in range(num_steps):
            canon = min(cur, km.revcomp(cur))
            h = np_hash_words(km.pack_codes(km.strings_to_codes([canon]), k))
            rows.update((int(h[0] & mask), int(np_h2(h)[0] & mask)))
            rec = g.find_record(cur)
            cnt = gated = succ = 0
            if rec >= 0:
                recs.add(rec)
                flipped = canon != cur
                cnt = min(int(offsets[rec + 1] - offsets[rec]), wl.MAX_ADD)
                gated = sum(bool(fw[offsets[rec] + j]) != flipped for j in range(cnt))
                succ = bin(int(edges[rec]) >> 4 if flipped else int(edges[rec]) & 0xF).count("1")
            per_step.append((t == 0, cnt, gated, sizes[t - 1, lane] if t else 0,
                             sizes[t, lane], succ))
            steps += 1
            v = int(emitted[t, lane])
            if v < 0:
                break
            cur = cur[1:] + "ACGT"[v & 3]
    pool = sum(min(int(offsets[r + 1] - offsets[r]), wl.MAX_ADD) for r in recs)
    first, *counts = (torch.tensor(np.asarray(c, dtype=np.int64)) for c in zip(*per_step))
    ops = cs.link_step_ops(cs.link_kmer_ops(seeds.shape[1], walker.args[0].shape[1]),
                           first.bool(), *counts)
    return {"bucket_rows": len(rows), "records": len(recs),
            "offsets": len(recs | {r + 1 for r in recs}), "pool_rows": pool,
            "walk_steps": steps, "ops": int(ops.sum())}


def rehearse_links() -> dict:
    """Phase 11 at a tiny size on the CPU; returns its fields and the
    scalar count of the bulk walks' reads."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(TESTS))
    import chip_smoke as cs
    from corticall_tpu_torch.ops import walk_links as wl

    def link_walk_kernel(*args):
        *tables, seeds, k, num_steps, stream, overflow, steps, junctions = args
        want = wl.walk_links_forward_plain(*tables, seeds, k, num_steps)
        stream.fill_(-1)
        stream[:, :num_steps] = want[0].t()
        for o, w in zip((overflow, steps, junctions), want[1:]):
            o.copy_(w)
        wl.LAUNCHES["link_walk"] += 1

    def walk_links_forward(*args, device=None):
        *arrays, k, num_steps = args
        dev = wl._device(arrays, device)
        tables = wl.link_tables(*arrays[:6], k, dev)
        seeds = wl._tensor(arrays[6], dev)
        b = seeds.shape[0]
        bufs = (torch.empty((b, wl.emit_pitch(num_steps)), dtype=torch.int8),
                torch.empty(b, dtype=torch.uint8), torch.empty(b, dtype=torch.int32),
                torch.empty(b, dtype=torch.int32))
        wl.link_walk_kernel(*tables, seeds, k, num_steps, *bufs)
        return bufs[0][:, :num_steps].t(), bufs[1].view(torch.bool), bufs[2], bufs[3]

    def kernel_info(which, w, batch, buckets=None):
        return {"threads": 32 if batch < 4 * 132 * 32 else 128, "registers": 0,
                "blocks_per_sm": 0, "warps_per_sm": 0, "local_bytes": 0}

    torch.set_num_threads(1)        # many tiny ops: threads only contend with other workers
    fake_timers(cs, torch)
    real = wl.link_walk_kernel, wl.walk_links_forward
    wl.link_walk_kernel, wl.walk_links_forward = link_walk_kernel, walk_links_forward
    wl.kernel_info = kernel_info
    cs.LINK_SEEDS, cs.JUMP_STEPS, cs.PF_MAX_WALK, cs.LINK_TWIN_CHUNK = 400, 256, 512, 160
    out = link_trio()
    phase = cs.link_walk_phase(torch.device("cpu"), out)
    n = out["graph"].num_records
    seeds = out["graph"].kmers[np.arange(cs.LINK_SEEDS) * 17 % n].view(np.int32)
    wl.link_walk_kernel, wl.walk_links_forward = real
    phase["scalar_reads"] = scalar_link_reads(out, torch.from_numpy(seeds), cs.JUMP_STEPS)
    return phase


def test_link_walk_phase_rehearses_on_cpu(tmp_path):
    code = (f"import json, sys; sys.path.insert(0, {TESTS!r}); "
            "import test_torch_smoke_phases as t; print(json.dumps(t.rehearse_links()))")
    env = {**os.environ, "CORTICALL_TPU_TESTS_ON_TPU": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["launches"] == 2
    assert out["mismatches"] == 0 and out["max_abs_err"] == 0.0
    assert out["twin_lanes"] == out["lanes"] == 400 and out["twin_note"] == "every lane"
    assert out["junctions_resolved"] > 0 and out["bulk_junctions"] > 0
    assert out["decoded_seeds"] == out["roi_seeds"] and out["roi_steps"] > 0
    assert out["scalar_reads"] == out["reads"]
    assert out["bound"]["bound_ms"] > 0 and out["truncated_links"] == 0
    assert out["roi_bound"]["bound_ms"] > 0 and out["roi_reads"]["ops"] > 0
    for key in ("roi_needy", "bulk_needy"):
        needy = out[key]
        assert 0 < needy["needy_steps"] < needy["walk_steps"] and needy["needy_share"] < 0.25
    assert out["bulk_needy"]["walk_steps"] == out["reads"]["walk_steps"]   # every lane's
    assert out["kernel_shapes"]["roi"]["threads"] == 32


def test_walk_table_and_build_phases_rehearse_on_cpu(tmp_path):
    code = (f"import json, sys; sys.path.insert(0, {TESTS!r}); "
            "import test_torch_smoke_phases as t; print(json.dumps(t.rehearse()))")
    env = {**os.environ, "CORTICALL_TPU_TESTS_ON_TPU": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    walk, build = out["walk"], out["build"]
    assert walk["launches"] == {"ht_lookup": 1, "spec_walk": 1}
    assert walk["queries"] == 2 * walk["records"] and walk["found"] >= walk["records"]
    assert walk["steps"] > 0 and walk["iterations"] == 64 + 16 + 32
    assert walk["scalar_reads"] == {
        "slots": walk["lookup_slots_read"], "key_rows": walk["lookup_key_rows_read"],
        "bucket_rows": walk["bucket_rows_read"], "iterations": walk["active_iterations"],
        "second_probes": walk["second_probe_rows"], "sectors": walk["lookup_sectors"]}
    assert 0 < walk["second_probe_rows"] < walk["active_iterations"]
    assert walk["lookup_err"] == walk["spec_err"] == 0.0
    assert walk["spec_rows_per_s"] > 0 and walk["lookup_sectors_per_s"] > 0
    assert walk["spec_kernel"] == walk["spec_paths"][0]
    assert [(p["path"], p["err"]) for p in walk["spec_paths"]] == [("vector", 0.0),
                                                                  ("words", 0.0)]
    assert all(p["ms"] > 0 and p["waves"] == 1 for p in walk["spec_paths"])
    assert [(a["form"], a["group"], a["err"]) for a in walk["lookup_ablation"]] == [
        (form, group, 0.0) for form in ("key", "tag") for group in (1, 2, 4, 8)]
    from corticall_tpu_torch.ops.hashtable import entry_words
    assert walk["probe_table_bytes"] == 4 * entry_words(3, walk["probe_form"]) * walk["slots"]
    assert walk["lookup_path"]["path_ms"] > 0
    assert build["chunk"]["windows_err"] == build["chunk"]["reduce_err"] == 0.0
    assert build["merge"]["err"] == 0.0 and build["merge"]["unique"] <= build["merge"]["rows"]
    path = build["reduce_path"]
    assert path["launches"] == build["launches"]["segment_reduce"] == len(path["launch_ms"])
    assert path["path_ms"] > 0
    for key in ("lookup_bound", "spec_bound"):
        assert walk[key]["bound_by"] == "bytes" and walk[key]["bound_ms"] > 0
    assert build["identical"] and set(build["samples"]) == {"kid", "mom", "dad"}
    # every trio sample spans two chunks: windows and reductions of each
    # chunk, and the merges
    assert build["launches"]["count_windows"] >= 7
    assert build["launches"]["segment_reduce"] > build["launches"]["count_windows"]
    count = build["count_path"]
    assert count["launches"] == build["launches"]["count_windows"] == len(count["launch_ms"])
    assert count["path_ms"] > 0
    for sample in build["samples"].values():
        assert set(sample["device_parts_s"]) == {"encode", "transfer", "windows", "sort", "reduce",
                                                 "merge", "finish", "counter", "fence", "graph"}
        assert abs(sample["parts_share"] - 1) <= 0.05
    assert set(build["genome"]["device_parts_s"]) == {"encode", "transfer", "windows", "sort",
                                                      "reduce", "merge", "finish", "counter"}
    assert build["chunk"]["unique"] <= build["chunk"]["windows"] <= build["chunk"]["bases"]
    assert build["chunk"]["windows_bound"]["bound_by"] == "bytes"


def rehearse_mesh() -> dict:
    """Phase 12 at a tiny size on the CPU: phase 6's bench-graph fields
    for 300 seeds of 64 steps, the link trio with its partitions, and the
    calls.vcf that one Caller writes for them, as phase 4 writes it; the
    four sharding wrappers replaced by twin-backed fakes that count a
    launch.  Returns the phase's fields."""
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(TESTS))
    import chip_smoke as cs
    from corticall_tpu_torch import kmer as km
    from corticall_tpu_torch.caller.call import Caller
    from corticall_tpu_torch.commands import core as tcore
    from corticall_tpu_torch.demo import build_bench_graph
    from corticall_tpu_torch.models.reference_index import IndexedReference
    from corticall_tpu_torch.ops import jump as tj, sharding as sh

    def fake(name):
        def launch(*args):
            sh.LAUNCHES[name] += 1
            return cs.MESH_TWINS[name](*args)
        return launch

    import time

    def entry_timers():
        # the fakes launch nothing: each wrapper's call on the host clock
        timers = {name: [] for name in cs.PATH_ENTRIES}
        saved = {name: getattr(sh, name) for name in cs.PATH_ENTRIES}

        def timed(name, fn):
            def run(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                dt = (time.perf_counter() - t0) * 1e3
                timers[name].append(lambda: dt)
                return out
            return run

        for name, fn in saved.items():
            setattr(sh, name, timed(name, fn))
        return (timers, dict.fromkeys(cs.PATH_ENTRIES, 0),
                lambda: [setattr(sh, name, fn) for name, fn in saved.items()])

    torch.set_num_threads(1)
    fake_timers(cs, torch)
    cs.queued_ms = cs.event_ms
    cs.entry_timers = entry_timers
    for name in cs.MESH_TWINS:
        setattr(sh, name, fake(name))
    cs.SPEC_STEPS, cs.PF_MAX_WALK = 64, 256
    cpu = torch.device("cpu")
    g, genome = build_bench_graph(47, 20000)
    nb, bucket_of, pos_of = tj.place(g.kmers)
    starts = np.random.default_rng(11).integers(0, len(genome) - 47, 300)
    seed_strs = [genome[i:i + 47] for i in starts]
    bench = {"g": g, "nb": nb, "entry": bucket_of * 2 + pos_of, "seed_strs": seed_strs,
             "seeds": km.pack_codes(km.strings_to_codes(seed_strs), 47)}
    out = link_trio()
    graph, rois, links = out["graph"], out["rois"], out["links"]
    out["partitions"] = tcore.partition(graph, rois, links=links, max_walk=cs.PF_MAX_WALK,
                                        device=cpu)
    refs = {p: IndexedReference({"chr1": h}) for p, h in out["haplotypes"].items()}
    caller = Caller(graph, rois, out["partitions"], backgrounds=["mom", "dad"],
                    references=refs, links=links, device=cpu)
    with tempfile.TemporaryDirectory() as wd:
        caller.write_outputs(os.path.join(wd, "calls.vcf"), os.path.join(wd, "acct.txt"))
        calls_vcf = open(os.path.join(wd, "calls.vcf"), "rb").read()
    phase = cs.mesh_phase(cpu, out, bench, {"refs": refs, "calls_vcf": calls_vcf})
    phase["partitions"] = len(out["partitions"])
    # the step bounds of eight walks of which none is live: each reads its
    # active flag (the linked step its slot too) and writes its stream byte
    idle = sh.WalkState.start(torch.zeros((8, 3), dtype=torch.int32),
                              torch.zeros(8, dtype=torch.uint8), 4)
    idle_links = sh.LinkState.start(idle.cur, idle.active, 4)
    none = sh.route_plain(idle.cur, idle.active, 47, 4)
    phase["idle_bounds"] = [
        cs.walk_step_bound(idle, idle, none, torch.zeros((0, sh.WALK_ANSWER), dtype=torch.int32)),
        cs.link_step_bound([idle_links], [idle_links], [none],
                           [torch.zeros((0, sh.LINK_ANSWER), dtype=torch.int32)], 1)]
    return phase


def test_mesh_phase_rehearses_on_cpu(tmp_path):
    code = (f"import json, sys; sys.path.insert(0, {TESTS!r}); "
            "import test_torch_smoke_phases as t; print(json.dumps(t.rehearse_mesh()))")
    env = {**os.environ, "CORTICALL_TPU_TESTS_ON_TPU": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["shards"] == 4 and sum(out["shard_records"]) == out["records"]
    assert all(out["launches"].values()) and out["walk_launches"]["link_step"] == 0
    # a step on one device: one route, one answer, one walk or linked step
    assert out["walk_launches"]["shard_walk_step"] == out["exchange"]["steps"]
    assert out["launches"]["route"] == out["launches"]["shard_answer"] == (
        out["launches"]["shard_walk_step"] + out["launches"]["link_step"])
    assert out["link_exchange"]["steps"] == out["launches"]["link_step"]
    assert out["single_device_identical"] and out["linked_identical"] and out["vcf_identical"]
    assert out["skewed_queries"] == 300 and out["skewed_advanced"] == out["skewed_checked_live"]
    assert out["calls"] > 0 and out["partitions"] > 1 and out["junctions"] > 0
    assert out["exchange"]["bytes"] > 0 and out["steps"] > 0
    assert out["idle_bounds"] == [[2 * 8, 0], [(1 + 4 + 1) * 8, 0]]
    for name in ("route", "shard_answer", "shard_walk_step", "link_step"):
        row = out["kernels"][name]
        assert row["max_abs_err"] == 0.0 and row["bound_ms"] > 0 and row["bytes"] > 0
        assert row["bound_by"] == ("bytes" if row["bytes"] / 3.35e12 >= row["ops"] / 67e12
                                   else "operations")
        assert (row["library_ms"] is not None) == (name == "route")
        assert out["checked_calls"][name] + out["link_checked_calls"][name] > 0
    assert out["kernels"]["link_step"]["step"] == 1
    # one linked step launch a step over the four shards' walks, one state on one device
    link = out["kernels"]["link_step"]
    assert link["states"] == 1 and link["path_launches"] == out["launches"]["link_step"]
    for name in ("route", "shard_answer"):
        row, walk = out["kernels"][name], out["kernels"][name]["walk_step0"]
        assert walk["max_abs_err"] == 0.0 and walk["queries"] > row["queries"] > 0
    most = link["most_needy"]
    assert most["needy_walks"] >= link["needy_walks"] and most["needy_walks"] > 0
    assert most["max_abs_err"] == 0.0 and most["bound_ms"] > 0
    for name in ("route", "shard_answer", "shard_walk_step", "link_step"):
        row = out["kernels"][name]
        assert row["path_ms"] > 0 and row["path_launches"] > 0 and row["path_late"] == 0


def test_link_probe_builds_its_inputs_on_cpu(tmp_path):
    """corticall_tpu_torch/tools/link_probe.py parses its arguments and
    builds its inputs (a 0.05 Mbp trio's graph, links, ROI and bulk seeds)
    on the CPU with --inputs-only."""
    probe = os.path.join(os.path.dirname(TESTS), "corticall_tpu_torch", "tools", "link_probe.py")
    proc = subprocess.run([sys.executable, probe, "--inputs-only", "--device", "cpu", "--mbp",
                           "0.05", "--bulk", "256"], capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    sizes = json.loads(proc.stdout.strip().splitlines()[-1])["inputs"]
    assert sizes["bulk_walks"] == 256 and sizes["device"] == "cpu"
    assert sizes["roi_walks"] == 2 * sizes["roi_kmers"] > 0
    assert sizes["records"] > sizes["roi_kmers"] and sizes["link_pool_rows"] > 0


def test_table_probe_builds_its_spec_inputs_on_cpu(tmp_path):
    """corticall_tpu_torch/tools/table_probe.py parses its arguments and
    builds the speculative walk's inputs (a 20 kbp bench graph's walk table
    and 256 seeds) on the CPU with --spec --inputs-only."""
    probe = os.path.join(os.path.dirname(TESTS), "corticall_tpu_torch", "tools",
                         "table_probe.py")
    proc = subprocess.run([sys.executable, probe, "--spec", "--inputs-only", "--device", "cpu",
                           "--spec-bases", "20000", "--spec-seeds", "256"], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    sizes = json.loads(proc.stdout.strip().splitlines()[-1])["inputs"]
    assert sizes["seeds"] == 256 and sizes["device"] == "cpu"
    assert sizes["records"] > 19000 and sizes["buckets"] >= sizes["records"] // 2


# `python -m corticall_tpu_torch` for phase 14's subprocess, with the
# rehearsal's route to the SW pre-score's twin and without jax
CLI_SHIM = ("import runpy, sys; sys.modules['jax'] = None; sys.modules['corticall_tpu'] = None; "
            "from corticall_tpu_torch.models import contig_aligner as tca; "
            "tca._device_ok = lambda device: True; tca.MIN_DEVICE_BATCH = 1; "
            "runpy.run_module('corticall_tpu_torch', run_name='__main__')")


def rehearse_cross(workdir) -> dict:
    """Phases 13 (cross) and 14 (cli) on the CPU after phase 4's path at
    20 kbp with 3 DNMs a child: the SW, Tesserae and count kernels replaced by fakes that run
    their plain twins and count a launch, and the card's routes taken on the
    CPU (the SW pre-score on every batch, Tesserae on the device class), so
    that the phases' launch checks, hashes, links order and byte comparisons
    run as they do on the card."""
    import torch

    sys.path.insert(0, os.path.dirname(TESTS))
    import chip_smoke as cs
    from corticall_tpu_torch.caller import call
    from corticall_tpu_torch.models import contig_aligner as tca
    from corticall_tpu_torch.ops import build_device as bdv, kmer as tk
    from corticall_tpu_torch.ops import sw_device as tsw, tesserae_torch as tt

    torch.set_num_threads(2)
    fake_timers(cs, torch)
    install_count_fakes(bdv, tk, torch)
    sw, ts = tsw.sw_banded, tt.tesserae_fused

    def sw_banded(*args, **kw):
        out = sw(*args, **kw)
        tsw.LAUNCHES += 1
        return out

    def tesserae_fused(*args, **kw):
        out = ts(*args, **kw)
        tt.LAUNCHES += 1
        return out

    tsw.sw_banded, tt.tesserae_fused = sw_banded, tesserae_fused
    tca._device_ok, tca.MIN_DEVICE_BATCH = (lambda device: True), 1
    make = call.Caller._make_tesserae
    call.Caller._make_tesserae = lambda self, mode, *a: make(
        self, "device" if mode == "auto" else mode, *a)
    cs.CLI_COMMAND = [sys.executable, "-c", CLI_SHIM]
    cs.PF_DNMS = 3
    cpu = torch.device("cpu")
    mp = cs.run_main_path(cpu, 0.02)
    cs.check_main_path(mp)
    cross, kid2 = cs.cross_phase(cpu, mp, workdir)
    return {"main_launches": mp["launches"], "cross": cross,
            "cli": cs.cli_phase(cpu, mp, kid2, workdir),
            "demo": mp["demo"], "haplotype": cs.haplotype_phase(cpu, mp)}


def test_cross_and_cli_phases_rehearse_on_cpu(tmp_path):
    code = (f"import json, sys; sys.path.insert(0, {TESTS!r}); "
            "import test_torch_smoke_phases as t; "
            f"print(json.dumps(t.rehearse_cross({str(tmp_path / 'wd')!r})))")
    env = {**os.environ, "CORTICALL_TPU_TESTS_ON_TPU": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    cross, cli = out["cross"], out["cli"]
    assert cross["progeny"] == ["kid2"] and cross["parent_graphs_equal_phase_4"]
    assert cross["shared_stages"] == ["build_clean_mom", "build_clean_dad"]
    assert "build_clean_kid2" in cross["kid2_stage_s"] and "call" in cross["kid2_stage_s"]
    assert all(cross["launches"][name] > 0 for name in
               ("sw_banded", "tesserae", "count_windows", "segment_reduce"))
    assert cross["calls"] > 0 and cross["kmer_venn"]["tp"] > 0
    assert cli["checks"] == dict.fromkeys(
        ("clean", "partition", "align_contigs", "calls_vcf", "accounting",
         "filter_calls_records", "subprocess_align_contigs"), True)
    assert cli["subprocess_exit"] == 0 and cli["calls"] == cross["calls"]
    assert cli["launches"]["Build"]["count_windows"] > 0
    assert cli["launches"]["AlignContigs"]["sw_banded"] > 0
    assert cli["launches"]["Call"]["sw_banded"] > 0 and cli["launches"]["Call"]["tesserae"] > 0
    assert set(cli["seconds"]) >= {"Build", "Clean", "Partition", "AlignContigs", "Call",
                                   "FilterCalls", "subprocess_align_contigs"}
    # phase 4 through the flagship demo, and phase 16's haplotype mode
    assert out["demo"]["metric"] == "pf_scale_cross_linked_pipeline_wallclock"
    assert out["demo"]["calls"] > 0 and out["main_launches"]["tesserae"] > 0
    hap = out["haplotype"]
    assert hap["mode"] == "haplotype" and hap["calls"] > 0
    assert hap["launches"]["tesserae"] > 0
    assert {"build_graph_s", "partition_s", "call_s"} <= set(hap["stage_s"])


def test_wide_form_sections_are_ones_the_gate_sends_past_the_register_form():
    """chip_smoke's phase-3 sections for the kernel's wide form: each past
    the register form's cells, admitted by TesseraeDevice's budget gate, the
    last the gate's largest."""
    import numpy as np

    sys.path.insert(0, os.path.dirname(TESTS))
    import chip_smoke as cs
    from corticall_tpu_torch.ops import tesserae_torch as tt

    cells = []
    for query, targets in cs.wide_form_sections(np.random.default_rng(3)):
        lens = [len(t) for t in targets.values()]
        width = max(lens) + 1
        assert tt.launch_config(len(lens), width)[0]
        assert tt.section_bytes(len(query), lens) <= tt.TesseraeDevice.HBM_BUDGET_BYTES
        cells.append(len(lens) * width)
    assert cells == [256 * 513, 600 * 257, tt.MAX_WIDE_CELLS]


# ---- phase 15: the sharded graph across processes ---------------------------

def install_mesh_fakes() -> None:
    """The four sharding wrappers replaced by fakes that run their plain
    twins (chip_smoke.MESH_TWINS) and count a launch, as rehearse_mesh's;
    in a worker process of dryrun_multihost."""
    sys.path.insert(0, os.path.dirname(TESTS))
    import torch

    import chip_smoke as cs
    from corticall_tpu_torch.ops import sharding as sh

    torch.set_num_threads(1)

    def fake(name):
        def launch(*args):
            sh.LAUNCHES[name] += 1
            return cs.MESH_TWINS[name](*args)
        return launch

    for name in cs.MESH_TWINS:
        setattr(sh, name, fake(name))


def worker_shim(fail_rank) -> str:
    """The worker command's code: the fakes installed, then the dry run's
    worker; rank `fail_rank` exits with code 3 before it joins the group."""
    return (f"import json, sys; sys.path.insert(0, {TESTS!r}); "
            "import test_torch_smoke_phases as t; t.install_mesh_fakes(); "
            f"sys.exit(3) if int(sys.argv[2]) == {fail_rank!r} else None; "
            "from corticall_tpu_torch.tools import dryrun_multihost as dm; "
            "print(json.dumps(dm.worker(int(sys.argv[2]), int(sys.argv[3]), "
            "int(sys.argv[4]), sys.argv[5])))")


def rehearse_process_mesh(fail_rank=None) -> dict:
    """Phase 15 at a tiny size on the CPU: the link trio's reference from
    chip_smoke.trio_reference on four in-process CPU shards (512 walks of 64
    steps, the ROI seeds' linked walks of 256), then process_mesh_phase's
    two workers (eight global shards, gloo) with the fakes installed in
    each.  Returns the phase's fields."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(TESTS))
    import chip_smoke as cs
    from corticall_tpu_torch import kmer as km
    from corticall_tpu_torch.parallel import mesh as pm
    from corticall_tpu_torch.tools import dryrun_multihost as dm

    torch.set_num_threads(1)
    cs.SPEC_STEPS, cs.PF_MAX_WALK, cs.MESH_TRIO_SEEDS = 64, 256, 512
    out = link_trio()
    graph, rois = out["graph"], out["rois"]
    child = graph.color_for_sample(rois.sample_name(0))
    parents = [graph.color_for_sample(p) for p in ("mom", "dad")]
    mesh = pm.ShardMesh(["cpu"] * cs.MESH_SHARDS)
    sgt = pm.ShardedGraph.from_graph(graph, mesh)
    slt = pm.ShardedLinks.from_graph(graph, out["links"], sgt)
    cks = sorted(rois.kmer_string(i) for i in range(rois.num_records))
    both = cks + [km.revcomp(s) for s in cks]
    b2 = len(both)
    both = km.pack_codes(km.strings_to_codes(both + both[:(-b2) % cs.MESH_SHARDS]),
                         graph.kmer_size)
    run = pm.make_sharded_linked_walk_run(mesh, sgt, slt, [child], graph.kmer_size,
                                          cs.PF_MAX_WALK)
    linked = run(both, np.ones(len(both), dtype=bool))
    ref = cs.trio_reference(mesh, sgt, graph, child, parents, both, linked, b2)
    dm.WORKER_COMMAND = [sys.executable, "-c", worker_shim(fail_rank)]
    return cs.process_mesh_phase(torch.device("cpu"), out, ref)


def test_process_mesh_phase_rehearses_on_cpu(tmp_path):
    """The phase's fields: gloo, two processes of four shards, every part's
    seconds, the bytes it exchanged and the fakes' launches summed over the
    workers (one route a step), its outputs equal to the reference."""
    code = (f"import json, sys; sys.path.insert(0, {TESTS!r}); "
            "import test_torch_smoke_phases as t; print(json.dumps(t.rehearse_process_mesh()))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["backend"] == "gloo" and out["processes"] == 2 and out["global_shards"] == 8
    assert out["devices"] == ["cpu", "cpu"] and out["shards_a_process"] == 4
    assert out["identical_to_phase_12"] and out["shards_identical"]
    assert sum(out["byte_range_records"]) == out["records"] == sum(out["owned_records"])
    assert out["walk_seeds"] == 512 and out["steps"] > 0 and out["rois"] > 0
    for part in ("init", "load", "full_load", "walk", "rois", "links_build", "links"):
        assert out["seconds"][part] >= 0
    assert all(out["bytes"][part] > 0 for part in ("load", "walk", "linked", "all"))
    assert out["bytes"]["all"] >= out["bytes"]["walk"] + out["bytes"]["linked"]
    launches = out["launches"]
    assert all(launches.values())
    assert launches["route"] == launches["shard_walk_step"] + launches["link_step"]
    assert launches["shard_answer"] <= launches["route"]


def test_process_mesh_phase_fails_with_a_worker(tmp_path):
    """A worker that exits with an error fails the phase (and so the run)."""
    code = (f"import json, sys; sys.path.insert(0, {TESTS!r}); "
            "import test_torch_smoke_phases as t; t.rehearse_process_mesh(fail_rank=1)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(tmp_path))
    assert proc.returncode != 0
    assert "worker 1 failed (exit 3)" in proc.stderr
