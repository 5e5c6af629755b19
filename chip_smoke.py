#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (corticall_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each (progress goes to stderr):

1. environment: GPU name and power limit (nvidia-smi), torch and CUDA
   versions, and whether the native C++ core loads (probed in a child
   process, so an incompatible library is reported, not a crash);
2. build: nvcc compiles corticall_tpu_torch/csrc/*.cu for sm_90a;
3. kernels against their plain PyTorch twins on the card: banded SW at the
   production pre-score shape (B=256, Q=4096, S=8192, band 512) and at
   B=1024, Q=512, S=1024, band 64; Tesserae on 8 recombinant sections of
   2-16 targets of 500-4000 bp.  Outputs must be bit-identical; the times
   are CUDA-event kernel times and synchronized host times of the twin;
4. the main path: a 2 Mbp / 2-chromosome / 20-DNM trio (demo_pf_cross's
   cross, 20x reads of 150 bp) through corticall_tpu_torch.pipeline
   .run_pipeline, with every kernel launch counted, and the calls scored
   against the simulation truth (demo_pf_cross.evaluate's k-mer Venn);
5. every SW batch and Tesserae section that the pipeline sent to a kernel,
   replayed through the plain twin on the card; any difference fails.

Then one JSON line with each kernel's route, source, launches, error and
times, the nvidia-smi line, and the result line.  Any failure raises: the
run exits non-zero and prints no result, as it does without a CUDA device or
outside the repository.  jax is never imported.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None          # the port must run without jax
REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from corticall_tpu_torch.device import require_cuda  # noqa: E402
from corticall_tpu_torch.ops import _kernels  # noqa: E402
from corticall_tpu_torch.ops import sw_device as tsw  # noqa: E402
from corticall_tpu_torch.ops import tesserae_torch as tt  # noqa: E402

SW_SHAPES = [(256, 4096, 8192, 512), (1024, 512, 1024, 64)]
TESSERAE_TARGETS = [2, 3, 4, 6, 8, 11, 16, 16]
CALLER_PARAMS = (0.35, 0.90, 6e-4, 1e-3)     # Caller's del_, eps, rho, term
PF_MBP, PF_CHROMS, PF_DNMS, PF_K = 2.0, 2, 20, 47
PF_DIVERGENCE, PF_COVERAGE, PF_READLEN, PF_ERR = 0.003, 20.0, 150, 0.002


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def native_probe() -> dict:
    """Load the native core in a child process: a library built for another
    CPU may die with SIGILL, which must be reported, not crash this run."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from corticall_tpu import native; print(native.available())" % REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    return {"returncode": proc.returncode,
            "available": proc.returncode == 0 and proc.stdout.strip() == "True",
            "stderr": proc.stderr.strip()[-400:]}


def sw_pairs(rng, batch, qlen, slen, band):
    """Subject rows and queries copied from them near the band's diagonal,
    with 3% substitutions, one indel a row, ragged ends (code 4) and one
    all-pad query."""
    s = rng.integers(0, 4, (batch, slen)).astype(np.int32)
    off = rng.integers(0, band // 4, batch)
    q = np.take_along_axis(s, off[:, None] + np.arange(qlen)[None, :], 1).copy()
    mut = rng.random(q.shape) < 0.03
    q[mut] = (q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    for b in range(batch):
        p = int(rng.integers(qlen // 4, 3 * qlen // 4))
        n = int(rng.integers(1, 8))
        if b % 2:
            q[b, p:qlen - n] = q[b, p + n:].copy()
        else:
            q[b, p + n:] = q[b, p:qlen - n].copy()
            q[b, p:p + n] = rng.integers(0, 4, n)
        q[b, int(rng.integers(qlen // 2, qlen + 1)):] = 4
        s[b, int(rng.integers(qlen, slen + 1)):] = 4
    q[-1] = 4
    return q, s


def mutate(rng, seq, rate):
    m = rng.random(len(seq)) < rate
    out = seq.copy()
    out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return out


def tesserae_sections(rng):
    """Recombinant sections: mutated copies of one haplotype as targets, the
    query a mosaic of three of them with 0.5% substitutions."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for s_count in TESSERAE_TARGETS:
        n = int(rng.integers(500, 4001))
        base = rng.integers(0, 4, n)
        copies = [mutate(rng, base, 0.02) for _ in range(s_count)]
        cut = sorted(int(x) for x in rng.integers(n // 5, 4 * n // 5, 2))
        pick = rng.integers(0, s_count, 3)
        query = np.concatenate([copies[pick[0]][:cut[0]],
                                copies[pick[1]][cut[0]:cut[1]],
                                copies[pick[2]][cut[1]:]])
        query = mutate(rng, query, 0.005)
        targets = {}
        for i, c in enumerate(copies):
            a, b = int(rng.integers(0, 40)), n - int(rng.integers(0, 40))
            targets[f"t{i}"] = lut[c[a:b]].tobytes().decode()
        out.append((lut[query].tobytes().decode(), targets))
    return out


def event_ms(fn, reps):
    """Mean CUDA-event time of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def sw_diff(got, want) -> float:
    """Max |score| difference; raises unless all three outputs are
    bit-identical."""
    g_s, g_q, g_e = (x.cpu().numpy() for x in got)
    w_s, w_q, w_e = (x.cpu().numpy() for x in want)
    if not (np.array_equal(g_s.view(np.int32), w_s.view(np.int32))
            and np.array_equal(g_q, w_q) and np.array_equal(g_e, w_e)):
        bad = int(np.sum((g_s != w_s) | (g_q != w_q) | (g_e != w_e)))
        raise AssertionError(f"sw_banded disagrees with its plain twin in {bad} rows")
    return float(np.max(np.abs(g_s - w_s))) if len(g_s) else 0.0


def tesserae_diff(got, want) -> float:
    """|max_r| difference; raises unless cells, n and max_r's bits agree."""
    (g_r, g_cells, g_n), (w_r, w_cells, w_n) = got, want
    g_n, w_n = int(g_n), int(w_n)
    g_r, w_r = np.float32(g_r.item()), np.float32(w_r.item())
    if g_n != w_n or not np.array_equal(g_cells[:g_n].cpu().numpy(),
                                        w_cells[:w_n].cpu().numpy()):
        raise AssertionError("tesserae kernel's traceback disagrees with its plain twin")
    if g_r.view(np.int32) != w_r.view(np.int32):
        raise AssertionError(f"tesserae max_r {g_r!r} != plain {w_r!r}")
    return float(abs(g_r - w_r))


def run_main_path(dev, mbp):
    """Simulate the trio, run the port's pipeline with every kernel launch
    counted and every kernel input recorded, and score the calls."""
    from demo_pf_cross import evaluate, make_cross
    from corticall_tpu import simulate as sim
    from corticall_tpu.models.reference_index import IndexedReference
    from corticall_tpu_torch.pipeline import run_pipeline

    t0 = time.perf_counter()
    prng = np.random.default_rng(42)
    mom, dad = make_cross(prng, mbp, PF_CHROMS, PF_DIVERGENCE)
    res = sim.simulate_haploid_child(mom, dad, parents=("mom", "dad"), mu=2.0,
                                     num_variants=PF_DNMS, k=PF_K, seed=7)
    reads = {
        "kid": sim.simulate_reads(list(res["child"].values()), PF_COVERAGE,
                                  PF_READLEN, PF_ERR, seed=11),
        "mom": sim.simulate_reads(list(mom.values()), PF_COVERAGE, PF_READLEN,
                                  PF_ERR, seed=12),
        "dad": sim.simulate_reads(list(dad.values()), PF_COVERAGE, PF_READLEN,
                                  PF_ERR, seed=13),
    }
    refs = {"mom": IndexedReference(mom), "dad": IndexedReference(dad)}
    simulate_s = time.perf_counter() - t0
    log(f"simulated the trio in {simulate_s:.1f} s")

    sw_sent, ts_sent = [], []
    sw_kernel, ts_kernel = tsw.sw_banded, tt.tesserae_fused

    def sw_recorded(q, s, band=128):
        out = sw_kernel(q, s, band)
        sw_sent.append(((q, s, band), out))
        return out

    def ts_recorded(*args):
        out = ts_kernel(*args)
        ts_sent.append((args, out))
        return out

    tsw.sw_banded, tt.tesserae_fused = sw_recorded, ts_recorded
    tsw.LAUNCHES = tt.LAUNCHES = 0
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
            t0 = time.perf_counter()
            out = run_pipeline(wd, reads, child="kid", parents=["mom", "dad"],
                               references=refs, k=PF_K, min_coverage=2,
                               max_walk=2000, resume=False, device=dev,
                               log=lambda *a: log(" ".join(map(str, a))))
            torch.cuda.synchronize()
            pipeline_s = time.perf_counter() - t0
        launches = {"sw_banded": tsw.LAUNCHES, "tesserae": tt.LAUNCHES}
    finally:
        tsw.sw_banded, tt.tesserae_fused = sw_kernel, ts_kernel
    ev = evaluate(out["variants"], res["truth_vcf"], mom, dad, PF_K,
                  recombs=res.get("recombs"))
    return {"out": out, "res": res, "ev": ev, "launches": launches,
            "sw_sent": sw_sent, "ts_sent": ts_sent, "simulate_s": simulate_s,
            "pipeline_s": pipeline_s}


def check_main_path(mp) -> None:
    if not mp["launches"]["sw_banded"] or not mp["launches"]["tesserae"]:
        raise AssertionError(f"a kernel of the main path never launched: {mp['launches']}")
    if not mp["out"]["variants"]:
        raise AssertionError("the pipeline made no calls")
    if mp["ev"]["kmer_venn"]["tp"] < 1:
        raise AssertionError(f"no call matches the truth: {mp['ev']['kmer_venn']}")


def replay(mp) -> dict:
    """Every SW batch and Tesserae section the pipeline sent to a kernel,
    through the plain twin on the same device; raises on any difference."""
    t0 = time.perf_counter()
    sw_err = ts_err = 0.0
    for (q, s, band), got in mp["sw_sent"]:
        sw_err = max(sw_err, sw_diff(got, tsw.banded_sw_scores(q, s, band)))
    for args, got in mp["ts_sent"]:
        ts_err = max(ts_err, tesserae_diff(got, tt.tesserae_full(*args)))
    return {"sw_err": sw_err, "ts_err": ts_err, "sw_batches": len(mp["sw_sent"]),
            "sw_windows": sum(int(a[0].shape[0]) for a, _ in mp["sw_sent"]),
            "tesserae_sections": len(mp["ts_sent"]),
            "seconds": time.perf_counter() - t0}


def main() -> int:
    dev = require_cuda()
    t_all = time.perf_counter()

    # ---- 1. environment ----------------------------------------------------
    smi = nvidia_smi()
    native = native_probe()
    emit("environment", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         native_core=native)
    if not native["available"]:
        raise RuntimeError(f"the native C++ core does not load here: {native}")

    # ---- 2. build ----------------------------------------------------------
    built = _kernels.build(ptxas_verbose=True)
    _kernels.library()
    ptxas = [ln.strip() for ln in built["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=round(built["seconds"], 3),
         library=os.path.relpath(built["path"], REPO), ptxas=ptxas)

    # ---- 3. kernels against the plain twins at the smoke shapes ------------
    rng = np.random.default_rng(20260)
    sw_err, sw_times = 0.0, []
    for batch, qlen, slen, band in SW_SHAPES:
        q, s = sw_pairs(rng, batch, qlen, slen, band)
        qt, st = torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)
        got = tsw.sw_banded(qt, st, band)
        torch.cuda.synchronize()
        want = tsw.banded_sw_scores(qt, st, band)     # doubles as warm-up
        sw_err = max(sw_err, sw_diff(got, want))
        k_ms = event_ms(lambda: tsw.sw_banded(qt, st, band), 5)
        p_ms, _ = host_ms(lambda: tsw.banded_sw_scores(qt, st, band))
        cells = batch * qlen * band
        sw_times.append({"batch": batch, "q": qlen, "s": slen, "band": band,
                         "kernel_ms": round(k_ms, 4), "plain_ms": round(p_ms, 2),
                         "kernel_gcups": round(cells / k_ms / 1e6, 3)})
        log(f"sw {batch}x{qlen}x{slen} band {band}: kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.1f} ms")
    emit("sw_banded_vs_plain", bit_identical=True, max_abs_err=sw_err,
         shapes=sw_times)

    sections = tesserae_sections(rng)
    ts_err, ts_rows = 0.0, []
    small = min(range(len(sections)), key=lambda i: len(sections[i][0]))
    warm = tt.section_inputs(sections[small][0], list(sections[small][1].values()),
                             CALLER_PARAMS, dev)
    tt.tesserae_fused(*warm)
    tt.tesserae_full(*warm)
    for query, targets in sections:
        args = tt.section_inputs(query, list(targets.values()), CALLER_PARAMS, dev)
        k_ms = event_ms(lambda: tt.tesserae_fused(*args), 3)
        got = tt.tesserae_fused(*args)
        p_ms, want = host_ms(lambda: tt.tesserae_full(*args))
        ts_err = max(ts_err, tesserae_diff(got, want))
        ts_rows.append({"targets": len(targets), "query": len(query),
                        "width": args[1].shape[1] + 1, "kernel_ms": round(k_ms, 3),
                        "plain_ms": round(p_ms, 1), "path_cells": int(got[2])})
        log(f"tesserae S={len(targets)} L={len(query)}: kernel {k_ms:.2f} ms, "
            f"plain {p_ms:.0f} ms")
    emit("tesserae_vs_plain", identical=True, max_abs_err=ts_err, sections=ts_rows)

    # ---- 4. the main path --------------------------------------------------
    mp = run_main_path(dev, PF_MBP)
    out, res, ev, launches = mp["out"], mp["res"], mp["ev"], mp["launches"]
    stats = out["stats"]
    call = stats["call"]
    emit("main_path", genome_mbp=PF_MBP, chromosomes=PF_CHROMS, dnms=PF_DNMS,
         k=PF_K, simulate_s=round(mp["simulate_s"], 2),
         pipeline_s=round(mp["pipeline_s"], 2),
         stage_s=out["stages"], graph_records=out["graph"].num_records,
         rois=out["rois"].num_records, partitions=len(out["partitions"]),
         walk_kernel=stats["partition"].get("walk_kernel"),
         calls=len(out["variants"]),
         calls_after_filter=len(out["filtered_variants"]),
         contig_aligner=call["contig_aligner"], tesserae=call.get("tesserae"),
         call_breakdown=call["call_breakdown"], launches=launches,
         kmer_venn=ev["kmer_venn"], strict_recovered=ev["strict_recovered"],
         truth=len(res["truth_vcf"]))
    check_main_path(mp)

    # ---- 5. what the pipeline sent to the kernels, through the twins -------
    rp = replay(mp)
    sw_err, ts_err = max(sw_err, rp["sw_err"]), max(ts_err, rp["ts_err"])
    emit("main_path_replay", sw_batches=rp["sw_batches"],
         sw_windows=rp["sw_windows"], tesserae_sections=rp["tesserae_sections"],
         identical=True, seconds=round(rp["seconds"], 2))

    prod = sw_times[0]
    print(json.dumps({"kernels": [
        {"name": "sw_banded", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/sw_banded.cu",
         "replaces": "corticall_tpu/ops/sw_device.py:366",
         "launches": launches["sw_banded"], "max_abs_err": sw_err,
         "ms": prod["kernel_ms"], "plain_ms": prod["plain_ms"]},
        {"name": "tesserae", "route": "cuda",
         "source": "corticall_tpu_torch/csrc/tesserae.cu",
         "replaces": "corticall_tpu/ops/tesserae_jax.py:200",
         "launches": launches["tesserae"], "max_abs_err": ts_err,
         "ms": round(sum(r["kernel_ms"] for r in ts_rows), 3),
         "plain_ms": round(sum(r["plain_ms"] for r in ts_rows), 1)},
    ]}), flush=True)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
