"""Tesserae sections: Call's alignment of a child's haplotype segment against
its parents' candidate segments, one section after another, one caller.

The sizes are a record (the mix's `record`, a file beside this one): every
section that Call sent to `TesseraeDevice.align` in a run of the port on
the card, with its query length and each target's parent and length, those
that the aligner's budget gate sent to its host oracle included.  Set-up
draws the configuration's trio from the seed and cuts one section of each
recorded size around the child's DNMs and crossovers: the query is the
child's segment across the event, each target its parent's segment over the
same stretch, centred on it, its flanks shifted by up to `jitter` bases from
the third target on (Call's alternative candidates differ in their ends).
A seed changes the bases, the sites and the order, never the sizes.  Each
request is one `TesseraeDevice.align(query, targets)` with the Caller's
default parameters, as caller/call.py's section loop sends it; the list is
served in turn, and the window closes at the end of a turn (`cycle`), so
that every run serves whole turns of the record.  After the window the
plain reference (benchmark/reference/tesserae.py) aligns a sample of the
sections drawn from the seed, the largest by cells, work and targets among them,
and every served instance of those is compared: the path exactly and the
log-likelihood by its relative gap.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark.counts import bounds
from benchmark.lib import genome
from benchmark.reference import tesserae as ref
from corticall_tpu_torch.ops.tesserae_torch import TesseraeDevice

PARENTS = {"mom": "mother", "dad": "father"}


@dataclass
class State:
    hmm: tuple
    sections: list                     # (query, {name: target})
    bound_ms: list
    check: list                        # section indices the reference judges
    limits: dict
    aligner: object = None
    served: list = field(default_factory=list)     # (section, llk, path) of judged sections
    timers: dict = field(default_factory=dict)

    @property
    def cycle(self) -> int:
        return len(self.sections)


def load_record(path: str) -> list:
    """[(query length, [(parent, target length)])] a recorded section, from
    a CSV of `partition,route,query,targets` rows whose targets are
    space-separated `<background>:<length>` (lines from '#' on skipped)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("partition,"):
                continue
            _, _, query, targets = line.split(",")
            rows.append((int(query), [(PARENTS[t.split(":")[0]], int(t.split(":")[1]))
                                      for t in targets.split()]))
    return rows


def record_path(mix: dict) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), mix["record"])


def make_sections(trio: genome.Trio, record: list, jitter: int, seed: int) -> tuple:
    """A section of each recorded size, cut from the seed's trio around its
    events, in an order drawn from the seed: (sections, the record row of
    each)."""
    rng = np.random.default_rng([seed, 3])
    order = rng.permutation(len(record)).tolist()
    out = []
    for r in order:
        lq, targets_of = record[r]
        site = trio.sites[int(rng.integers(len(trio.sites)))]
        q0 = site.pos - int(rng.integers(lq // 5, 4 * lq // 5 + 1))
        query = genome.to_string(trio.child[site.chrom][q0:q0 + lq])
        p0 = trio.parent_pos(site.chrom, q0)
        targets, seen = {}, {}
        for t, (parent, length) in enumerate(targets_of):
            shift = int(rng.integers(-jitter, jitter + 1)) if t >= 2 else 0
            start = max(0, p0 - (length - lq) // 2 + shift)
            seq = getattr(trio, parent)[site.chrom][start:start + length]
            i = seen[parent] = seen.get(parent, -1) + 1
            targets[f"{parent}_{i}"] = genome.to_string(seq)
        out.append((query, targets))
    return out, order


def section_bound_ms(query: str, targets: dict) -> float:
    return bounds.tesserae_bound(len(query), len(targets),
                                 max(len(t) for t in targets.values()))[0]


def make_inputs(config: dict, mix: dict, seed: int) -> State:
    """The cell's inputs for `seed`, without the program: the sections, their
    bounds, and the sections the reference judges (the largest by cells, by
    work and by targets, and a sample drawn from the seed)."""
    t0 = time.perf_counter()
    trio = genome.make_trio(config, seed)
    record = load_record(record_path(mix))
    sections, _ = make_sections(trio, record, int(mix["jitter"]), seed)
    timers = {"genome_and_sections_s": time.perf_counter() - t0}
    cells = [len(t) * (max(map(len, t.values())) + 1) for _, t in sections]
    work = [len(q) * sum(map(len, t.values())) for q, t in sections]
    widest = max(range(len(sections)), key=lambda i: (len(sections[i][1]), len(sections[i][0])))
    largest = {int(np.argmax(cells)), int(np.argmax(work)), widest}
    rng = np.random.default_rng([seed, 5])
    rest = np.setdiff1d(np.arange(len(sections)), sorted(largest))
    n_more = min(len(rest), int(mix["check_sections"]) - len(largest))
    check = sorted(largest | set(rng.choice(rest, n_more, replace=False).tolist()))
    return State(tuple(mix["hmm"]), sections, [section_bound_ms(q, t) for q, t in sections],
                 check, dict(mix["limits"]), timers=timers)


def setup(config: dict, mix: dict, seed: int, device, traced: bool) -> State:
    state = make_inputs(config, mix, seed)
    t0 = time.perf_counter()
    state.aligner = TesseraeDevice(*state.hmm, device=device)
    for query, targets in state.sections:       # warm-up: every section once
        state.aligner.align(query, targets)
    state.timers["warmup_s"] = time.perf_counter() - t0
    return state


def request(state: State, i: int):
    """One section; its route read from the aligner's own counter of the
    sections its budget gate sent to the host oracle."""
    s = i % len(state.sections)
    query, targets = state.sections[s]
    host_before = state.aligner.host_sections
    t0 = time.perf_counter()
    path = state.aligner.align(query, targets)
    dt = time.perf_counter() - t0
    if s in state.check:
        state.served.append((s, state.aligner.llk, path))
    if state.aligner.host_sections != host_before:
        return dt, {"sections": 1, "host_sections": 1, "host_section_s": dt}
    return dt, {"sections": 1, "device_sections": 1, "device_section_s": dt,
                "tesserae_bound_ms": state.bound_ms[s]}


def release(state: State) -> None:
    state.aligner = None


def judge(state: State, answers: dict) -> dict:
    """{"paths_wrong": (count, limit), "llk_gap": (largest relative gap,
    limit)} of served (section, llk, path) against the reference's
    `answers` {section: (path, llk)}."""
    wrong, gap = 0, 0.0
    for s, llk, path in state.served:
        if s not in answers:
            continue
        want_path, want_llk = answers[s]
        wrong += [tuple(x) for x in path] != [tuple(x) for x in want_path]
        gap = max(gap, abs(llk - want_llk) / max(1.0, abs(want_llk)))
    return {"paths_wrong": (wrong, state.limits["paths_wrong"]),
            "llk_gap": (gap, state.limits["llk_gap"])}


def check(state: State, device) -> dict:
    served = {s for s, _, _ in state.served}
    answers = {s: ref.align(*state.sections[s], state.hmm) for s in state.check if s in served}
    return judge(state, answers)


def control(config: dict, mix: dict, seed: int, device, calls: int) -> dict:
    """The numbers a run compares, with the reference computed in bfloat16
    in the program's place: each judged section served once."""
    state = make_inputs(config, mix, seed)
    for s in state.check:
        path, llk = ref.align(*state.sections[s], state.hmm, "bfloat16")
        state.served.append((s, llk, path))
    answers = {s: ref.align(*state.sections[s], state.hmm) for s in state.check}
    return {name: value for name, (value, _) in judge(state, answers).items()}
