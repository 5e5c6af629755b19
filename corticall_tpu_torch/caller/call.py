"""Call with the port's two kernels: Tesserae and the banded-SW pre-score.

`Caller` is corticall_tpu.caller.call.Caller with the two device entry points
replaced: `_make_tesserae` builds the port's TesseraeDevice, and
`label_targets` runs the port's align_contigs.  Everything else — sectioning,
haplotype assembly, variant extraction, VCF — is the JAX package's host code.
"""

from __future__ import annotations

from corticall_tpu.caller import call as _call
from corticall_tpu.models.tesserae import Tesserae

from ..device import resolve
from ..models.contig_aligner import align_contigs
from ..ops.tesserae_torch import TesseraeDevice


class Caller(_call.Caller):
    def __init__(self, *args, device=None, **kwargs):
        """As corticall_tpu's Caller, plus `device` (default: CUDA when
        present).  tesserae="auto" runs TesseraeDevice on a CUDA device and
        the host oracle otherwise; "device" runs TesseraeDevice on `device`
        (its plain twin on the CPU)."""
        self.device = resolve(device)
        super().__init__(*args, **kwargs)

    def _make_tesserae(self, mode: str, del_, eps, rho, term):
        if mode == "auto":
            mode = "device" if self.device.type == "cuda" else "host"
        if mode == "device":
            return TesseraeDevice(del_, eps, rho, term, device=self.device)
        return Tesserae(del_, eps, rho, term)

    def label_targets(self, targets: dict) -> dict:
        """corticall_tpu's label_targets (Call.java:1920-1944 ranking: length
        desc, NM asc) with the port's batched aligner."""
        by_back: dict = {}
        order = []
        for c in targets:
            back = c.split(":")[0]
            if back in self.references:
                by_back.setdefault(back, {})[c] = targets[c]
                order.append(c)
        results: dict = {}
        for back, items in by_back.items():
            stats: dict = {}
            aligned = align_contigs(items, {back: self.references[back]},
                                    band=64, stats=stats, device=self.device)
            self.align_stats["device_scored_windows"] = (
                self.align_stats.get("device_scored_windows", 0)
                + stats.get("device_scored_windows", 0))
            self.align_stats["host_tracebacks"] = (
                self.align_stats.get("host_tracebacks", 0)
                + stats.get("host_tracebacks", 0))
            for c, al in aligned.items():
                results[c] = sorted(al, key=lambda s: (-(s.end - s.start),
                                                       s.nm))

        labelled: dict = {}
        target_num = 0
        for c in order:
            back = c.split(":")[0]
            ss = results.get(c, [])
            if ss:
                s = ss[0]
                label = (f"{back}:{s.contig}:{s.start}-{s.end}:"
                         f"{'-' if s.negative else '+'}")
                labelled[label] = targets[c]
            else:
                labelled[f"{back}:unknown{target_num}"] = targets[c]
                target_num += 1
        return labelled
