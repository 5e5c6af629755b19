"""Device choice for the port, and the device-resident graph.

`resolve`: the CUDA card unless the caller asks for the CPU.  An entry point
given `device=None` runs on the card and raises when none is visible; only an
explicit "cpu" (or `torch.device("cpu")`) runs the plain PyTorch twins.  On a
CUDA device every kernel wrapper launches its kernel or raises.  Nothing here
falls back silently.

`DeviceGraph`: counterpart of corticall_tpu/device.py::DeviceGraph (:21-88),
a graph's records as tensors on a device (k-mer words and coverages as uint32
bit patterns in int32 tensors, edge bytes as uint8) plus the open-addressing
slot table of ops/hashtable.py and its interleaved probe table for
`find_records` (built once, beside the slots), and the walk tables of
ops/cuckoo.py, built once a colour set.  `warmup_async` (a TPU compiler
warm-up) is not ported.  The ops modules import `resolve` from here, so
DeviceGraph imports them inside its methods.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """An explicit device (str or torch.device), or the CUDA device when
    `device` is None (RuntimeError when no card is visible)."""
    return require_cuda() if device is None else torch.device(device)


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("corticall_tpu_torch: no CUDA device is available; "
                           "pass device='cpu' to run the plain twins")
    return torch.device("cuda")


@dataclass
class DeviceGraph:
    kmer_size: int
    num_colors: int
    kmers: torch.Tensor      # int32 [N, W] canonical, record order (uint32 bits)
    coverages: torch.Tensor  # int32 [N, C] (uint32 bits)
    edges: torch.Tensor      # uint8 [N, C]
    slots: torch.Tensor      # int32 [M] hash slots -> record index
    max_probe: int
    probe: torch.Tensor      # int32 [M, E] the slots' probe table (hashtable.probe_table)
    sample_names: tuple = ()
    _walk_tables: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def num_records(self) -> int:
        return self.kmers.shape[0]

    @property
    def device(self) -> torch.device:
        return self.kmers.device

    @classmethod
    def from_graph(cls, g, device=None) -> "DeviceGraph":
        """A CortexGraph's records on `device` (default: the CUDA card, and
        RuntimeError without one; "cpu" runs the plain twins)."""
        return cls.from_arrays(g.kmer_size, g.kmers, g.coverages, g.edges,
                               tuple(g.sample_names), device=device)

    @classmethod
    def from_arrays(cls, kmer_size: int, kmers: np.ndarray, coverages: np.ndarray,
                    edges: np.ndarray, sample_names=(), device=None) -> "DeviceGraph":
        from .ops import hashtable as ht
        from .ops import kmer as tk
        device = resolve(device)
        table = ht.build(kmers)
        keys = tk.words_tensor(kmers, device)
        slots = torch.from_numpy(table.slots).to(device)
        return cls(kmer_size, coverages.shape[1], keys, tk.words_tensor(coverages, device),
                   torch.from_numpy(np.ascontiguousarray(edges, dtype=np.uint8)).to(device),
                   slots, table.max_probe, ht.probe_table(slots, keys), tuple(sample_names))

    def find_records(self, canon_queries: torch.Tensor) -> torch.Tensor:
        """int32 [B, W] canonical k-mers -> int32 [B] record indices (-1
        miss), through `ctk_ht_lookup` over the probe table on the card."""
        from .ops import hashtable as ht
        return ht.lookup(self.slots, self.kmers, canon_queries, self.max_probe, self.probe)

    def combined_edges(self, colors) -> torch.Tensor:
        """OR of the colours' edge bytes -> uint8 [N] (union-over-colours
        neighbours, TraversalEngine.java:152-157)."""
        e = self.edges[:, list(colors)]
        out = e[:, 0].clone()
        for i in range(1, e.shape[1]):
            out |= e[:, i]
        return out

    def combined_coverage(self, colors) -> torch.Tensor:
        """Total coverage over a colour set: int32 [N] holding the uint32
        sum, wrapping as the JAX package's uint32 sum does."""
        from .ops import kmer as tk
        cov = tk.from_bits32(self.coverages[:, list(colors)]).sum(dim=1)
        return tk.to_bits32(cov & tk.M32)

    def walk_buckets(self, colors) -> torch.Tensor:
        """The walk table of a colour set, int32 [NB, 2, W+1] on the graph's
        device, built once a colour set: primary-biased buckets with the
        combined edge byte in each entry's tag (ops/cuckoo.build_walk_table),
        for walk_forward_spec."""
        key = tuple(colors)
        if key not in self._walk_tables:
            from .ops import cuckoo as ck
            kmers = self.kmers.cpu().numpy().view(np.uint32)
            edges = self.combined_edges(key).cpu().numpy()
            self._walk_tables[key] = ck.build_walk_table(kmers, edges, device=self.device).buckets
        return self._walk_tables[key]
