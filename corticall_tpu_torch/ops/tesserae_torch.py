"""Tesserae mosaic-alignment DP: plain PyTorch twin + CUDA kernel wrapper.

Counterpart of corticall_tpu/ops/tesserae_jax.py.  `tesserae_scan`,
`tesserae_traceback` and `tesserae_full` are the PyTorch twins of the JAX
functions of the same names (a Python loop over query columns of [S, W]
tensor ops, then the packed-traceback walk); `tesserae_fused` runs them for
CPU tensors and launches `csrc/tesserae.cu` — the whole DP and the walk in
one launch on one thread-block cluster, or past one cluster's registers on a
grid of clusters — for CUDA tensors.
`TesseraeDevice` is the Call stage's aligner.

The kernel keeps one byte of traceback a cell and column plus one packed
recombination word a column instead of three packed words a cell;
`encode_traceback` and `decode_traceback` are the plain versions of that
encoding and of the kernel's walk over it.  The packed word is the JAX
package's int32 `who << 25 | state << 23 | pos` up to tz.INT32_TARGETS
targets and the same word in int64 above (models/tesserae.word_dtype); the
kernel's recombination words are int64 at every size.  Sections past the
register form's MAX_CELLS take the kernel's wide form (the section spread
over a grid of clusters, every cell's state still in registers), up to
MAX_WIDE_CELLS, the most that TesseraeDevice's budget gate sends to the
device (`gate_max_cells`); on the CPU the twin takes any size.

Shapes are the section's own: query int32[L], targets int32[S, W-1] with a
bool validity mask, W = longest target + 1.  The JAX package pads to
power-of-two buckets to bound XLA compiles; padded targets and columns are
masked to SMALL and the delete scan is a prefix, so the real cells are the
same without the padding.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from . import _kernels
from ..device import resolve
from ..models import tesserae as tz
from ..utils.profiling import span

SMALL = -1e32
M, I, D = 1, 2, 3
_WORD_DTYPE = {np.int32: torch.int32, np.int64: torch.int64}
# the cluster kernel: at most MAX_CLUSTER CTAs of MAX_THREADS threads, each
# thread holding up to MAX_CELLS_PER_THREAD cells in registers
MAX_CLUSTER = 16
MAX_THREADS = 512
MAX_CELLS_PER_THREAD = 16
MAX_CELLS = MAX_CLUSTER * MAX_THREADS * MAX_CELLS_PER_THREAD
CTA_THREADS = 256             # threads a CTA before the cluster grows
# the wide form's limit, the budget gate's largest section: 16,384 targets
# of at most 64 bases (width 65) with a query of at most 64 bases,
# section_bytes 16 * (16,384 + 1) * 65^2 = 1,107,626,000 <= 2 GiB, where
# 32,768 targets would need 2,215,184,400 (gate_max_cells)
MAX_WIDE_CELLS = 16_384 * 65
# the wide form: a grid of clusters, each thread its cells in registers.  Its
# one shape, (cells a thread, CTAs a cluster, threads a CTA), the fastest on
# the gate's largest section (tools/tesserae_probe.py ablate); the kernel
# takes WIDE_CELLS cells a thread and at most WIDE_THREADS threads a CTA
WIDE_CELLS, WIDE_CLUSTER, WIDE_THREADS = 16, 8, 256

# kernel launches (plain integers; chip_smoke.py resets and reads them):
# every launch, and those of the wide form among them
LAUNCHES = 0
WIDE_LAUNCHES = 0


def tesserae_params(del_: float, eps: float, rho: float, term: float,
                    size_l: float, device=None):
    """(scal f32[9], lsm f32[5,5], lsi f32[5]): the float32 scalars
    (ldel, leps, lrho, lpiM, lpiI, lmm, lgm, ldm, lsize_l) and log emission
    tables, rounded from float64 exactly as tesserae_jax.TesseraeDevice
    builds them."""
    pi_m = 0.75
    scal = torch.tensor([
        math.log(del_), math.log(eps), math.log(rho),
        math.log(pi_m), math.log(1 - pi_m),
        math.log(1 - 2 * del_ - rho - term),
        math.log(1 - eps - rho - term),
        math.log(1 - eps), math.log(size_l),
    ], dtype=torch.float32, device=device)
    lsm = torch.tensor(np.log(tz.EMISS_MATCH_NT), dtype=torch.float32, device=device)
    lsi = torch.tensor(np.log(tz.EMISS_GAP_NT), dtype=torch.float32, device=device)
    return scal, lsm, lsi


def _pack(who, state, pos):
    return (who << 25) | (state << 23) | pos


def delete_term(ldel: torch.Tensor, leps: torch.Tensor, width: int) -> torch.Tensor:
    """The delete state's constant term ldel + leps * (j - 1) for j < width,
    float32 [1, W], rounded once as a fused multiply-add rounds it: XLA's CPU
    backend contracts tesserae_jax.py:63 into an FMA (jax 0.9.0), and the
    kernel computes it with __fmaf_rn (csrc/tesserae.cu).  The product and
    the sum are taken in float64 and rounded once to float32.  The product
    is exact there: leps has 24 significant bits and |j - 1| < MAX_WIDE_CELLS
    < 2^21 (the widest section either form of the kernel takes), 45 bits in
    all; it would stay exact up to |j - 1| < 2^29.  The sum is exact while
    its bits span at most 53, which the caller's parameters decide (the
    Caller's span 45 at that width); its rounding error, found by TwoSum,
    must be zero, or this raises rather than round twice."""
    if width > MAX_WIDE_CELLS:
        raise ValueError(f"width {width} over the {MAX_WIDE_CELLS} the kernel takes")
    a = ldel.to(torch.float64)
    b = leps.to(torch.float64) * (torch.arange(width, dtype=torch.float64,
                                               device=ldel.device) - 1)
    s = a + b
    bv = s - a
    err = (a - (s - bv)) + (b - bv)
    if bool((err != 0).any()):
        raise ArithmeticError("ldel + leps * (j - 1) is not exact in float64 for these "
                              "parameters: it cannot be rounded once")
    return s.to(torch.float32)[None, :]


def tesserae_scan(q_codes: torch.Tensor, t_codes: torch.Tensor,
                  valid: torch.Tensor, params):
    """Plain twin of tesserae_jax._tesserae_scan (unpadded: q_len = L).

    q_codes int32[L]; t_codes int32[S, W-1]; valid bool[S, W-1].  Returns
    (tb [3, L+1, S, W] — packed M/I/D traceback words, int32 or int64 by
    tz.word_dtype(S), indexed by query column, column 1's M/I rows zero —
    and the final column's who, state, pos, max_r as 0-dim tensors)."""
    scal, lsm, lsi = params
    ldel, leps, lrho, lpiM, lpiI, lmm, lgm, ldm, lsize_l = scal.unbind()
    dev = q_codes.device
    l1 = q_codes.shape[0]
    s_count, w1 = t_codes.shape
    width = w1 + 1
    word = _WORD_DTYPE[tz.word_dtype(s_count)]
    seq_ids = torch.arange(1, s_count + 1, dtype=word, device=dev)[:, None]
    jj = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    jf = jj.to(torch.float32)
    jpos = torch.clamp_min(jj - 1, 0)
    vmask = torch.cat([torch.zeros((s_count, 1), dtype=torch.bool, device=dev),
                       valid], dim=1)
    small_col = torch.full((s_count, 1), SMALL, dtype=torch.float32, device=dev)
    flat_ids = torch.arange(s_count * width * 2, device=dev)
    t_long = t_codes.long()
    dconst = delete_term(ldel, leps, width)

    def shift(x):
        return torch.cat([small_col, x[:, :-1]], dim=1)

    def delete_scan(vm, min_j):
        adj = vm - leps * jf
        adj = torch.where(jj >= min_j - 1, adj, SMALL)
        run = torch.cummax(adj, dim=1).values
        vd = dconst + shift(run)
        vd = torch.where(jj >= min_j, vd, SMALL)
        state = torch.where(shift(vm) + ldel >= shift(vd) + leps, M, D)
        return vd, state.to(torch.int32)

    def column_max(vm, vi):
        inter = torch.stack([torch.where(vmask, vm, SMALL),
                             torch.where(vmask, vi, SMALL)], dim=2).reshape(-1)
        best = inter.max()
        flat = torch.where(inter == best, flat_ids, flat_ids.numel()).min()
        s_idx, rem = flat // (width * 2), flat % (width * 2)
        j, st = rem // 2, rem % 2
        return ((s_idx + 1).to(word), torch.where(st == 0, M, I).to(torch.int32),
                j.to(torch.int32), best)

    tb = torch.zeros((3, l1 + 1, s_count, width), dtype=word, device=dev)

    # column 1
    qc = q_codes[0].long()
    vm = torch.full((s_count, width), SMALL, dtype=torch.float32, device=dev)
    vi = vm.clone()
    vm[:, 1:] = torch.where(valid, lpiM - lsize_l + lsm[qc][t_long], SMALL)
    vi[:, 1:] = torch.where(valid, lpiI - lsize_l + lsi[qc], SMALL)
    vd, state_d = delete_scan(vm, 1)
    tb[2, 1] = _pack(seq_ids, state_d, jpos)
    who, state, pos, max_r = column_max(vm, vi)

    for i in range(1, l1):
        qc = q_codes[i].long()
        em = lsm[qc][t_long]
        c0, c1, c2 = shift(vm) + lmm, shift(vi) + lgm, shift(vd) + ldm
        local_val = torch.maximum(c0, c1)
        local_arg = torch.where(c1 > c0, 1, 0)
        local_arg = torch.where(c2 > local_val, 2, local_arg)
        local_val = torch.maximum(local_val, c2)
        recomb = max_r + lrho + lpiM - lsize_l
        use_local = local_val > recomb
        nvm = torch.where(use_local, local_val, recomb)
        tb_rec = _pack(who, state, pos)
        tb[0, i + 1] = torch.where(
            use_local, _pack(seq_ids, (local_arg + 1).to(torch.int32), jpos), tb_rec)
        nvm[:, 1:] = torch.where(valid, nvm[:, 1:] + em, SMALL)
        nvm[:, 0] = SMALL

        i0, i1 = vm + ldel, vi + leps
        arg_i = torch.where(i1 > i0, 1, 0)
        val_i = torch.maximum(i0, i1)
        recomb_i = max_r + lrho + lpiI - lsize_l
        use_local_i = val_i > recomb_i
        nvi = torch.where(use_local_i, val_i, recomb_i)
        tb[1, i + 1] = torch.where(
            use_local_i, _pack(seq_ids, (arg_i + 1).to(torch.int32), jj), tb_rec)
        nvi[:, 1:] = torch.where(valid, nvi[:, 1:] + lsi[qc], SMALL)
        nvi[:, 0] = SMALL

        nvd, state_d = delete_scan(nvm, 2)
        tb[2, i + 1] = _pack(seq_ids, state_d, jpos)
        if i == l1 - 1:
            nvd = torch.full_like(nvd, SMALL)
        who, state, pos, max_r = column_max(nvm, nvi)
        vm, vi, vd = nvm, nvi, nvd
    return tb, who, state, pos, max_r


def tesserae_traceback(tb: torch.Tensor, who, state, pos):
    """Plain twin of tesserae_jax._tesserae_traceback: walk the packed
    traceback from the final column's best cell.  Returns (cells
    int32[cap, 3], n) with cap = L + W + 4; cells[0] is the start and
    cells[n-1] the zero-packed boundary entry the caller drops."""
    _, l1p1, s_count, width = tb.shape
    l1 = l1p1 - 1
    cap = l1 + width + 4
    who, state, pos = int(who), int(state), int(pos)
    cells = [(who, state, pos)]
    pt = l1
    while pt >= 1 and len(cells) < cap:
        sidx = who - 1 if who >= 1 else who - 1 + s_count
        if state in (M, I) and pt < 2:
            v = 0
        else:
            v = int(tb[{M: 0, I: 1}.get(state, 2), pt, sidx, pos])
        if state != D:
            pt -= 1
        who, state, pos = v >> 25, (v >> 23) & 3, v & ((1 << 23) - 1)
        cells.append((who, state, pos))
    out = torch.zeros((cap, 3), dtype=torch.int32)
    out[:len(cells)] = torch.tensor(cells, dtype=torch.int32)
    return out.to(tb.device), len(cells)


def tesserae_full(q_codes: torch.Tensor, t_codes: torch.Tensor,
                  valid: torch.Tensor, params):
    """Plain twin of tesserae_jax._tesserae_full: (max_r f32 0-dim,
    cells int32[cap, 3], n)."""
    tb, who, state, pos, max_r = tesserae_scan(q_codes, t_codes, valid, params)
    cells, n = tesserae_traceback(tb, who, state, pos)
    return max_r, cells, n


def encode_traceback(tb: torch.Tensor):
    """The kernel's traceback encoding of tesserae_scan's packed words tb
    [3, L+1, S, W]: (codes uint8[L+1, S, W], rec int64[L+1]).  A cell's
    byte holds its M word in bits 0-1 (0: the column's recombination word,
    else the local state, position j-1), its I word in bits 2-3 (0:
    recombination, else the local state, position j) and its D word in bit 4
    (1: D, 0: M, position j-1); rec[c] is the recombination word of column
    c + 1, that is column c's argmax.  Column 1's M and I bytes stay 0: the
    walk never reads them."""
    _, l1p1, s_count, width = tb.shape
    dev = tb.device
    seq = torch.arange(1, s_count + 1, dtype=tb.dtype, device=dev)[:, None]
    jj = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    jpos = torch.clamp_min(jj - 1, 0)
    codes = torch.zeros((l1p1, s_count, width), dtype=torch.uint8, device=dev)
    rec = torch.zeros(l1p1, dtype=torch.int64, device=dev)
    for col in range(1, l1p1):
        d = tb[2, col]
        if not bool(((d == _pack(seq, D, jpos)) | (d == _pack(seq, M, jpos))).all()):
            raise ValueError(f"column {col}: a D word is not local")
        code = (d == _pack(seq, D, jpos)).to(torch.uint8) << 4
        if col >= 2:
            mc = torch.zeros_like(code)
            for st in (M, I, D):
                mc = torch.where((mc == 0) & (tb[0, col] == _pack(seq, st, jpos)), st, mc)
            ic = torch.zeros_like(code)
            for st in (M, I):
                ic = torch.where((ic == 0) & (tb[1, col] == _pack(seq, st, jj)), st, ic)
            recs = torch.cat([tb[0, col][mc == 0], tb[1, col][ic == 0]]).unique()
            if recs.numel() > 1:
                raise ValueError(f"column {col}: more than one recombination word")
            if recs.numel():
                rec[col - 1] = recs[0]
            code = code | mc.to(torch.uint8) | (ic.to(torch.uint8) << 2)
        codes[col] = code
    return codes, rec


def _word(who: int, state: int, pos: int) -> int:
    """_pack on Python ints: the int32 word's value up to tz.INT32_TARGETS
    targets, the int64 word's above."""
    return (who << 25) | (state << 23) | pos


def decode_traceback(codes: torch.Tensor, rec: torch.Tensor, who, state, pos):
    """Plain version of the kernel's walk: tesserae_traceback over the
    encoded traceback (codes, rec) of encode_traceback, each packed word
    rebuilt from its cell's byte.  Returns (cells int32[cap, 3], n) as
    tesserae_traceback does."""
    l1p1, s_count, width = codes.shape
    l1 = l1p1 - 1
    cap = l1 + width + 4
    codes_h, rec_h = codes.cpu(), rec.cpu().tolist()
    who, state, pos = int(who), int(state), int(pos)
    cells = [(who, state, pos)]
    pt = l1
    while pt >= 1 and len(cells) < cap:
        sidx = who - 1 if who >= 1 else who - 1 + s_count
        if state in (M, I) and pt < 2:
            v = 0
        else:
            code = int(codes_h[pt, sidx, pos])
            s1 = (sidx % s_count) + 1
            if state == M:
                v = _word(s1, code & 3, max(pos - 1, 0)) if code & 3 else rec_h[pt - 1]
            elif state == I:
                c = (code >> 2) & 3
                v = _word(s1, c, pos) if c else rec_h[pt - 1]
            else:
                v = _word(s1, D if code & 16 else M, max(pos - 1, 0))
        if state != D:
            pt -= 1
        who, state, pos = v >> 25, (v >> 23) & 3, v & ((1 << 23) - 1)
        cells.append((who, state, pos))
    out = torch.zeros((cap, 3), dtype=torch.int32)
    out[:len(cells)] = torch.tensor(cells, dtype=torch.int32)
    return out.to(codes.device), len(cells)


def kernel_config(s_count: int, width: int):
    """(cells a thread, CTAs in the cluster, threads a CTA) of the register
    form for a section of S x W cells: at least min(4, W) cells a thread (a
    power of two, at most W, so a thread meets at most one target boundary),
    more when the cells would not fit MAX_CLUSTER x MAX_THREADS threads; the
    cluster doubles while a CTA would hold more than CTA_THREADS threads.
    Raises for a section over MAX_CELLS cells."""
    cells = s_count * width
    if cells > MAX_CELLS:
        raise ValueError(f"tesserae section of {s_count} x {width} = {cells} cells: "
                         f"the cluster kernel holds at most {MAX_CELLS}")
    per = min(4, 1 << (width.bit_length() - 1))
    while -(-cells // per) > MAX_CLUSTER * MAX_THREADS:
        per *= 2
    n_threads = -(-cells // per)
    cluster = 1
    while cluster < MAX_CLUSTER and n_threads > cluster * CTA_THREADS:
        cluster *= 2
    return per, cluster, 32 * -(-n_threads // (32 * cluster))


def wide_config(s_count: int, width: int):
    """(cells a thread, clusters, CTAs a cluster, threads a CTA) of the wide
    form for a section of S x W cells: its one shape with the fewest
    clusters that hold the section.  Raises for a section over
    MAX_WIDE_CELLS cells."""
    cells = s_count * width
    if cells > MAX_WIDE_CELLS:
        raise ValueError(f"tesserae section of {s_count} x {width} = {cells} cells: "
                         f"the wide form holds at most {MAX_WIDE_CELLS}")
    clusters = -(-cells // (WIDE_CELLS * WIDE_CLUSTER * WIDE_THREADS))
    return WIDE_CELLS, clusters, WIDE_CLUSTER, WIDE_THREADS


_WIDE_INFO: dict = {}


def wide_kernel_info(device, cells: int, cluster: int, threads: int) -> dict:
    """How the wide form's kernel for `cells` a thread runs on `device` at
    clusters of `cluster` CTAs of `threads` threads: registers and local
    (spilled) bytes a thread, static shared bytes a CTA, and the clusters the
    card holds at once (`max_clusters`, cudaOccupancyMaxActiveClusters: a
    grid barrier needs every cluster resident).  Queried once a shape."""
    import ctypes

    dev = torch.device(device)
    key = (dev.index, cells, cluster, threads)
    if key not in _WIDE_INFO:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            err = _kernels.library().ctk_tesserae_wide_info(cells, cluster, threads, out)
        _kernels.check(err, "tesserae_wide_info")
        _WIDE_INFO[key] = {"registers": out[0], "local_bytes": out[1], "max_clusters": out[2],
                           "shared_bytes": out[3]}
    return _WIDE_INFO[key]


def launch_config(s_count: int, width: int):
    """(wide, *config) that tesserae_fused launches for a section of S x W
    cells: the register form's kernel_config up to MAX_CELLS, the wide
    form's wide_config above."""
    if s_count * width > MAX_CELLS:
        return (True, *wide_config(s_count, width))
    return (False, *kernel_config(s_count, width))


def tesserae_fused(q_codes: torch.Tensor, t_codes: torch.Tensor,
                   valid: torch.Tensor, params, config=None, wide=None):
    """Tesserae DP + traceback: the plain twin for CPU tensors (any size),
    one launch of csrc/tesserae.cu for CUDA tensors: the register form up to
    MAX_CELLS cells, the wide form above.  Returns (max_r, cells, n) as
    tesserae_full does (tensors on the inputs' device on CUDA).  `wide`
    forces a form and `config` its shape, (cells a thread, cluster, threads)
    or the wide form's (cells a thread, clusters, cluster, threads), so that
    the kernel tests can place CTA and cluster edges inside targets and run
    the wide form on small sections.  A wide grid of more clusters than the
    card holds at once raises ValueError: its grid barrier could not open."""
    global LAUNCHES, WIDE_LAUNCHES
    l1 = q_codes.shape[0]
    s_count, w1 = t_codes.shape
    if l1 < 1 or s_count < 1 or w1 < 1:
        raise ValueError("tesserae needs a non-empty query and targets")
    if valid.shape != t_codes.shape:
        raise ValueError("valid must have t_codes' shape")
    if q_codes.dtype != torch.int32 or t_codes.dtype != torch.int32:
        raise TypeError("codes must be int32")
    if q_codes.device.type == "cpu":
        return tesserae_full(q_codes, t_codes, valid, params)
    if q_codes.device.type != "cuda":
        raise ValueError(f"unsupported device {q_codes.device}")
    width = w1 + 1
    if wide is None:
        wide = launch_config(s_count, width)[0]
    shape = config or (wide_config if wide else kernel_config)(s_count, width)
    dev = q_codes.device
    if wide:
        per, clusters, cluster, threads = shape
        room = wide_kernel_info(dev, per, cluster, threads)["max_clusters"]
        if clusters > room:
            raise ValueError(f"tesserae wide form: {clusters} clusters of {cluster} x {threads} "
                             f"threads, where the card holds {room} at once")
    else:
        per, cluster, threads = shape
    cap = l1 + width + 4
    npad = -(-(s_count * width) // 16) * 16
    scal, lsm, lsi = params
    prm = torch.cat([scal.reshape(-1), lsm.reshape(-1), lsi.reshape(-1)]).to(
        device=dev, dtype=torch.float32).contiguous()
    q = q_codes.contiguous()
    t = t_codes.to(dev).contiguous()
    vmask = valid.to(device=dev, dtype=torch.uint8).contiguous()
    codes = torch.empty((l1 + 1, npad), dtype=torch.uint8, device=dev)
    rec = torch.empty(l1 + 1, dtype=torch.int64, device=dev)
    out = torch.empty(2 + 3 * cap, dtype=torch.int32, device=dev)
    lib = _kernels.library()
    if wide:
        scratch = torch.zeros(lib.ctk_tesserae_wide_scratch(clusters), dtype=torch.int32,
                              device=dev)
        err = lib.ctk_tesserae_wide(q.data_ptr(), t.data_ptr(), vmask.data_ptr(),
                                    prm.data_ptr(), l1, s_count, width, per, clusters, cluster,
                                    threads, codes.data_ptr(), npad, rec.data_ptr(),
                                    scratch.data_ptr(), out.data_ptr(), cap,
                                    _kernels.stream(dev))
    else:
        err = lib.ctk_tesserae(q.data_ptr(), t.data_ptr(), vmask.data_ptr(),
                               prm.data_ptr(), l1, s_count, width, per, cluster,
                               threads, codes.data_ptr(), npad, rec.data_ptr(),
                               out.data_ptr(), cap, _kernels.stream(dev))
    _kernels.check(err, "tesserae_wide" if wide else "tesserae")
    LAUNCHES += 1
    WIDE_LAUNCHES += bool(wide)
    return out[1:2].view(torch.float32)[0], out[2:].view(cap, 3), out[0]


def delete_term_on_card(params, width: int) -> torch.Tensor:
    """ctk_tesserae's delete term for j < width (float32 [width] on the
    card), from one launch of ctk_tesserae_delete_term on the same device
    function the DP calls; held bit for bit against delete_term."""
    scal = params[0]
    if scal.device.type != "cuda":
        raise ValueError("delete_term_on_card takes the parameters on a CUDA device")
    out = torch.empty(width, dtype=torch.float32, device=scal.device)
    prm = scal.reshape(-1).to(torch.float32).contiguous()
    with torch.cuda.device(scal.device):
        err = _kernels.library().ctk_tesserae_delete_term(
            prm.data_ptr(), width, out.data_ptr(), _kernels.stream(scal.device))
    _kernels.check(err, "tesserae_delete_term")
    return out


def section_inputs(query: str, seqs: list, hmm: tuple, device=None):
    """tesserae_fused's arguments for one section on `device`: query codes
    int32[L], target codes int32[S, W-1] (W-1 = longest target), their
    validity mask, and tesserae_params for hmm = (del_, eps, rho, term)."""
    t_len = np.array([len(t) for t in seqs], dtype=np.int64)
    maxl = max(1, int(t_len.max()))
    t_codes = np.zeros((len(seqs), maxl), dtype=np.int32)
    for si, t in enumerate(seqs):
        t_codes[si, :len(t)] = tz._seq_codes(t)
    valid = np.arange(1, maxl + 1)[None, :] <= t_len[:, None]
    return (torch.from_numpy(tz._seq_codes(query)).to(device),
            torch.from_numpy(t_codes).to(device),
            torch.from_numpy(valid).to(device),
            tesserae_params(*hmm, float(t_len.sum()), device=device))


def _bucket(n: int, lo: int = 64) -> int:
    """tesserae_jax._bucket: next power of two at least lo."""
    b = lo
    while b < n:
        b *= 2
    return b


def section_bytes(query_len: int, target_lens) -> int:
    """TesseraeDevice.align's estimate of a section's device bytes, on the
    JAX package's padded shapes (tesserae_jax.py:264-266): 16 bytes a cell
    of (bucket(S, 2) + 1) x (bucket(longest of query and targets) + 1)^2."""
    est_maxl = _bucket(max([query_len] + list(target_lens)))
    return 4 * 4 * (_bucket(len(target_lens), 2) + 1) * (est_maxl + 1) ** 2


def gate_max_cells(budget: int) -> int:
    """The most cells S x W of a section whose section_bytes are within
    `budget`: for each padded length b (64, 128, ...), the largest
    power-of-two target bucket that fits, its S targets of up to b bases
    (W = b + 1).  1,064,960 at the 2 GiB budget (16,384 x 65)."""
    most, maxl = 0, 64
    while section_bytes(1, [maxl] * 2) <= budget:
        s = 2
        while section_bytes(1, [maxl] * (2 * s)) <= budget:
            s *= 2
        most = max(most, s * (maxl + 1))
        maxl *= 2
    return most


class TesseraeDevice(tz.Tesserae):
    """Tesserae with the DP and the traceback walk on the device; segment
    reconstruction on the host.  `device` defaults to the CUDA card (and
    RuntimeError without one); "cpu" runs the plain twins.  The class name
    is what caller/call.py checks to report the device timer sections."""

    # One section's DP + traceback state, estimated on the JAX package's
    # padded shapes so that the same sections take the exact host oracle and
    # the VCFs stay equal; re-deriving the budget for the card is for later.
    HBM_BUDGET_BYTES = 2 << 30

    def __init__(self, del_=0.025, eps=0.75, rho=1e-4, term=1e-3, device=None):
        super().__init__(del_, eps, rho, term)
        self.device = resolve(device)
        # first call (kernel build + load) vs the rest, as the JAX class
        # splits compile and dispatch
        self.compile_s = 0.0
        self.dispatch_s = 0.0
        self.device_sections = 0
        self.host_sections = 0

    def align(self, query: str, targets: dict) -> list:
        with span("tesserae.align"):
            if not targets or not query:
                raise ValueError("Tesserae.align requires a non-empty query and targets")
            t_start = time.perf_counter()
            names = list(targets.keys())
            seqs = [targets[n] for n in names]
            if section_bytes(len(query), [len(t) for t in seqs]) > self.HBM_BUDGET_BYTES:
                with span("tesserae.host_oracle"):
                    host = tz.Tesserae(self.del_, self.eps, self.rho, self.term)
                    out = host.align(query, targets)
                self.llk = host.llk
                self.combined_llk += host.llk
                self.host_sections += 1
                return out

            with span("tesserae.pack") as sp:
                args = section_inputs(query, seqs, (self.del_, self.eps, self.rho, self.term),
                                      self.device)
                if sp:
                    sp.set(bytes=sum(x.nbytes for x in (*args[:3], *args[3])))
            with span("tesserae.launch"):
                max_r, cells, n = tesserae_fused(*args)
            with span("tesserae.wait"):
                n = int(n)
            with span("tesserae.fetch"):
                cells = cells[:n - 1].cpu().tolist()
                self.llk = float(max_r) + math.log(self.term)
            self.combined_llk += self.llk

            dt = time.perf_counter() - t_start
            if self.device_sections:
                self.dispatch_s += dt
            else:
                self.compile_s += dt
            self.device_sections += 1

            with span("tesserae.decode"):
                cells = [tuple(c) for c in cells]
                cells.reverse()
                return self._build_path(query, names, seqs, cells)
