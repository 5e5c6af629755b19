"""Port's Tesserae (corticall_tpu_torch/ops/tesserae_torch.py) against the
JAX package's _tesserae_full on CPU XLA and its own CUDA kernel against the
plain twin: traceback cells identical, max_r within 1e-6 relative (equal in
bits on the card, where both sides run the same float32 operations).  The
exact form (the twin and the kernel in float64) against the JAX package's
numpy host oracle: path and llk equal."""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu.models import tesserae as tz  # noqa: E402
from corticall_tpu_torch.models import tesserae as ptz  # noqa: E402
from corticall_tpu_torch.ops import tesserae_torch as tt  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _mutate(rng, s, rate):
    b = np.frombuffer(s.encode(), np.uint8).copy()
    m = rng.random(len(b)) < rate
    b[m] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, m.sum())]
    return b.tobytes().decode()


# the four cases of tests/test_tesserae_device.py, plus 16 and 40 targets
# (more targets than the kernel has warps) and a one-column query
def _case(name):
    if name == "small":
        return "GTAGGCGAGATGACGCCAT", {"template0": "GTAGGCGAGTCCCGTTTATA",
                                      "template1": "CCACAGAAGATGACGCCATT"}
    if name.startswith("recombinant"):
        rng = np.random.default_rng(int(name[-1]))
        t0, t1 = _genome(rng, 400), _genome(rng, 400)
        return t0[:150] + t1[150:280] + t0[280:399], {"t0": t0, "t1": t1}
    if name == "indels":
        rng = np.random.default_rng(5)
        t = _genome(rng, 300)
        return t[:100] + t[103:205] + "GGGG" + t[205:299], {"t0": t}
    if name == "llk":
        rng = np.random.default_rng(6)
        t = _genome(rng, 200)
        return t[:80] + t[90:199], {"t0": t}
    if name == "tiny":
        return "A", {"a": "C", "b": "AG"}
    if name == "longquery":
        # a query longer than every target: the oracle pads its columns to
        # the query's length, the port to the longest target's
        rng = np.random.default_rng(9)
        t0, t1 = _genome(rng, 150), _genome(rng, 120)
        return _mutate(rng, t0[:100] + t1[40:120] + _genome(rng, 90), 0.01), {"t0": t0, "t1": t1}
    if name.startswith("w") and "_" in name:
        # "wW_S": S targets of W - 1 bases against a 40-base query
        width, s_count = (int(x) for x in name[1:].split("_"))
        rng = np.random.default_rng(s_count if width == 2 else 1000 * width + s_count)
        return _genome(rng, 40), {f"t{i}": _genome(rng, width - 1)
                                  for i in range(s_count)}
    if name.startswith("many"):
        return _many(int(name[4:]))
    n_targets = int(name[len("targets"):])
    rng = np.random.default_rng(n_targets)
    base = _genome(rng, 260)
    targets = {f"t{i}": _mutate(rng, base, 0.04)[int(rng.integers(0, 30)):]
               for i in range(n_targets)}
    seqs = list(targets.values())
    query = seqs[3][:90] + seqs[11][90:170] + seqs[7][170:]
    return _mutate(rng, query, 0.01), targets


def _many(n_targets):
    """n short random targets (40-60 bases); the query is 40 bases of target
    63 (of the last target below 64), then 40 of target 0."""
    rng = np.random.default_rng(1000 + n_targets)
    targets = {f"t{i}": _genome(rng, int(rng.integers(40, 61))) for i in range(n_targets)}
    last = f"t{min(n_targets, 64) - 1}"
    return targets[last][:40] + targets["t0"][:40], targets


CASES = ["small", "recombinant0", "recombinant1", "recombinant2", "indels",
         "llk", "targets16", "targets40"]
PARAMS = [(0.025, 0.75, 1e-4, 1e-3),          # Tesserae defaults
          (0.35, 0.90, 6e-4, 1e-3)]           # the Caller's settings


def _inputs(query, targets, prm, device="cpu"):
    return tt.section_inputs(query, list(targets.values()), prm, device)


def _jax_params(del_, eps, rho, term, size_l):
    """The parameter tuple exactly as tesserae_jax.TesseraeDevice.align
    builds it."""
    jnp = pytest.importorskip("jax.numpy")
    pi_m = 0.75
    scal = jnp.asarray([
        math.log(del_), math.log(eps), math.log(rho),
        math.log(pi_m), math.log(1 - pi_m),
        math.log(1 - 2 * del_ - rho - term),
        math.log(1 - eps - rho - term),
        math.log(1 - eps), math.log(size_l),
    ])
    return (tuple(scal), jnp.asarray(np.log(tz.EMISS_MATCH_NT)),
            jnp.asarray(np.log(tz.EMISS_GAP_NT)))


@pytest.mark.parametrize("prm", PARAMS)
def test_params_bit_identical_to_jax(prm):
    jp = _jax_params(*prm, 1234.0)
    scal, lsm, lsi = tt.tesserae_params(*prm, 1234.0)
    want = np.array([np.asarray(x) for x in jp[0]], np.float32)
    np.testing.assert_array_equal(scal.numpy().view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(lsm.numpy().view(np.int32),
                                  np.asarray(jp[1]).view(np.int32))
    np.testing.assert_array_equal(lsi.numpy().view(np.int32),
                                  np.asarray(jp[2]).view(np.int32))


@pytest.mark.parametrize("prm", PARAMS)
@pytest.mark.parametrize("case", CASES)
def test_plain_full_matches_jax(case, prm):
    pytest.importorskip("jax")
    from corticall_tpu.ops import tesserae_jax as tj
    query, targets = _case(case)
    args = _inputs(query, targets, prm)
    q, t_codes, valid = (x.numpy() for x in args[:3])
    s_count, width = t_codes.shape[0], t_codes.shape[1] + 1
    size_l = float(sum(map(len, targets.values())))
    want_r, want_cells, want_n = tj._tesserae_full(
        q, t_codes, valid, _jax_params(*prm, size_l), s_count, width,
        np.int32(len(q)))
    max_r, cells, n = tt.tesserae_full(*args)
    assert n == int(want_n)
    np.testing.assert_array_equal(cells.numpy()[:n], np.asarray(want_cells)[:n])
    assert abs(float(max_r) - float(want_r)) <= 1e-6 * abs(float(want_r))


@pytest.mark.parametrize("case", ["recombinant0", "indels", "targets16", "tiny"])
def test_device_class_matches_jax_device_class(case):
    """Unpadded (port) and power-of-two padded (JAX) sections give the same
    mosaic: padded targets and columns are masked and never reach real
    cells.  (The one-column "tiny" query runs only padded in JAX: its scan
    needs a second column.)"""
    pytest.importorskip("jax")
    from corticall_tpu.ops.tesserae_jax import TesseraeDevice as JaxDevice
    query, targets = _case(case)
    prm = PARAMS[1]
    dev = tt.TesseraeDevice(*prm, device="cpu")
    ref = JaxDevice(*prm)
    assert dev.align(query, targets) == ref.align(query, targets)
    assert abs(dev.llk - ref.llk) <= 1e-6 * abs(ref.llk)
    assert dev.device_sections == 1 and dev.host_sections == 0


def test_over_budget_section_takes_host_oracle():
    query, targets = _case("recombinant1")
    dev = tt.TesseraeDevice(device="cpu")
    dev.HBM_BUDGET_BYTES = 1024
    host = tz.Tesserae()
    assert dev.align(query, targets) == host.align(query, targets)
    assert dev.llk == host.llk
    assert dev.host_sections == 1 and dev.device_sections == 0 and dev.exact_sections == 0


@pytest.mark.parametrize("n_targets", [1, 8, 63])
def test_up_to_63_targets_oracle_twin_and_device_match_jax(n_targets):
    """Up to 63 targets the int32 word is the JAX package's: the port's
    oracle copy, the plain twin and the device class equal the JAX
    package's host oracle, _tesserae_full and device class (cells exact;
    the oracles' llk equal, float32 llk within 1e-6 relative)."""
    pytest.importorskip("jax")
    from corticall_tpu.ops import tesserae_jax as tj
    query, targets = _many(n_targets)
    prm = PARAMS[1]
    want = tz.Tesserae(*prm)
    host = ptz.Tesserae(*prm)
    assert host.align(query, targets) == want.align(query, targets)
    assert host.llk == want.llk
    args = _inputs(query, targets, prm)
    assert tt.tesserae_scan(*args)[0].dtype == torch.int32
    q, t_codes, valid = (x.numpy() for x in args[:3])
    size_l = float(sum(map(len, targets.values())))
    want_r, want_cells, want_n = tj._tesserae_full(
        q, t_codes, valid, _jax_params(*prm, size_l), n_targets, t_codes.shape[1] + 1,
        np.int32(len(q)))
    max_r, cells, n = tt.tesserae_full(*args)
    assert n == int(want_n)
    np.testing.assert_array_equal(cells.numpy()[:n], np.asarray(want_cells)[:n])
    assert abs(float(max_r) - float(want_r)) <= 1e-6 * abs(float(want_r))
    dev = tt.TesseraeDevice(*prm, device="cpu")
    ref = tj.TesseraeDevice(*prm)
    assert dev.align(query, targets) == ref.align(query, targets)
    assert abs(dev.llk - ref.llk) <= 1e-6 * abs(ref.llk)


@pytest.mark.parametrize("n_targets", [64, 65, 80, 100])
def test_64_or_more_targets_match_the_widened_oracle(n_targets):
    """From 64 targets the word is int64 (the JAX package's int32 word
    breaks there, so it is no reference): the plain twin and the device
    class give the port's oracle's path, through target 63, and its llk
    within 1e-4 relative (float32 against float64, the tolerance of
    tests/test_tesserae_device.py)."""
    query, targets = _many(n_targets)
    prm = PARAMS[1]
    host = ptz.Tesserae(*prm)
    want = host.align(query, targets)
    assert [seg[0] for seg in want] == ["query", "t63", "t0"]
    assert tt.tesserae_scan(*_inputs(query, targets, prm))[0].dtype == torch.int64
    dev = tt.TesseraeDevice(*prm, device="cpu")
    assert dev.align(query, targets) == want
    assert abs(dev.llk - host.llk) <= 1e-4 * abs(host.llk)
    assert dev.device_sections == 1 and dev.host_sections == 0


@pytest.mark.parametrize("who", [1, 63, 64, 100, 4095])
def test_packed_word_round_trips(who):
    """who << 25 | state << 23 | pos decodes to its fields at any target
    count, and is the JAX package's int32 word up to 63 targets."""
    for state in (tt.M, tt.I, tt.D):
        for pos in (0, 1, (1 << 23) - 1):
            v = tt._word(who, state, pos)
            assert (v >> 25, (v >> 23) & 3, v & ((1 << 23) - 1)) == (who, state, pos)
            if who <= ptz.INT32_TARGETS:
                assert int(np.int64(v).astype(np.int32)) == v
    assert ptz.word_dtype(63) == np.int32 and ptz.word_dtype(64) == np.int64


@pytest.mark.parametrize("prm", PARAMS)
@pytest.mark.parametrize("case", CASES + ["tiny", "w2_63", "w2_64", "many100"])
def test_encoded_traceback_decodes_to_same_cells(case, prm):
    """The kernel's one-byte-a-cell traceback (encode_traceback) walked by
    the kernel's decoding (decode_traceback) gives tesserae_traceback's
    cells."""
    args = _inputs(*_case(case), prm)
    tb, who, state, pos, _ = tt.tesserae_scan(*args)
    want, n = tt.tesserae_traceback(tb, who, state, pos)
    codes, rec = tt.encode_traceback(tb)
    assert codes.dtype == torch.uint8 and codes.shape == tb.shape[1:]
    got, m = tt.decode_traceback(codes, rec, who, state, pos)
    assert m == n
    np.testing.assert_array_equal(got[:n].numpy(), want[:n].numpy())


@pytest.mark.parametrize("s_count, width, want", [
    (1, 2, (2, 1, 32)), (2, 976, (4, 2, 256)), (16, 3426, (8, 16, 448)),
    (63, 1025, (8, 16, 512)), (4, 4097, (4, 16, 288))])
def test_kernel_config(s_count, width, want):
    per, cluster, threads = tt.kernel_config(s_count, width)
    assert (per, cluster, threads) == want
    assert per <= width and cluster * threads * per >= s_count * width
    assert threads % 32 == 0 and threads <= tt.MAX_THREADS


def test_kernel_config_names_its_limit():
    """The register form names its limit; past it the wide form takes the
    section, up to its own limit."""
    with pytest.raises(ValueError, match=str(tt.MAX_CELLS)):
        tt.kernel_config(63, 2100)
    assert tt.launch_config(63, 2100) == (True, *tt.wide_config(63, 2100))
    per, clusters, cluster, threads = tt.wide_config(63, 2100)
    assert (per, cluster, threads) == (tt.WIDE_CELLS, tt.WIDE_CLUSTER, tt.WIDE_THREADS)
    assert (clusters - 1) * cluster * threads * per < 63 * 2100 <= clusters * cluster * threads * per
    with pytest.raises(ValueError, match=str(tt.MAX_WIDE_CELLS)):
        tt.wide_config(16_385, 65)


def test_wrapper_validates_and_counts_no_cpu_launch():
    args = _inputs(*_case("small"), PARAMS[0])
    before = tt.LAUNCHES
    max_r, cells, n = tt.tesserae_fused(*args)
    assert tt.LAUNCHES == before and n >= 2
    with pytest.raises(ValueError):
        tt.tesserae_fused(args[0], args[1], args[2][:, :-1], args[3])
    many = torch.zeros((64, 5), dtype=torch.int32)
    assert int(tt.tesserae_fused(args[0], many, many.bool(), args[3])[2]) >= 2
    # past the register form's cells, the plain twin answers on the CPU
    big = torch.zeros((64, 2100), dtype=torch.int32)
    assert 64 * 2101 > tt.MAX_CELLS
    assert int(tt.tesserae_fused(args[0], big, big.bool(), args[3])[2]) >= 2
    assert tt.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ["tiny", "many64", "many80", "many100", "w2_100"])
def test_kernel_matches_plain_on_card(cuda, case):
    args = _inputs(*_case(case), PARAMS[1], cuda)
    before = tt.LAUNCHES
    max_r, cells, n = tt.tesserae_fused(*args)
    torch.cuda.synchronize()
    assert tt.LAUNCHES == before + 1
    want_r, want_cells, want_n = tt.tesserae_full(*args)
    assert int(n) == want_n
    np.testing.assert_array_equal(cells[:want_n].cpu().numpy(),
                                  want_cells[:want_n].cpu().numpy())
    assert np.float32(max_r.item()).view(np.int32) == \
        np.float32(want_r.item()).view(np.int32)


# forced (cells a thread, cluster, threads): every cell-count template and
# cluster size, targets and CTA edges falling inside one another
FORCED = [("w2_1", None), ("w2_2", None), ("w2_16", None), ("w2_63", None),
          ("w2_16", (1, 8, 32)), ("w2_63", (1, 8, 32)), ("w2_63", (2, 2, 32)),
          ("targets16", (1, 16, 288)), ("targets16", (2, 8, 288)),
          ("targets16", (4, 4, 288)), ("targets16", (8, 2, 288)),
          ("targets16", (16, 1, 288)), ("recombinant0", (1, 4, 224))]


@pytest.mark.cuda
@pytest.mark.parametrize("case, config", FORCED)
def test_kernel_configs_match_plain_on_card(cuda, case, config):
    args = _inputs(*_case(case), PARAMS[1], cuda)
    max_r, cells, n = tt.tesserae_fused(*args, config=config)
    torch.cuda.synchronize()
    want_r, want_cells, want_n = tt.tesserae_full(*args)
    assert int(n) == want_n
    np.testing.assert_array_equal(cells[:want_n].cpu().numpy(),
                                  want_cells[:want_n].cpu().numpy())
    assert np.float32(max_r.item()).view(np.int32) == \
        np.float32(want_r.item()).view(np.int32)


# ---------------------------------------------------------------------------
# the delete state's FMA: ldel + leps * (j - 1) rounded once
#
# These tests pin XLA's CPU contraction at this jax version (0.9.0): its CPU
# backend fuses tesserae_jax.py:63's multiply and add into one FMA, and the
# port rounds that term once to match.  A jax upgrade that stops (or widens)
# the contraction fails them here, and the port's rounding must follow it.
# ---------------------------------------------------------------------------

CROSS_SECTION = os.path.join(os.path.dirname(__file__), "data", "tesserae_cross_section.json")


def _cross_section():
    """The 820 bp, 8-target Call section of tests/test_torch_cross.py's
    kid1 (recorded from that cross), where a twice-rounded delete term puts
    an 8-base deletion one base from the JAX package's."""
    with open(CROSS_SECTION) as f:
        sec = json.load(f)
    return sec["query"], sec["targets"]


def tie_prone_sections(seed: int = 7, count: int = 60) -> list:
    """`count` seeded sections of 80-300 bp built around a C run, 2-5
    targets each with 2% substitutions and a deletion or a duplication next
    to the run, and a query with a 1-8 base deletion at the run's end: gaps
    among equal bases, whose placement a float32 tie decides."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(80, 301))
        run = "C" * int(rng.integers(4, 10))
        at = int(rng.integers(20, n - 30))
        base = _genome(rng, at) + run + _genome(rng, n - at - len(run))

        def variant(s):
            b = list(s)
            for i in np.nonzero(rng.random(len(b)) < 0.02)[0]:
                b[i] = "ACGT"[int(rng.integers(0, 4))]
            s = "".join(b)
            kind = int(rng.integers(0, 3))
            if kind == 1:
                d, p = int(rng.integers(1, 9)), at + len(run) - int(rng.integers(0, 3))
                s = s[:p] + s[p + d:]
            elif kind == 2:
                lo = max(0, at - int(rng.integers(2, 10)))
                hi = at + len(run) + int(rng.integers(1, 8))
                s = s[:hi] + s[lo:hi] + s[hi:]
            return s

        targets = {f"t{i}": variant(base) for i in range(int(rng.integers(2, 6)))}
        d, p = int(rng.integers(1, 9)), at + len(run) - int(rng.integers(0, 3))
        out.append((base[:p] + base[p + d:], targets))
    return out


@pytest.mark.parametrize("prm", PARAMS)
def test_delete_term_is_xla_cpus_contraction(prm):
    """delete_term equals XLA's CPU FMA of the same expression bit for bit
    at every j of the widest section the kernel takes (either form), and
    differs from the twice-rounded float32 expression at some j (so the
    rounding matters)."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    scal, _, _ = tt.tesserae_params(*prm, 1234.0)
    width = tt.MAX_WIDE_CELLS
    ldel, leps = np.float32(scal[0]), np.float32(scal[1])
    xla = jax.jit(lambda a, b: a + b * (jnp.arange(width, dtype=jnp.int32) - 1).astype(
        jnp.float32))(ldel, leps)
    got = tt.delete_term(scal[0], scal[1], width)
    assert got.shape == (1, width) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy()[0].view(np.int32),
                                  np.asarray(xla).view(np.int32))
    exact = np.float64(ldel) + np.float64(leps) * (np.arange(width, dtype=np.float64) - 1)
    np.testing.assert_array_equal(got.numpy()[0], exact.astype(np.float32))
    twice = ldel + leps * (np.arange(width, dtype=np.float32) - 1)
    assert (got.numpy()[0] != twice).any()


def test_delete_term_refuses_a_sum_it_cannot_round_once():
    """A term whose float64 sum is inexact raises instead of rounding twice,
    and a width past the kernel's largest raises."""
    with pytest.raises(ArithmeticError):
        tt.delete_term(torch.tensor(1.0), torch.tensor(2.0 ** -60), 8)
    with pytest.raises(ValueError):
        tt.delete_term(torch.tensor(-1.0), torch.tensor(-0.1), tt.MAX_WIDE_CELLS + 1)


def test_twin_matches_jax_on_the_cross_section():
    """The 820 bp cross section: the plain twin's cells equal
    _tesserae_full's (unpadded), and the port's TesseraeDevice gives the
    JAX package's device path and float32 llk exactly."""
    pytest.importorskip("jax")
    from corticall_tpu.ops import tesserae_jax as tj
    query, targets = _cross_section()
    prm = PARAMS[1]
    args = _inputs(query, targets, prm)
    q, t_codes, valid = (x.numpy() for x in args[:3])
    size_l = float(sum(map(len, targets.values())))
    want_r, want_cells, want_n = tj._tesserae_full(
        q, t_codes, valid, _jax_params(*prm, size_l), t_codes.shape[0], t_codes.shape[1] + 1,
        np.int32(len(q)))
    max_r, cells, n = tt.tesserae_full(*args)
    assert n == int(want_n)
    np.testing.assert_array_equal(cells.numpy()[:n], np.asarray(want_cells)[:n])
    assert float(max_r) == float(want_r)
    dev, ref = tt.TesseraeDevice(*prm, device="cpu"), tj.TesseraeDevice(*prm)
    got = dev.align(query, targets)
    assert got == ref.align(query, targets)
    assert dev.llk == ref.llk
    assert any("CCAAGAG" in seg[1] and "--------" in seg[1] for seg in got)


def test_twin_matches_jax_on_tie_prone_sections():
    """60 seeded tie-prone sections: the port's TesseraeDevice gives the
    JAX package's device path and float32 llk on every one."""
    pytest.importorskip("jax")
    from corticall_tpu.ops import tesserae_jax as tj
    prm = PARAMS[1]
    dev, ref = tt.TesseraeDevice(*prm, device="cpu"), tj.TesseraeDevice(*prm)
    differ = []
    for i, (query, targets) in enumerate(tie_prone_sections()):
        got, want = dev.align(query, targets), ref.align(query, targets)
        if got != want or dev.llk != ref.llk:
            differ.append(i)
    assert not differ, f"sections {differ} differ from the JAX package's"


@pytest.mark.cuda
def test_kernel_delete_term_matches_plain_on_card(cuda):
    """The kernel's delete term (the device function both forms of
    ctk_tesserae call) equals the twin's bit for bit at every j up to the
    widest section the kernel takes."""
    for prm in PARAMS:
        params = tt.tesserae_params(*prm, 1234.0, cuda)
        got = tt.delete_term_on_card(params, tt.MAX_WIDE_CELLS)
        want = tt.delete_term(params[0][0].cpu(), params[0][1].cpu(), tt.MAX_WIDE_CELLS)[0]
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                      want.numpy().view(np.int32))


@pytest.mark.cuda
def test_kernel_matches_plain_on_fma_sections_on_card(cuda):
    """The cross section and the tie-prone sections through the kernel
    against the twin: cells and max_r bit for bit."""
    for query, targets in [_cross_section(), *tie_prone_sections()]:
        args = _inputs(query, targets, PARAMS[1], cuda)
        max_r, cells, n = tt.tesserae_fused(*args)
        want_r, want_cells, want_n = tt.tesserae_full(*args)
        assert int(n) == want_n
        np.testing.assert_array_equal(cells[:want_n].cpu().numpy(),
                                      want_cells[:want_n].cpu().numpy())
        assert np.float32(max_r.item()).view(np.int32) == \
            np.float32(want_r.item()).view(np.int32)


# ---------------------------------------------------------------------------
# sections past the register form's cells: TesseraeDevice's budget gate sends
# sections of up to MAX_WIDE_CELLS cells to the device, and the kernel's wide
# form takes each of them.  All have 256 or more targets, so the reference is
# the widened host oracle (the JAX package's int32 word breaks at 64).
# ---------------------------------------------------------------------------

def wide_case(name):
    """256 targets of 512 bases with a 500 bp query (a section the register
    form refused), 600 targets of 150-256 bases, and 16,384 targets of 64
    bases with a 64 bp query (the gate's largest section); each query a
    mosaic of two or three targets with 0.5% substitutions."""
    if name == "256x512":
        rng = np.random.default_rng(256)
        targets = {f"t{i}": _genome(rng, 512) for i in range(256)}
        query = targets["t200"][:250] + targets["t7"][250:500]
    elif name == "600x256":
        rng = np.random.default_rng(600)
        targets = {f"t{i}": _genome(rng, 256 if i in (0, 64, 301, 599)
                                    else int(rng.integers(150, 257)))
                   for i in range(600)}
        query = targets["t599"][:90] + targets["t64"][90:180] + targets["t301"][180:]
    else:
        rng = np.random.default_rng(16_384)
        targets = {f"t{i}": _genome(rng, 64) for i in range(16_384)}
        query = targets["t5000"][:32] + targets["t12000"][32:]
    return _mutate(rng, query, 0.005), targets


WIDE_CASES = {"256x512": 256 * 513, "600x256": 600 * 257, "gate_max": tt.MAX_WIDE_CELLS}


def test_gate_maximum_is_the_wide_forms_limit():
    """MAX_WIDE_CELLS is the most cells of a section that TesseraeDevice's
    budget gate sends to the device: 16,384 targets of 64 bases (width 65)
    with a 64 bp query pass it, one more target does not, and every padded
    length's largest admitted section is within the wide form."""
    budget = tt.TesseraeDevice.HBM_BUDGET_BYTES
    assert tt.gate_max_cells(budget) == tt.MAX_WIDE_CELLS == 16_384 * 65
    assert tt.section_bytes(64, [64] * 16_384) <= budget < tt.section_bytes(64, [64] * 16_385)
    assert tt.wide_config(16_384, 65) == (16, 33, 8, 256)
    maxl = 64
    while tt.section_bytes(1, [maxl] * 2) <= budget:
        s = 2
        while tt.section_bytes(maxl, [maxl] * (2 * s)) <= budget:
            s *= 2
        assert s * (maxl + 1) <= tt.MAX_WIDE_CELLS
        assert tt.launch_config(s, maxl + 1)[1:] in (tt.kernel_config(s, maxl + 1)
                                                     if s * (maxl + 1) <= tt.MAX_CELLS
                                                     else tt.wide_config(s, maxl + 1),)
        maxl *= 2


@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_wide_sections_answer_on_the_device_path(name):
    """Sections the budget gate admits past the register form's cells: the
    port's TesseraeDevice answers on its device path (the plain twin on the
    CPU) and gives the widened oracle's path, llk within 1e-4 relative."""
    query, targets = wide_case(name)
    lens = [len(t) for t in targets.values()]
    assert len(targets) * (max(lens) + 1) == WIDE_CASES[name] > tt.MAX_CELLS
    assert tt.section_bytes(len(query), lens) <= tt.TesseraeDevice.HBM_BUDGET_BYTES
    prm = PARAMS[1]
    host = ptz.Tesserae(*prm)
    want = host.align(query, targets)
    dev = tt.TesseraeDevice(*prm, device="cpu")
    assert dev.align(query, targets) == want
    assert abs(dev.llk - host.llk) <= 1e-4 * abs(host.llk)
    assert dev.device_sections == 1 and dev.host_sections == 0
    assert len(want) >= 2


# small sections forced through the wide form, (cells a thread, clusters,
# CTAs a cluster, threads a CTA): runs of cells that cross many targets (16
# cells on targets of 1 and 6 bases), cluster edges inside targets (2-5
# clusters), partial and empty threads and clusters, one warp's CTA, one
# cluster, clusters of 1-3 CTAs
FORCED_WIDE = [("w2_63", (16, 1, 1, 32)), ("w2_100", (16, 1, 1, 32)),
               ("targets16", (16, 3, 2, 64)), ("targets16", None),
               ("many100", (16, 2, 2, 96)), ("recombinant0", (16, 2, 1, 32)),
               ("small", (16, 2, 1, 32)), ("tiny", (16, 1, 1, 32)), ("indels", (16, 1, 1, 32)),
               ("many100", (16, 4, 3, 32)), ("w7_300", (16, 3, 2, 32)),
               ("w7_300", (16, 5, 1, 32)), ("targets16", (16, 5, 1, 64))]


def test_forced_wide_configs_cover_their_sections():
    """Every forced wide config is a shape the kernel takes with a slot for
    each cell of its section, and the multi-cluster ones put cells in every
    cluster but the one left empty on purpose."""
    for case, config in FORCED_WIDE:
        _, t_codes, _, _ = _inputs(*_case(case), PARAMS[1])
        cells = t_codes.shape[0] * (t_codes.shape[1] + 1)
        per, clusters, cluster, threads = config or tt.wide_config(t_codes.shape[0],
                                                                   t_codes.shape[1] + 1)
        assert per == tt.WIDE_CELLS and threads % 32 == 0
        assert threads <= tt.WIDE_THREADS and cluster <= 8
        assert per * clusters * cluster * threads >= cells
        if case != "small":
            assert per * (clusters - 1) * cluster * threads < cells


# ---------------------------------------------------------------------------
# a numpy emulation of the wide form's column: per-thread runs of C cells,
# their Seg summaries and argmax candidates, each cluster's exclusive prefix
# and argmax over its threads (the warp, CTA and cluster levels, composed in
# one scan since the composition is associative), then the prefix of the
# clusters before each one and the column's argmax over the clusters; the
# delete state from each thread's prefix, the traceback bytes, the
# recombination words and the walk.  Float32 throughout, the kernel's lines
# in the kernel's order.
# ---------------------------------------------------------------------------

def _seg_combine(a, b):
    """Seg a then b, elementwise over arrays (first, last, v)."""
    af, al, av = a
    bf, bl, bv = b
    joined = (bf == bl) & (al == bf)
    v = np.where(af < 0, bv, np.where(bf < 0, av, np.where(joined, np.fmax(av, bv), bv)))
    return np.where(af < 0, bf, af), np.where(bf < 0, al, bl), v.astype(np.float32)


def _seg_exclusive_scan(seg):
    """Exclusive scan of Segs along the last axis (Hillis-Steele, as the
    warps' shuffle scans)."""
    f, l_, v = (x.copy() for x in seg)
    n = f.shape[-1]
    d = 1
    while d < n:
        pf = np.concatenate([np.full(f.shape[:-1] + (d,), -1), f[..., :-d]], -1)
        pl = np.concatenate([np.full(l_.shape[:-1] + (d,), -1), l_[..., :-d]], -1)
        pv = np.concatenate([np.full(v.shape[:-1] + (d,), -np.inf, np.float32), v[..., :-d]], -1)
        f, l_, v = _seg_combine((pf, pl, pv), (f, l_, v))
        d *= 2
    pad = lambda x, e, dt=None: np.concatenate(  # noqa: E731
        [np.full(x.shape[:-1] + (1,), e, dt), x[..., :-1]], -1)
    return pad(f, -1), pad(l_, -1), pad(v, -np.inf, np.float32)


def emulate_wide(args, config):
    """(max_r f32, cells, n, codes uint8[L+1, S, W], rec int64[L+1], the
    columns' max_r) of the wide form at `config` = (cells a thread,
    clusters, CTAs a cluster, threads a CTA)."""
    q, t_codes, valid, (scal, lsm, lsi) = args
    per, clusters, cluster, threads = config
    f32 = np.float32
    ldel, leps, lrho, lpim, lpii, lmm, lgm, ldm, lsize = (f32(x) for x in scal.numpy())
    lsm, lsi = lsm.numpy(), lsi.numpy()
    small = f32(tt.SMALL)
    q = q.numpy()
    s_count, width = t_codes.shape[0], t_codes.shape[1] + 1
    n_cells = s_count * width
    n_threads = clusters * cluster * threads
    slots = n_threads * per
    assert slots >= n_cells
    flat = np.arange(slots)
    live = flat < n_cells
    s_of, j_of = np.where(live, flat // width, -1), np.where(live, flat % width, 0)
    ok = np.zeros(slots, bool)
    tcode = np.zeros(slots, np.int64)
    inner = live & (j_of >= 1)
    ok[inner] = valid.numpy()[s_of[inner], j_of[inner] - 1]
    tcode[inner] = t_codes.numpy()[s_of[inner], j_of[inner] - 1]
    dterm = tt.delete_term(scal[0], scal[1], width)[0].numpy()
    jf = j_of.astype(f32)
    vm = np.full(slots, small, f32)
    vi, vd = vm.copy(), vm.copy()
    codes = np.zeros((len(q) + 1, slots), np.uint8)
    rec = np.zeros(len(q) + 1, np.int64)
    col_max = []
    max_r, best = f32(0.0), 0
    shift = lambda x: np.concatenate([[small], x[:-1]]).astype(f32)  # noqa: E731
    for col in range(1, len(q) + 1):
        qc, first = int(q[col - 1]), col == 1
        min_j = 1 if first else 2
        recomb = ((max_r + lrho) + lpim) - lsize
        recomb_i = ((max_r + lrho) + lpii) - lsize
        em, emi = lsm[qc][tcode], lsi[qc]
        code = np.zeros(slots, np.uint8)
        if first:
            m = np.where(ok, (lpim - lsize) + em, small).astype(f32)
            v = np.where(ok, (lpii - lsize) + emi, small).astype(f32)
        else:
            # a thread's left neighbour is the previous flat cell, across a
            # thread's, CTA's or cluster's edge alike
            c0 = np.where(j_of >= 1, shift(vm), small) + lmm
            c1 = np.where(j_of >= 1, shift(vi), small) + lgm
            c2 = np.where(j_of >= 1, shift(vd), small) + ldm
            lval, larg = c0, np.zeros(slots, np.int64)
            larg = np.where(c1 > lval, 1, larg)
            lval = np.where(c1 > lval, c1, lval)
            larg = np.where(c2 > lval, 2, larg)
            lval = np.where(c2 > lval, c2, lval)
            use_local = lval > recomb
            m = np.where(use_local, lval, recomb)
            m = np.where(j_of == 0, small, np.where(ok, m + em, small)).astype(f32)
            i0, i1 = vm + ldel, vi + leps
            iarg = (i1 > i0).astype(np.int64)
            ival = np.where(iarg == 1, i1, i0)
            use_i = ival > recomb_i
            v = np.where(use_i, ival, recomb_i)
            v = np.where(j_of == 0, small, np.where(ok, v + emi, small)).astype(f32)
            code = (np.where(use_local, larg + 1, 0) | (np.where(use_i, iarg + 1, 0) << 2)
                    ).astype(np.uint8)
        m, v = np.where(live, m, small).astype(f32), np.where(live, v, small).astype(f32)
        vm, vi = m, v
        adj = np.where(j_of >= min_j - 1, m - leps * jf, small).astype(f32)
        # ---- per thread: its run's Seg and argmax candidate
        run_s = s_of.reshape(n_threads, per)
        run_live = live.reshape(n_threads, per)
        last = np.where(run_live, run_s, -1).max(1)
        firsts = np.where(run_live[:, 0], run_s[:, 0], -1)
        in_last = run_live & (run_s == last[:, None])
        seg_v = np.where(in_last, adj.reshape(n_threads, per), -np.inf).max(1).astype(f32)
        mine = (firsts, np.where(firsts >= 0, last, -1),
                np.where(firsts >= 0, seg_v, -np.inf).astype(f32))
        cand = np.stack([np.where(ok, m, small), np.where(ok, v, small)], 1)
        cand = np.where(live[:, None], cand, -np.inf).reshape(n_threads, 2 * per)
        t_arg = cand.argmax(1)
        t_bv = cand[np.arange(n_threads), t_arg]
        t_bi = np.where(np.isfinite(t_bv), 2 * (np.arange(n_threads) * per) + t_arg, 2 ** 31 - 1)
        # ---- each cluster over its threads
        by_cluster = tuple(x.reshape(clusters, cluster * threads) for x in mine)
        within = _seg_exclusive_scan(by_cluster)
        totals = _seg_combine(tuple(x[:, -1] for x in within),
                              tuple(x[:, -1] for x in by_cluster))
        c_bv = t_bv.reshape(clusters, -1)
        c_arg = c_bv.argmax(1)            # the first thread of the cluster's best
        c_best = (c_bv[np.arange(clusters), c_arg], t_bi.reshape(clusters, -1)[
            np.arange(clusters), c_arg])
        # ---- the grid: the clusters before each one, the column's argmax
        before = [(np.array(-1), np.array(-1), np.float32(-np.inf))]
        for c in range(clusters - 1):
            before.append(_seg_combine(before[-1], tuple(x[c] for x in totals)))
        gv, gi = -np.inf, 2 ** 31 - 1
        for c in range(clusters):
            if c_best[0][c] > gv or (c_best[0][c] == gv and c_best[1][c] < gi):
                gv, gi = c_best[0][c], int(c_best[1][c])
        max_r, best = f32(gv), gi
        col_max.append(max_r)
        excl = _seg_combine(tuple(np.repeat([np.asarray(b[k]) for b in before], cluster * threads)
                                  for k in range(3)),
                            tuple(x.reshape(-1) for x in within))
        # ---- pass B: each thread's delete state from its prefix
        run = np.where((excl[0] >= 0) & (excl[1] == run_s[:, 0]), excl[2], -np.inf).astype(f32)
        d = np.full(slots, small, f32).reshape(n_threads, per)
        adj_t, j_t = adj.reshape(n_threads, per), j_of.reshape(n_threads, per)
        for i in range(per):
            j = j_t[:, i]
            run = np.where(j == 0, f32(-np.inf), run)
            run_prev = np.where(j == 0, small, run)
            d[:, i] = np.where(j >= min_j, dterm[j] + run_prev, small)
            run = np.fmax(run, adj_t[:, i])
        vd = np.where(live, d.reshape(-1), small).astype(f32)
        mb = np.where(j_of == 0, small, shift(vm)) + ldel
        db = np.where(j_of == 0, small, shift(vd)) + leps
        codes[col] = np.where(live, code | np.where(mb >= db, 0, 16), 0)
        two_w = 2 * width
        rec[col] = tt._word(best // two_w + 1, tt.M if (best % two_w) % 2 == 0 else tt.I,
                            (best % two_w) // 2)
    two_w = 2 * width
    codes = torch.from_numpy(codes[:, :n_cells].reshape(len(q) + 1, s_count, width).copy())
    cells, n = tt.decode_traceback(codes, torch.from_numpy(rec), best // two_w + 1,
                                   tt.M if (best % two_w) % 2 == 0 else tt.I,
                                   (best % two_w) // 2)
    return max_r, cells, n, codes, rec, col_max


EMULATED = [("w2_100", (16, 1, 1, 32)), ("targets16", (16, 3, 2, 64)),
            ("many100", (16, 4, 3, 32)), ("w7_300", (16, 3, 2, 32)),
            ("w7_300", (16, 5, 1, 32)), ("indels", (16, 1, 1, 32)), ("small", (16, 2, 1, 32)),
            ("tiny", (16, 1, 1, 32))]


@pytest.mark.parametrize("case, config", EMULATED)
def test_wide_composition_emulated_matches_the_twin(case, config):
    """The emulated wide form (its runs, clusters and grid) gives the twin's
    path and max_r in bits, every column's traceback bytes, every
    recombination word the walk can read, and the twin's max_r at the
    columns where a query prefix ends."""
    args = _inputs(*_case(case), PARAMS[1])
    max_r, cells, n, codes, rec, col_max = emulate_wide(args, config)
    tb, who, state, pos, want_r = tt.tesserae_scan(*args)
    want_cells, want_n = tt.tesserae_traceback(tb, who, state, pos)
    assert n == want_n
    np.testing.assert_array_equal(cells[:n].numpy(), want_cells[:n].numpy())
    assert np.float32(max_r).view(np.int32) == np.float32(want_r.item()).view(np.int32)
    want_codes, want_rec = tt.encode_traceback(tb)
    np.testing.assert_array_equal(codes.numpy(), want_codes.numpy())
    used = want_rec.numpy() != 0
    np.testing.assert_array_equal(rec[used], want_rec.numpy()[used])
    q = args[0]
    for end in sorted({2, len(q) // 2, len(q) - 1} & set(range(2, len(q) + 1))):
        part = tt.tesserae_scan(q[:end], *args[1:])[4]
        assert np.float32(col_max[end - 1]).view(np.int32) == \
            np.float32(part.item()).view(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case, config", FORCED_WIDE)
def test_wide_form_matches_plain_on_small_sections_on_card(cuda, case, config):
    args = _inputs(*_case(case), PARAMS[1], cuda)
    before, wide_before = tt.LAUNCHES, tt.WIDE_LAUNCHES
    max_r, cells, n = tt.tesserae_fused(*args, config=config, wide=True)
    torch.cuda.synchronize()
    assert (tt.LAUNCHES, tt.WIDE_LAUNCHES) == (before + 1, wide_before + 1)
    want_r, want_cells, want_n = tt.tesserae_full(*args)
    assert int(n) == want_n
    np.testing.assert_array_equal(cells[:want_n].cpu().numpy(),
                                  want_cells[:want_n].cpu().numpy())
    assert np.float32(max_r.item()).view(np.int32) == \
        np.float32(want_r.item()).view(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_wide_form_matches_plain_on_card(cuda, name):
    """The gate's sections past the register form, through the wide form on
    the card against the plain twin on the card: cells and max_r bit for
    bit."""
    query, targets = wide_case(name)
    args = _inputs(query, targets, PARAMS[1], cuda)
    assert tt.launch_config(args[1].shape[0], args[1].shape[1] + 1)[0]
    wide_before = tt.WIDE_LAUNCHES
    max_r, cells, n = tt.tesserae_fused(*args)
    torch.cuda.synchronize()
    assert tt.WIDE_LAUNCHES == wide_before + 1
    want_r, want_cells, want_n = tt.tesserae_full(*args)
    assert int(n) == want_n
    np.testing.assert_array_equal(cells[:want_n].cpu().numpy(),
                                  want_cells[:want_n].cpu().numpy())
    assert np.float32(max_r.item()).view(np.int32) == \
        np.float32(want_r.item()).view(np.int32)


@pytest.mark.cuda
def test_wide_form_refuses_a_grid_that_does_not_co_reside_on_card(cuda):
    """A grid of more clusters than the card holds at once raises in the
    wrapper (no launch, no other form), and the gate's largest section's grid
    co-resides."""
    per, clusters, cluster, threads = tt.wide_config(16_384, 65)
    room = tt.wide_kernel_info(cuda, per, cluster, threads)["max_clusters"]
    assert room >= clusters
    args = _inputs(*_case("w2_100"), PARAMS[1], cuda)
    before = tt.LAUNCHES
    with pytest.raises(ValueError, match="holds"):
        tt.tesserae_fused(*args, config=(per, room + 1, cluster, threads), wide=True)
    assert tt.LAUNCHES == before


# ---------------------------------------------------------------------------
# the exact form: the sections that TesseraeDevice's budget gate takes off the
# float32 forms (the JAX package's host-oracle sections), aligned in float64
# in the oracle's own order of operations, on the card by ctk_tesserae_f64
# and on the CPU by the plain twin with float64 parameters.  Both must give
# the JAX package's numpy oracle's path and llk exactly (every section here
# has 63 targets or fewer, so that oracle's int32 word holds).
# ---------------------------------------------------------------------------

EXACT_CASES = CASES + ["tiny", "many1", "many8", "many63", "longquery"]


def exact_align(query, targets, prm, device="cpu", config=None):
    """(path, llk) of the exact form on `device` (the plain twin on the
    CPU): tesserae_fused with float64 parameters, the path built as the
    oracle builds it, llk = max_r + log(term)."""
    args = tt.section_inputs(query, list(targets.values()), prm, device, torch.float64)
    max_r, cells, n = tt.tesserae_fused(*args, config=config)
    cells = [tuple(c) for c in cells[:int(n) - 1].cpu().tolist()]
    cells.reverse()
    path = ptz.Tesserae(*prm)._build_path(query, list(targets), list(targets.values()), cells)
    return path, float(max_r) + math.log(prm[3])


def _oracle_params(del_, eps, rho, term):
    """(ldel, leps, lrho, lpiM, lpiI, lmm, lgm, ldm), lsm, lsi in float64,
    as the JAX package's host oracle (corticall_tpu/models/tesserae.py,
    Tesserae.align) computes them."""
    pi_m = 0.75
    scal = [math.log(del_), math.log(eps), math.log(rho), math.log(pi_m), math.log(1 - pi_m),
            math.log(1 - 2 * del_ - rho - term), math.log(1 - eps - rho - term),
            math.log(1 - eps)]
    return scal, np.log(tz.EMISS_MATCH_NT), np.log(tz.EMISS_GAP_NT)


@pytest.mark.parametrize("prm", PARAMS)
def test_exact_params_are_the_oracles(prm):
    """The exact form's parameters are the JAX package's oracle's doubles,
    unrounded, and so are the port's oracle's (hmm_params, which both share);
    the delete term is numpy's ldel + leps * (j - 1), rounded twice."""
    want, want_sm, want_si = _oracle_params(*prm)
    hp = ptz.hmm_params(*prm)
    assert [hp.ldel, hp.leps, hp.lrho, hp.lpiM, hp.lpiI, hp.lmm, hp.lgm, hp.ldm] == want
    assert hp.lterm == math.log(prm[3])
    np.testing.assert_array_equal(hp.lsm, want_sm)
    np.testing.assert_array_equal(hp.lsi, want_si)
    scal, lsm, lsi = tt.tesserae_params(*prm, 1234.0, dtype=torch.float64)
    assert scal.tolist() == want + [math.log(1234.0)]
    np.testing.assert_array_equal(lsm.numpy(), want_sm)
    np.testing.assert_array_equal(lsi.numpy(), want_si)
    width = 5000
    got = tt.delete_term(scal[0], scal[1], width)
    assert got.shape == (1, width) and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy()[0],
                                  want[0] + want[1] * (np.arange(width)[None, :] - 1)[0])


@pytest.mark.parametrize("prm", PARAMS)
@pytest.mark.parametrize("case", EXACT_CASES)
def test_exact_twin_is_the_oracle(case, prm):
    """The plain twin in float64 gives the JAX package's numpy oracle's path
    and llk with ==: recombinant, indel and many-target sections, a
    one-column query, 1, 8 and 63 targets, and a query longer than every
    target (the oracle's padding against the port's).  The port's copy of the
    oracle, which the card's tests and the flagship's route share, gives the
    same."""
    query, targets = _case(case)
    host = tz.Tesserae(*prm)
    want = host.align(query, targets)
    path, llk = exact_align(query, targets, prm)
    assert path == want
    assert llk == host.llk
    copy = ptz.Tesserae(*prm)
    assert copy.align(query, targets) == want and copy.llk == host.llk


def test_exact_twin_is_the_oracle_on_tie_prone_sections():
    """The cross section and the 60 tie-prone sections, whose gaps among
    equal bases a tie places: the float64 twin, and the port's copy of the
    oracle, give the JAX package's oracle's path and llk on every one."""
    prm = PARAMS[1]
    differ, copy_differs = [], []
    for i, (query, targets) in enumerate([_cross_section(), *tie_prone_sections()]):
        host = tz.Tesserae(*prm)
        want = host.align(query, targets)
        if exact_align(query, targets, prm) != (want, host.llk):
            differ.append(i)
        copy = ptz.Tesserae(*prm)
        if (copy.align(query, targets), copy.llk) != (want, host.llk):
            copy_differs.append(i)
    assert not differ, f"sections {differ} differ from the oracle's"
    assert not copy_differs, f"the port's oracle differs on sections {copy_differs}"


# the flagship's gated section: a 1,853 bp query against 6 targets of up to
# 3,661 bases (21,972 cells), 2.4 GB by section_bytes
FLAGSHIP_QUERY, FLAGSHIP_TARGETS = 1853, [3661, 3661, 3540, 3402, 3317, 3104]


def test_section_route():
    """Every route: the flagship's gated section is "exact" on a card and
    "host" on the CPU; a gated section past MAX_CELLS_F64 is "host" on both;
    the gate's edge (16,384 targets of 64 bases against 16,385) is unchanged;
    below the gate the float32 forms by their cells, on either device."""
    budget = tt.TesseraeDevice.HBM_BUDGET_BYTES
    assert tt.section_bytes(FLAGSHIP_QUERY, FLAGSHIP_TARGETS) > budget
    assert 6 * 3662 <= tt.MAX_CELLS_F64
    assert tt.section_route("cuda", FLAGSHIP_QUERY, FLAGSHIP_TARGETS, budget) == "exact"
    assert tt.section_route("cpu", FLAGSHIP_QUERY, FLAGSHIP_TARGETS, budget) == "host"
    past = [8000] * (tt.MAX_CELLS_F64 // 8001 + 1)
    assert len(past) * 8001 > tt.MAX_CELLS_F64 and tt.section_bytes(100, past) > budget
    for device in ("cuda", "cpu"):
        assert tt.section_route(device, 100, past, budget) == "host"
        assert tt.section_route(device, 64, [64] * 16_384, budget) == "wide"
        assert tt.section_route(device, 64, [64] * 16_385, budget) == "host"
        assert tt.section_route(device, 466, [700] * 6, budget) == "register"
        assert tt.section_route(device, 500, [512] * 256, budget) == "wide"
    # the gate's own verdict, budget and all: a budget the section fits moves it
    assert tt.section_route("cuda", FLAGSHIP_QUERY, FLAGSHIP_TARGETS, 4 << 30) == "register"


def test_exact_config_and_its_limit():
    """The exact form's shape at the flagship section (4 cells a thread, 16
    CTAs) and its limit, named when a section passes it; float64 has no wide
    form."""
    width = max(FLAGSHIP_TARGETS) + 1
    assert tt.kernel_config(6, width, exact=True) == (4, 16, 352)
    most = tt.MAX_CELLS_F64 // 4097
    per, cluster, threads = tt.kernel_config(most, 4097, exact=True)
    assert per <= tt.EXACT_CELLS_PER_THREAD and per * cluster * threads >= most * 4097
    with pytest.raises(ValueError, match=str(tt.MAX_CELLS_F64)):
        tt.kernel_config(1, tt.MAX_CELLS_F64 + 1, exact=True)
    query, targets = _case("small")
    args = tt.section_inputs(query, list(targets.values()), PARAMS[1], dtype=torch.float64)
    with pytest.raises(ValueError, match="wide"):
        tt.tesserae_fused(*args, wide=True)


def flagship_section():
    """A section of the flagship's gated shape: six targets cut from two
    parental haplotypes with 2% substitutions, the query a mosaic of two of
    them with 0.5% substitutions and a 5-base deletion."""
    rng = np.random.default_rng(1853)
    parents = [_genome(rng, 3800), _genome(rng, 3800)]
    targets = {}
    for i, n in enumerate(FLAGSHIP_TARGETS):
        start = int(rng.integers(0, 3800 - n + 1))
        targets[f"{('mom', 'dad')[i % 2]}_{i // 2}"] = _mutate(rng, parents[i % 2], 0.02)[
            start:start + n]
    a, b = targets["mom_0"], targets["dad_0"]
    query = a[900:1800] + b[1800:2760]
    query = _mutate(rng, query[:1000] + query[1005:], 0.005)[:FLAGSHIP_QUERY]
    assert len(query) == FLAGSHIP_QUERY
    assert [len(t) for t in targets.values()] == FLAGSHIP_TARGETS
    return query, targets


@pytest.fixture(scope="module")
def flagship_oracle():
    """The flagship-shaped section and the JAX package's numpy oracle's path
    and llk (for the card's tests only: a few seconds of the oracle).  The
    port's copy of the oracle must give the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    query, targets = flagship_section()
    host = tz.Tesserae(*PARAMS[1])
    want = host.align(query, targets)
    copy = ptz.Tesserae(*PARAMS[1])
    assert copy.align(query, targets) == want and copy.llk == host.llk
    return query, targets, want, host.llk


# forced (cells a thread, cluster, threads) for the exact form: CTA edges
# inside targets at every cell count it instantiates, clusters of 1-16 CTAs
EXACT_FORCED = [("w2_16", (1, 8, 32)), ("w2_63", (2, 2, 32)), ("targets16", (1, 16, 288)),
                ("targets16", (2, 8, 288)), ("targets16", (4, 4, 288)),
                ("targets16", (2, 16, 160)), ("recombinant0", (1, 4, 224)),
                ("longquery", (2, 2, 96)), ("tiny", None), ("many63", None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case, config", EXACT_FORCED)
def test_exact_form_is_the_oracle_on_small_sections_on_card(cuda, case, config):
    query, targets = _case(case)
    prm = PARAMS[1]
    host = tz.Tesserae(*prm)
    want = host.align(query, targets)
    before, exact_before = tt.LAUNCHES, tt.EXACT_LAUNCHES
    assert exact_align(query, targets, prm, cuda, config) == (want, host.llk)
    assert (tt.LAUNCHES, tt.EXACT_LAUNCHES) == (before + 1, exact_before + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("config", [None, (4, 16, 384), (4, 16, 448), (4, 16, 512)])
def test_exact_form_is_the_oracle_on_the_flagship_section_on_card(cuda, flagship_oracle,
                                                                     config):
    """ctk_tesserae_f64 on the flagship-shaped gated section, at its own
    shape and with CTA edges moved inside the targets: the oracle's path and
    llk with ==."""
    query, targets, want, llk = flagship_oracle
    assert exact_align(query, targets, PARAMS[1], cuda, config) == (want, llk)


@pytest.mark.cuda
def test_exact_route_on_card(cuda, flagship_oracle):
    """TesseraeDevice on the card sends the gated section to the exact form
    (no host section), under tesserae.align -> tesserae.exact -> the device
    section's spans, and returns the oracle's path and llk."""
    from corticall_tpu_torch.utils import profiling

    query, targets, want, llk = flagship_oracle
    dev = tt.TesseraeDevice(*PARAMS[1], device=cuda)
    with profiling.recording():
        got = dev.align(query, targets)
    spans = profiling.recorded()
    profiling.clear()
    assert got == want and dev.llk == llk
    assert (dev.exact_sections, dev.host_sections, dev.device_sections) == (1, 0, 0)
    kids = profiling.children(spans)
    (align,) = [sp for sp in spans if sp.name == "tesserae.align"]
    (exact,) = [sp for sp in spans if sp.name == "tesserae.exact"]
    assert [c.name for c in kids[align.index]] == ["tesserae.exact"]
    assert [c.name for c in kids[exact.index]] == ["tesserae.pack", "tesserae.launch",
                                                   "tesserae.wait", "tesserae.fetch",
                                                   "tesserae.decode"]


@pytest.mark.cuda
def test_exact_form_holds_its_cells_in_registers_on_card(cuda):
    """The exact form's instantiations, up to EXACT_CELLS_PER_THREAD cells a
    thread, spill nothing, and the kernel has none past it (the Python limit
    and the CUDA one, kRegisterCells<double>, agree)."""
    per = 1
    while per <= tt.EXACT_CELLS_PER_THREAD:
        assert tt.exact_kernel_info(cuda, per)["local_bytes"] == 0
        per *= 2
    with pytest.raises(RuntimeError):
        tt.exact_kernel_info(cuda, 2 * tt.EXACT_CELLS_PER_THREAD)
