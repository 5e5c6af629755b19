"""Port's Tesserae (corticall_tpu_torch/ops/tesserae_torch.py) against the
JAX package's _tesserae_full on CPU XLA and its own CUDA kernel against the
plain twin: traceback cells identical, max_r within 1e-6 relative (equal in
bits on the card, where both sides run the same float32 operations)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corticall_tpu.models import tesserae as tz  # noqa: E402
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
    if name.startswith("w2_"):
        # S one-base targets (W = 2) against a 40-base query
        rng = np.random.default_rng(int(name[3:]))
        return _genome(rng, 40), {f"t{i}": _genome(rng, 1)
                                  for i in range(int(name[3:]))}
    n_targets = int(name[len("targets"):])
    rng = np.random.default_rng(n_targets)
    base = _genome(rng, 260)
    targets = {f"t{i}": _mutate(rng, base, 0.04)[int(rng.integers(0, 30)):]
               for i in range(n_targets)}
    seqs = list(targets.values())
    query = seqs[3][:90] + seqs[11][90:170] + seqs[7][170:]
    return _mutate(rng, query, 0.01), targets


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
    assert dev.host_sections == 1 and dev.device_sections == 0


@pytest.mark.parametrize("prm", PARAMS)
@pytest.mark.parametrize("case", CASES + ["tiny", "w2_63"])
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
    with pytest.raises(ValueError, match=str(tt.MAX_CELLS)):
        tt.kernel_config(63, 2100)


def test_wrapper_validates_and_counts_no_cpu_launch():
    args = _inputs(*_case("small"), PARAMS[0])
    before = tt.LAUNCHES
    max_r, cells, n = tt.tesserae_fused(*args)
    assert tt.LAUNCHES == before and n >= 2
    with pytest.raises(ValueError):
        tt.tesserae_fused(args[0], args[1], args[2][:, :-1], args[3])
    many = torch.zeros((64, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        tt.tesserae_fused(args[0], many, many.bool(), args[3])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ["tiny"])
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
