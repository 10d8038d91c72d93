"""The premises of the fused generic kernel's layout
(qkd_ldpc_v_tpu_torch/csrc/fused_generic.cu), checked on the CPU.

  * The compressed min-sum check (``ops/fused_generic.py::compress_check``
    and ``rebuild_check``, the plain mirror of the kernel's ``minsum_run``)
    rebuilds every check->bit value of the plain decoder's check update
    (``ops/decoders.py::_minsum_values`` and the clamp) bit for bit, for
    rows of up to 64 edges, the four min-sum algorithms and the clamp off,
    positive and negative, with the generic decoder's tie rule where every
    |message| is inf, and with NaN messages.
  * A plain mirror of the kernel's sweep (stored checks, messages formed on
    read, the parity test riding in the check pass, the bit pass by bit
    ownership through the (check, slot) table) decodes exactly as the plain
    decoder does.
  * The kernel's tables (``fused_tables``), node-major (min-sum) and
    slot-major (the SPA pair): the check bits and bit-major (check, slot)
    words, through each node's Row, and the inverse of bit_ext address
    every edge and bit once, on every committed generic-feasible asset
    (alist, formats 1 and 2).
  * The launch plan (``launch_plan``, the mirror of the kernel's shared
    layout) by hand on the 10k alist code, and its fit edges: where two
    blocks stop sharing an SM, and where the checks leave shared memory.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.config import MatrixFormat
from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc
from qkd_ldpc_v_tpu_torch.models.hmatrix import (
    read_matrix,
    read_sparse_matrix_alist,
)
from qkd_ldpc_v_tpu_torch.models.layout import layout_for
from qkd_ldpc_v_tpu_torch.ops import fused_generic as fg
from qkd_ldpc_v_tpu_torch.ops import launch
from qkd_ldpc_v_tpu_torch.ops.channel import (
    calculate_syndrome,
    inject_errors,
    log_ratio,
)
from qkd_ldpc_v_tpu_torch.ops.decoders import _minsum_values, get_decoder

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ALIST10K = (REPO / "sparse_matrices" / "matrices_alist"
            / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx")
FMAX = float(np.finfo(np.float32).max)
SPECIAL = [0.0, -0.0, 1.5, -1.5, 0.25, -0.25, float("inf"), float("-inf"),
           float("nan"), FMAX, -FMAX, 1e-45, -1e-45]
ALGS = {"NMSA": (0.8, 1.0), "OMSA": (0.3, 1.0), "ANMSA": (0.88, 0.5),
        "AOMSA": (0.5, 3.0)}
CLAMPS = [(False, 0.0), (True, 0.75), (True, -0.5)]
_GENERIC_ASSETS = sorted(
    (path, fmt)
    for fmt in (MatrixFormat.ALIST, MatrixFormat.SPARSE_1,
                MatrixFormat.SPARSE_2)
    for path in (REPO / "sparse_matrices" / fmt.directory_name).glob("*.mtrx")
)


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit patterns, or NaN in both (a NaN message's sign reaches no
    decision)."""
    same = got.view(torch.int32) == want.view(torch.int32)
    return bool((same | (got.isnan() & want.isnan())).all())


def _plain_values(msgs, syn, factor, alg, use_threshold, threshold):
    """The plain decoder's check update of checks whose messages are
    ``msgs`` (one tensor of checks per slot): ``_minsum_values`` on
    [checks, degree, 1], then the decoder's clamp; one tensor per slot."""
    one = torch.tensor(1.0)
    m = torch.stack(msgs, dim=1)[:, :, None]
    ss = torch.where(syn == 1, -one, one)[:, None]
    normalized = alg in ("NMSA", "ANMSA")
    e = _minsum_values(m, ss, factor[:, None, None], normalized,
                       torch.tensor(FMAX), one)
    if use_threshold:
        t = torch.tensor(threshold)
        e = torch.clamp(e, min=-t, max=t)
    return list(e[:, :, 0].unbind(1))


def _check_row(msgs, syn, second, alg, use_threshold, threshold):
    f1, f2 = ALGS[alg]
    adaptive = alg in ("ANMSA", "AOMSA")
    factor = torch.where(second & adaptive, torch.tensor(f2), torch.tensor(f1))
    want = _plain_values(msgs, syn, factor, alg, use_threshold, threshold)
    p1, p2, bits = fg.compress_check(msgs, syn, factor,
                                     alg in ("OMSA", "AOMSA"), use_threshold,
                                     threshold)
    got = fg.rebuild_check(p1, p2, bits, use_threshold and threshold < 0.0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _same_bits(g, w)


_message = st.one_of(
    st.sampled_from(SPECIAL),
    st.floats(width=32, allow_nan=True, allow_infinity=True))


@st.composite
def _rows(draw):
    """(messages [deg] of [checks], syndrome bits, secondary mask): 3 checks
    of 1-64 edges each."""
    deg = draw(st.integers(1, 64))
    checks = 3
    vals = draw(st.lists(_message, min_size=deg * checks,
                         max_size=deg * checks))
    msgs = torch.tensor(vals, dtype=torch.float32).reshape(deg, checks)
    syn = torch.tensor(draw(st.lists(st.integers(0, 1), min_size=checks,
                                     max_size=checks)), dtype=torch.int8)
    second = torch.tensor(draw(st.lists(st.booleans(), min_size=checks,
                                        max_size=checks)))
    return list(msgs.unbind(0)), syn, second


@pytest.mark.parametrize("use_threshold,threshold", CLAMPS)
@pytest.mark.parametrize("alg", list(ALGS))
def test_compressed_check_rebuilds_every_value(alg, use_threshold, threshold):
    @settings(max_examples=80, deadline=None, derandomize=True)
    @given(_rows())
    def check(row):
        _check_row(*row, alg, use_threshold, threshold)

    check()


@pytest.mark.parametrize("use_threshold,threshold", CLAMPS)
@pytest.mark.parametrize("alg", list(ALGS))
def test_all_inf_and_nan_rows_follow_the_generic_tie_rule(alg, use_threshold,
                                                          threshold):
    """Rows where every |message| is inf (the plain decoder's second minimum
    is inf there, not the float32 maximum the chain starts from), rows with
    one finite message among infs, and rows with a NaN, at 1, 2, 15, 16, 17
    and 63 edges."""
    for deg in (1, 2, 15, 16, 17, 63):
        signs = torch.tensor([1.0, -1.0, 1.0])
        all_inf = [signs * float("inf") * (-1.0) ** k for k in range(deg)]
        one_finite = [torch.where(torch.tensor([k == 0, k == deg - 1, False]),
                                  torch.tensor(2.5), s)
                      for k, s in enumerate(all_inf)]
        with_nan = [torch.where(torch.tensor([k == deg // 2, False, True]),
                                torch.tensor(float("nan")), s)
                    for k, s in enumerate(one_finite)]
        for msgs in (all_inf, one_finite, with_nan):
            for syn in (torch.tensor([0, 1, 0], dtype=torch.int8),
                        torch.tensor([1, 0, 1], dtype=torch.int8)):
                _check_row(msgs, syn, torch.tensor([True, False, True]), alg,
                           use_threshold, threshold)
    # The rule is what tells the generic form from the QC kernels': at two
    # inf messages the second minimum is inf.
    p1, p2, _ = fg.compress_check([torch.tensor([float("inf")])] * 2,
                                  torch.tensor([0], dtype=torch.int8),
                                  torch.tensor([1.0]), False, False, 0.0)
    assert p2.isinf().all()


# ---------------------------------------------------------------------------
# A plain mirror of the kernel's sweep.
# ---------------------------------------------------------------------------


def _tables(layout, slot_major):
    """The fused kernel's tables by name, and each node's table positions
    (its Row's slots in order): ``cpos[c]`` of check c, ``bpos[i]`` of bit
    i."""
    n, m, e, _ = fg.code_shape(layout)
    t = fg.fused_tables(layout, slot_major).astype(np.int64)
    parts, o = {}, 0
    for name, size in (("crow", 4 * m), ("brow", 4 * n), ("cbit", e),
                       ("pad", fg.RUN), ("bent", e), ("bit_ext", n),
                       ("chk_ext", m), ("ext_bit", n)):
        parts[name], o = t[o:o + size], o + size
    assert o == len(t)
    crow, brow = parts["crow"].reshape(m, 4), parts["brow"].reshape(n, 4)
    parts["cpos"] = [r[0] + r[1] * np.arange(r[2]) for r in crow]
    parts["bpos"] = [r[0] + r[1] * np.arange(r[2]) for r in brow]
    parts["crow"], parts["brow"] = crow, brow
    return parts


def _kernel_sweep(matrix, alg, cap, use_threshold, llr_ext, syn_ext, f1, f2,
                  threshold, slot_major):
    """The fused generic kernel's decode, frame by frame as its blocks run
    it, in torch: checks stored in compressed form (starting as values that
    rebuild as +0), each message formed as clamp(t - v) on read (the first
    sweep unclamped), the parity of the decisions read in the check pass as
    the adaptive factor and the convergence test, the bit pass by bit
    ownership over the (check, slot) words in slot order, a parity-only
    pass after the last sweep, every edge addressed through the Rows of
    the tables (node-major, min-sum's, or ``slot_major``, the SPA pair's).
    Returns (decisions, conv, iterations)."""
    layout = layout_for(matrix)
    n, m, e, _ = fg.code_shape(layout)
    t = _tables(layout, slot_major)
    cbit, bent, cpos, bpos = t["cbit"], t["bent"], t["cpos"], t["bpos"]
    adaptive = alg in ("ANMSA", "AOMSA")
    neg_same = use_threshold and threshold < 0
    check_of = np.zeros(e, dtype=np.int64)
    for c in range(m):
        check_of[cpos[c]] = c
    check_of = torch.tensor(check_of)
    out = []
    for llr_row, syn_row in zip(llr_ext, syn_ext):
        llr = llr_row[t["bit_ext"]]
        syn = syn_row[t["chk_ext"]].to(torch.int8)
        tot = llr.clone()
        zero = 0.0 if neg_same else -0.0
        p1 = torch.full((m,), zero)
        p2 = torch.full((m,), zero)
        bits = torch.full((e,), 1 if neg_same else 0, dtype=torch.int32)

        def values():
            v = torch.where(bits & 2 != 0, p2[check_of], p1[check_of])
            return v if neg_same else torch.where(bits & 1 != 0, v, -v)

        def parity():
            d = (tot <= 0).to(torch.int64)[cbit]
            sums = torch.zeros(m, dtype=torch.int64).index_add_(
                0, check_of, d)
            return (sums + syn.to(torch.int64)) % 2

        conv, iters = False, cap
        for it in range(cap):
            bound = threshold if (use_threshold and it > 0) else float("inf")
            b = torch.tensor(bound)
            msgs = torch.minimum(torch.maximum(tot[cbit] - values(), -b), b)
            par = parity()
            if (adaptive or it > 0) and not bool(par.any()):
                conv, iters = True, it + 1 if adaptive else it
                break
            fac = torch.where((par != 0) & adaptive, torch.tensor(f2),
                              torch.tensor(f1))
            for c in range(m):
                row = [msgs[q:q + 1] for q in cpos[c]]
                a1, a2, bb = fg.compress_check(
                    row, syn[c:c + 1], fac[c:c + 1], alg in ("OMSA", "AOMSA"),
                    use_threshold, threshold)
                p1[c], p2[c] = a1[0], a2[0]
                for k, word in enumerate(bb):
                    bits[cpos[c][k]] = int(word[0]) | (1 if neg_same else 0)
            v = values()
            new = llr.clone()
            for i in range(n):
                for q in bpos[i]:
                    c, slot = bent[q] & 0xffff, bent[q] >> 16
                    new[i] = new[i] + v[cpos[c][slot]]
            tot = new
        if not adaptive and not conv and cap > 0 and not bool(parity().any()):
            conv = True
        out.append(((tot <= 0).to(torch.int8)[t["ext_bit"]], conv, iters))
    dec, conv, iters = zip(*out)
    return (torch.stack(dec), torch.tensor(conv),
            torch.tensor(iters, dtype=torch.int32))


@pytest.mark.parametrize("slot_major", [False, True])
@pytest.mark.parametrize("use_threshold,threshold", CLAMPS)
@pytest.mark.parametrize("alg", list(ALGS))
def test_kernel_sweep_mirror_equals_plain_decoder(alg, use_threshold,
                                                  threshold, slot_major):
    """On a small code in its waterfall (frames that converge at different
    sweeps and frames that run to the cap), the mirror's decisions,
    convergence and iterations equal the plain decoder's, through either
    table layout."""
    matrix = generate_regular_ldpc(96, 48, 3, seed=3)
    n, batch, cap, ne = 96, 6, 12, 6
    rng = np.random.default_rng(1)
    alice = torch.tensor(rng.integers(0, 2, (batch, n)), dtype=torch.int8)
    bits = torch.tensor(rng.integers(0, 2**32, (batch, n)), dtype=torch.int64)
    bob = inject_errors(bits, alice, ne, wide=True)
    lp = torch.tensor(log_ratio(ne / n), dtype=torch.float32)
    llr = torch.where(bob == 1, -lp, lp)
    layout = layout_for(matrix)
    syn = calculate_syndrome(layout, alice)
    f1, f2 = ALGS[alg]
    want = get_decoder(layout, TAlg[alg], cap, use_threshold, torch.float32)(
        llr, syn, f1, f2, threshold)
    got = _kernel_sweep(matrix, alg, cap, use_threshold, llr, syn, f1, f2,
                        threshold, slot_major)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# Tables and launch plan.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path,fmt", _GENERIC_ASSETS,
                         ids=[f"{f.name}-{p.stem}" for p, f in _GENERIC_ASSETS])
def test_fused_tables_address_every_edge_once(path, fmt, monkeypatch):
    def no_build():
        raise AssertionError("the tables and the plan must not build kernels")

    monkeypatch.setattr(kernels, "library", no_build)
    matrix = read_matrix(path, fmt)
    if not fg.generic_feasible(matrix):
        # The N=102400 alist code: the streamed generic kernel's, refused
        # before anything is built.
        with pytest.raises(NotImplementedError, match="streamed generic"):
            fg._Launch(matrix, launch.generic_flags(TAlg.NMSA),
                       torch.device("cpu"))
        return
    layout = layout_for(matrix)
    n, m, e, max_deg = fg.code_shape(layout)
    for slot_major in (False, True):
        t = _tables(layout, slot_major)
        cbit, bent, cpos, bpos = t["cbit"], t["bent"], t["cpos"], t["bpos"]
        assert (t["pad"] == 0).all()
        # The Rows tile the tables: every position of each once.
        assert sorted(np.concatenate(cpos).tolist()) == list(range(e))
        assert sorted(np.concatenate(bpos).tolist()) == list(range(e))
        assert max_deg == max(len(q) for q in cpos)
        # Each check's Row lists its bits in the layout's slot order.
        for g in layout.check_groups:
            for j in range(g.count):
                np.testing.assert_array_equal(cbit[cpos[g.node_start + j]],
                                              g.neighbor[j])
        # Each (check, slot) word addresses one check edge, every edge once,
        # and that edge's bit is the bit whose word it is.
        seen = np.zeros(e, dtype=np.int64)
        for i in range(n):
            c, slot = bent[bpos[i]] & 0xffff, bent[bpos[i]] >> 16
            pos = np.array([cpos[ci][si] for ci, si in zip(c, slot)],
                           dtype=np.int64)
            seen[pos] += 1
            assert (cbit[pos] == i).all()
            # Slot order: the bit's checks in ascending external index, as
            # the matrix lists them.
            np.testing.assert_array_equal(t["chk_ext"][c],
                                          matrix.bit_nodes[t["bit_ext"][i]])
        assert (seen == 1).all()
        if not slot_major:  # node-major: a node's edges are neighbours
            assert all((np.diff(q) == 1).all() for q in cpos + bpos)
    # ext_bit is bit_ext's inverse: every bit once.
    np.testing.assert_array_equal(t["ext_bit"][t["bit_ext"]], np.arange(n))
    np.testing.assert_array_equal(np.sort(t["chk_ext"]), np.arange(m))
    # Every committed generic asset keeps its checks in shared memory, two
    # blocks of 512 threads to an SM, in every mode of min-sum.
    for mode in launch.MODES:
        plan = fg.launch_plan(matrix, launch.generic_flags(TAlg.NMSA), mode)
        assert plan.checks == "shared" and plan.slice_floats == 0
        assert plan.threads == 512


def test_launch_plan_layout_by_hand():
    """The 10k alist code (N=10240, M=2841, check degrees 14-15: one word
    of edge bits): totals 40960 bytes, checks 12 bytes each (34092), the
    syndrome 89 words (356), key bits 1280 bytes each; the mc mode's
    selection state (3092 bytes, rounded to 3104) and Alice's external bits
    (1280) fit in the checks' space."""
    matrix = read_sparse_matrix_alist(ALIST10K)
    assert fg.code_shape(layout_for(matrix)) == (10240, 2841, 40960, 15)
    nmsa = launch.generic_flags(TAlg.NMSA)
    base = 40960 + 34096 + 356  # the checks end on a 16-byte boundary
    assert fg.launch_plan(matrix, nmsa, "decode").shared_bytes == base
    assert fg.launch_plan(matrix, nmsa, "frame").shared_bytes == base + 1280
    assert fg.launch_plan(matrix, nmsa, "trial").shared_bytes == base + 2560
    mc = fg.launch_plan(matrix, nmsa, "mc")
    assert mc == fg.LaunchPlan(512, base + 2560, "shared", 0)
    # Two frames share an SM's 228 KB (1 KB reserved per block).
    assert 2 * (mc.shared_bytes + 1024) <= 233472
    # The SPA pair: one f32 per slot of the largest degree (15 x 2841), one
    # block of 1024 threads per SM.
    spa = fg.launch_plan(matrix, launch.generic_flags(TAlg.SPA_APPROX), "mc")
    assert spa == fg.LaunchPlan(1024, 40960 + 4 * 15 * 2841 + 4 + 356 + 2560,
                                "shared", 0)
    # Forced into the global slice: the checks' floats rounded up to 16
    # bytes per block (3 x 2841 = 8523 -> 8524), and the mc mode's staging
    # space alone in shared memory.
    forced = fg.launch_plan(matrix, nmsa, "mc", "global")
    assert forced == fg.LaunchPlan(512, 40960 + 3104 + 1280 + 356 + 2560,
                                   "global", 8524)
    assert fg.launch_plan(matrix, nmsa, "decode", "global").shared_bytes \
        == 40960 + 356
    with pytest.raises(ValueError, match="checks"):
        fg.launch_plan(matrix, nmsa, "mc", "nowhere")
    assert launch.generic_flags(TAlg.AOMSA) == 3
    assert launch.generic_flags(TAlg.SPA_APPROX) == 8


def _degree2_code(n):
    """A regular code of bit degree 2 and check degree 4 (M = N / 2), as the
    gate's edge code."""
    return generate_regular_ldpc(n, n // 2, 2, seed=1)


def test_fit_edges():
    """Min-sum mc bytes of the degree-2 family: 4N totals, 12 bytes a check
    (M = N/2) and 3 N/32 words of bits. Two blocks share an SM up to
    N = 11136; one frame's checks stay in shared memory up to N = 22528;
    beyond, the checks go to the global slice (the gate's edge, N = 32768,
    among them) with one block of 1024 threads per SM."""
    flags = launch.generic_flags(TAlg.NMSA)
    plans = {n: fg.launch_plan(_degree2_code(n), flags, "mc")
             for n in (11136, 11264, 22528, 22656, 32768)}
    assert plans[11136].threads == 512 and plans[11264].threads == 1024
    assert 2 * (plans[11136].shared_bytes + 1024) <= 233472 \
        < 2 * (plans[11264].shared_bytes + 1024)
    assert plans[22528].checks == "shared"
    assert plans[22528].shared_bytes <= launch.MAX_SHARED_BYTES
    assert plans[22656].checks == "global"
    assert fg.shared_bytes(22656, 11328, 4, False, False, "mc") \
        > launch.MAX_SHARED_BYTES
    gate = plans[32768]
    assert gate == fg.LaunchPlan(1024, 4 * 32768 + 3104 + 4096 + 2048
                                 + 2 * 4096, "global", 3 * 16384)
    assert fg.generic_feasible(_degree2_code(32768))
