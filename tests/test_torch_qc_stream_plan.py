"""The premises of the streamed QC kernel's cluster design
(qkd_ldpc_v_tpu_torch/csrc/qc_stream.cu), checked on the CPU.

  * The compressed min-sum check (``ops/qc_stream.py``: ``compress_row``
    then ``rebuild_row``, the plain mirror of what the kernel stores and
    rebuilds) gives every check->bit value of ``_RowUpdate.__call__`` bit
    for bit (a NaN's sign aside, which nothing reads), on adversarial rows: ties at the minimum, +-0, +-inf, NaN and
    +-FLT_MAX, rows of degree 1 and 2 (min2 stays at FLT_MAX), OMSA offsets
    above |m|, both adaptive factors, the clamp on and off.
  * The launch plan (``plan_for``): every QC asset gets a cluster of at
    most 16 CTAs within 232,448 shared bytes each, every N=102400 asset a
    cluster of 2 CTAs; every shape JAX's ``qc_stream_feasible`` admits at
    its edge (the most base columns its budget allows) fits too, and the
    kernel's limits raise ``NotImplementedError`` beyond 16 CTAs.
  * The kernel's table (``stream_table``): the block-edge table, then each
    column's edges in base-row order (row, edge and slot in the row) and the
    column pointers as 16-bit halves.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from qkd_ldpc_v_tpu_torch import engines
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.convert import qc_from_arrays
from qkd_ldpc_v_tpu_torch.models.qc import read_qc_matrix
from qkd_ldpc_v_tpu_torch.ops import launch, qc_stream
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import _RowUpdate, base_tables

REPO = Path(__file__).resolve().parent.parent
QC_ASSETS = sorted((REPO / "sparse_matrices" / "matrices_qc").glob("*.mtrx"))
FMAX = float(np.finfo(np.float32).max)
SPECIAL = [0.0, -0.0, 1.5, -1.5, 0.25, -0.25, float("inf"), float("-inf"),
           float("nan"), FMAX, -FMAX, 1e-45, -1e-45]
MODES = ("decode", "trial", "mc")

# An f32 message: mostly the special values above (so that ties and the
# two minima's edge cases come up), else any float32.
_message = st.one_of(
    st.sampled_from(SPECIAL),
    st.floats(width=32, allow_nan=True, allow_infinity=True))


@st.composite
def _rows(draw):
    """(messages [deg][checks], syndrome bits, secondary mask): a block-row
    of 1-20 edges over 6 checks."""
    deg = draw(st.integers(1, 20))
    checks = 6
    vals = draw(st.lists(_message, min_size=deg * checks,
                         max_size=deg * checks))
    msgs = torch.tensor(vals, dtype=torch.float32).reshape(deg, checks)
    syn = torch.tensor(draw(st.lists(st.integers(0, 1), min_size=checks,
                                     max_size=checks)), dtype=torch.int8)
    second = torch.tensor(draw(st.lists(st.booleans(), min_size=checks,
                                        max_size=checks)))
    return list(msgs.unbind(0)), syn, second


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit patterns, or NaN in both: the sign of a NaN message
    reaches no decision (t <= 0, m > 0, m < 0, |m| and min.NaN / max.NaN
    all ignore it), and -p of a NaN p is the rebuild's only difference."""
    same = got.view(torch.int32) == want.view(torch.int32)
    return bool((same | (got.isnan() & want.isnan())).all())


@pytest.mark.parametrize("use_threshold,threshold", [(False, 0.0),
                                                     (True, 0.75),
                                                     (True, -0.5)])
@pytest.mark.parametrize("alg,primary,secondary", [
    ("NMSA", 0.8, 1.0), ("OMSA", 0.3, 1.0), ("OMSA", 2.0, 1.0),
    ("ANMSA", 0.88, 0.5), ("AOMSA", 0.3, 0.6), ("AOMSA", 0.5, 3.0)])
def test_compressed_check_rebuilds_every_value(alg, primary, secondary,
                                               use_threshold, threshold):
    upd = _RowUpdate(TAlg[alg], use_threshold, primary, secondary, threshold,
                     torch.device("cpu"))

    @settings(max_examples=150, deadline=None, derandomize=True)
    @given(_rows())
    def check(row):
        msgs, syn, second = row
        f = upd.factor(second.to(torch.int8)) if upd.adaptive \
            else upd.primary
        want = upd(msgs, syn, f)
        got = qc_stream.rebuild_row(
            upd, *qc_stream.compress_row(upd, msgs, syn,
                                         second & upd.adaptive))
        for g, w in zip(got, want):
            assert _same_bits(g, w)

    check()


def test_compressed_check_degree_one_and_two_keep_fmax():
    """In a row of one edge min2 stays at the float32 maximum, which p2
    carries (its edge never takes it); ties at the minimum in a row of two
    mark both edges |m| == min1, and p2 = p1."""
    upd = _RowUpdate(TAlg.NMSA, False, 0.8, 1.0, 0.0, torch.device("cpu"))
    one = [torch.tensor([2.0, -0.0, 1.0])]
    p1, p2, bits = qc_stream.compress_row(
        upd, one, torch.zeros(3, dtype=torch.int8), torch.zeros(3, dtype=bool))
    assert torch.equal(p2, torch.full((3,), 0.8 * FMAX, dtype=torch.float32))
    assert bits[0].tolist() == [3, 2, 3]
    two = [torch.tensor([1.5, -1.5]), torch.tensor([-1.5, 1.5])]
    p1, p2, bits = qc_stream.compress_row(
        upd, two, torch.tensor([0, 1], dtype=torch.int8),
        torch.zeros(2, dtype=bool))
    assert torch.equal(p1, p2)
    assert [b.tolist() for b in bits] == [[3, 2], [2, 3]]
    assert p1.tolist() == pytest.approx([-1.2, 1.2])


@pytest.mark.parametrize("path", QC_ASSETS, ids=[p.stem for p in QC_ASSETS])
def test_plan_fits_every_qc_asset(path):
    code = read_qc_matrix(path)
    for mode in MODES:
        for spa in (False, True):
            plan = qc_stream.plan_for(code, mode, spa)
            assert plan.cluster in qc_stream.CLUSTER_SIZES
            assert plan.shared_bytes <= launch.MAX_SHARED_BYTES
            assert plan.threads <= 1024 and plan.threads % 32 == 0
            if code.num_bit_nodes == 102400:
                assert plan.cluster == 2
            elif code.num_bit_nodes <= 10240:
                assert plan.cluster == 1
            # The smallest cluster that fits: half of it does not.
            if plan.cluster > 1:
                assert qc_stream.plan_for_shape(
                    *launch.shape_of(code), mode, spa,
                    plan.cluster // 2) is None


def _edge_code(z, mb, max_deg):
    """The code of lifting z with mb base rows whose first row holds
    max_deg edges (every other row one), with the most base columns that
    JAX's qc_stream_feasible admits."""
    nb = (engines._QC_STREAM_BUDGET // (engines._TILE * z * 4)
          - mb - 2 * max_deg - 6) // 3
    shifts = -np.ones((mb, nb), dtype=np.int64)
    shifts[0, :max_deg] = np.arange(max_deg) % z
    for r in range(1, mb):
        shifts[r, (r * 7) % nb] = r % z
    return qc_from_arrays(shifts, z), nb


@pytest.mark.parametrize("z,mb,max_deg", [
    (128, 1, 1), (128, 64, 8), (128, 2, 200), (256, 8, 16), (1024, 64, 6),
    (2048, 15, 11), (8192, 4, 30), (32768, 2, 8), (32768, 8, 4)])
def test_plan_admits_jax_gate_edge(z, mb, max_deg):
    """At the largest N the JAX gate admits for this lifting, rows and
    degree (up to N = 786k at Z = 128), the plan finds a cluster of at most
    16 CTAs, and one more base column leaves the JAX gate."""
    code, nb = _edge_code(z, mb, max_deg)
    assert engines.qc_stream_feasible(code)
    wider = qc_from_arrays(
        np.concatenate([code.shifts, -np.ones((mb, 1), dtype=np.int64)],
                       axis=1), z)
    assert not engines.qc_stream_feasible(wider)
    for mode in MODES:
        plan = qc_stream.plan_for(code, mode)
        assert plan.cluster <= 16
        assert plan.shared_bytes <= launch.MAX_SHARED_BYTES


def test_plan_limit_raises_beyond_sixteen_ctas():
    code = qc_from_arrays(np.zeros((1, 64), dtype=np.int64), 32768)
    with pytest.raises(NotImplementedError, match="16 CTAs"):
        qc_stream._check_limits(code)
    with pytest.raises(NotImplementedError, match="16 CTAs"):
        qc_stream.plan_for(code, "decode")


def test_stream_table_layout():
    code = qc_from_arrays(np.array([[0, -1, 3, 1, -1],
                                    [2, 1, -1, -1, 0],
                                    [-1, 2, 1, 0, 3]]), 4)
    rows, cols, num_be = base_tables(code)
    mb, nb = code.base_checks, code.base_bits
    table = qc_stream.stream_table(code)
    assert len(table) == mb + 1 + 3 * num_be + (nb + 2) // 2
    edges = table[mb + 1 + 2 * num_be:mb + 1 + 3 * num_be]
    halves = table[mb + 1 + 3 * num_be:]
    col_ptr = [h >> s & 0xffff for h in halves for s in (0, 16)][:nb + 1]
    assert col_ptr == list(np.cumsum([0] + [len(c) for c in cols]))
    for c, col in enumerate(cols):
        got = edges[col_ptr[c]:col_ptr[c + 1]]
        assert got == [r | (e << 10) | ((e - table[r]) << 20)
                       for (e, r, _) in col]
