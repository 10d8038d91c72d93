"""The premises of the fused QC kernel's layout
(qkd_ldpc_v_tpu_torch/csrc/fused_qc.cu), checked on the CPU.

  * The launch plan (``ops/fused_qc.py::launch_plan``, the mirror of the
    kernel's shared layout): every committed QC asset that the fused kernel
    holds gets one frame per block of Z threads rounded up to a warp, within
    232,448 shared bytes in every mode, and the SPA pair's messages in
    shared memory; at the fit edge one more base column leaves the kernel.
  * Routing: ``simulation.qc_kernel`` sends every committed QC asset to the
    kernel that the fit rule of the kernel's earlier layout chose (one
    frame's totals, flooding also its channel LLRs, beside the mc selection
    state, with the messages outside shared memory).
  * The compressed min-sum check in the kernel's word layout (slot k in
    word k // 16 at bit 2k mod 32) rebuilds every check->bit value of
    ``_RowUpdate.__call__`` bit for bit, for rows of up to 64 edges.
  * The kernel's table (``fused_table``): the block-edge table, then each
    column's edges in base-row order (edge, row and slot) and col_ptr.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.convert import qc_from_arrays
from qkd_ldpc_v_tpu_torch.models.qc import read_qc_matrix
from qkd_ldpc_v_tpu_torch.ops import fused_qc, launch, philox, qc_stream
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import _RowUpdate, base_tables

REPO = Path(__file__).resolve().parent.parent
QC_ASSETS = sorted((REPO / "sparse_matrices" / "matrices_qc").glob("*.mtrx"))
FMAX = float(np.finfo(np.float32).max)
SPECIAL = [0.0, -0.0, 1.5, -1.5, 0.25, -0.25, float("inf"), float("-inf"),
           float("nan"), FMAX, -FMAX, 1e-45, -1e-45]
FLAGS = {
    "NMSA flooding": launch.kernel_flags(TAlg.NMSA, False),
    "AOMSA layered": launch.kernel_flags(TAlg.AOMSA, True),
    "SPA": launch.kernel_flags(TAlg.SPA, False),
    "SPA-lin": launch.kernel_flags(TAlg.SPA_APPROX, False),
}


def _earlier_fits(qc, layered):
    """The fit rule of the kernel's earlier layout: its limits, and the
    table, one frame's totals (flooding also its channel LLRs) and the
    selection state within a block's shared memory."""
    if launch.limit_reason(qc, 1024, 256, 64) is not None:
        return False
    shared = 4 * (qc.base_checks + 1 + 2 * len(qc.block_edges)) + \
        (1 if layered else 2) * 4 * qc.num_bit_nodes + 4 * (256 + 512 + 5)
    return shared <= 232448


@pytest.mark.parametrize("path", QC_ASSETS, ids=[p.stem for p in QC_ASSETS])
def test_launch_plan_on_every_qc_asset(path, monkeypatch):
    def no_build():
        raise AssertionError("the plan must not build the kernels")

    monkeypatch.setattr(kernels, "library", no_build)
    code = read_qc_matrix(path)
    fits = fused_qc.fused_qc_fits(code, True)
    assert fits == fused_qc.fused_qc_fits(code, False)
    assert fits == (code.num_bit_nodes <= 10240)
    if not fits:
        with pytest.raises(NotImplementedError, match="streamed QC"):
            fused_qc._Launch(code, FLAGS["NMSA flooding"], torch.device("cpu"))
        return
    z = code.lifting
    for name, flags in FLAGS.items():
        for mode in launch.MODES:
            plan = fused_qc.launch_plan(code, flags, mode)
            assert plan.threads == (z + 31) // 32 * 32
            assert plan.threads % 32 == 0 and plan.threads >= z
            assert plan.frames_per_block == 1
            assert plan.shared_bytes <= launch.MAX_SHARED_BYTES
            assert plan.messages == "shared" and plan.slice_floats == 0
            # One frame's totals and key bits are always there.
            n = code.num_bit_nodes
            assert plan.shared_bytes >= 4 * n + (0 if mode == "decode"
                                                 else n // 8)
    # The mc mode holds the selection state in the messages' space, so it
    # takes no more than the trial mode where the messages outgrow it.
    nmsa = FLAGS["NMSA flooding"]
    mc = fused_qc.launch_plan(code, nmsa, "mc").shared_bytes
    trial = fused_qc.launch_plan(code, nmsa, "trial").shared_bytes
    assert mc == trial or 12 * code.num_check_nodes < philox.SELECTION_BYTES


def test_launch_plan_layout_by_hand():
    """The headline code (Z=512, 6 x 20 base matrix, 80 block edges, rows of
    at most 14): table 24 * 80 + 8 * 16 * 6 + 4 * 7 + 4 * 21 = 2800 bytes,
    totals 40960, messages 12 bytes a check (3072 checks), key bits 1280
    bytes each."""
    path = REPO / "sparse_matrices" / "matrices_qc" / \
        "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx"
    code = read_qc_matrix(path)
    assert launch.shape_of(code) == (6, 20, 512, 80, 14)
    base = 2800 + 40960 + 12 * 3072
    nmsa = FLAGS["NMSA flooding"]
    assert fused_qc.launch_plan(code, nmsa, "decode").shared_bytes == base
    assert fused_qc.launch_plan(code, nmsa, "frame").shared_bytes \
        == base + 1280
    assert fused_qc.launch_plan(code, nmsa, "trial").shared_bytes \
        == base + 2560
    assert fused_qc.launch_plan(code, nmsa, "mc").shared_bytes == base + 2560
    spa = fused_qc.launch_plan(code, FLAGS["SPA"], "mc")
    assert spa.shared_bytes == 2800 + 40960 + 4 * 80 * 512 + 2560
    forced = fused_qc.launch_plan(code, FLAGS["SPA"], "mc", "global")
    assert forced.messages == "global"
    assert forced.slice_floats == 80 * 512
    # The selection state's 3092 bytes rounded up to 16.
    assert forced.shared_bytes == 2800 + 40960 + 3104 + 2560
    with pytest.raises(ValueError, match="messages"):
        fused_qc.launch_plan(code, nmsa, "mc", "global")


def _edge_code(nb, z=512, mb=6):
    """A code of mb base rows and nb base columns, each column on two rows
    (rows of at most ceil(2 nb / mb) edges)."""
    shifts = -np.ones((mb, nb), dtype=np.int64)
    for c in range(nb):
        shifts[c % mb, c] = c % z
        shifts[(c + 1) % mb, c] = (3 * c + 1) % z
    return qc_from_arrays(shifts, z)


def test_fit_edge():
    """The largest code of this shape family the kernel holds: its mc
    layout within 232,448 bytes, and one more base column beyond them
    (then the streamed kernel takes it)."""
    nb = 20
    while fused_qc.fused_qc_fits(_edge_code(nb + 1), True):
        nb += 1
    code, wider = _edge_code(nb), _edge_code(nb + 1)
    flags = FLAGS["NMSA flooding"]
    assert fused_qc.launch_plan(code, flags, "mc").shared_bytes \
        <= launch.MAX_SHARED_BYTES
    assert fused_qc.launch_plan(wider, flags, "mc").shared_bytes \
        > launch.MAX_SHARED_BYTES
    assert not fused_qc.fused_qc_fits(wider, False)
    assert fused_qc._unfit_reason(wider, True).endswith("exceed 232448")
    engine = "qc"
    assert tsim.qc_kernel(code, engine, True) == "fused_qc"
    assert tsim.qc_kernel(wider, engine, True) == "qc_stream"
    # At the edge the SPA pair's messages no longer fit in shared memory and
    # go to a global slice, while min-sum's compressed ones do.
    spa = fused_qc.launch_plan(code, FLAGS["SPA"], "mc")
    assert spa.messages == "global"
    assert spa.slice_floats == len(code.block_edges) * code.lifting
    # Here (mb = 6, Z = 512: R = 0.93, N = 41472 at nb = 81) the edge lies
    # between the earlier layout's: flooding (totals and LLRs) held N <=
    # about 28.6k, layered (totals) about 57k.
    assert nb == 81
    assert not _earlier_fits(code, False) and _earlier_fits(code, True)


@pytest.mark.parametrize("path", QC_ASSETS, ids=[p.stem for p in QC_ASSETS])
def test_qc_kernel_routes_every_asset_as_before(path):
    code = read_qc_matrix(path)
    for layered in (False, True):
        want = "fused_qc" if _earlier_fits(code, layered) else "qc_stream"
        assert tsim.qc_kernel(code, "qc", layered) == want


# ---------------------------------------------------------------------------
# The compressed check in the kernel's word layout, rows of up to 64 edges.
# ---------------------------------------------------------------------------

_message = st.one_of(
    st.sampled_from(SPECIAL),
    st.floats(width=32, allow_nan=True, allow_infinity=True))


@st.composite
def _rows(draw):
    """(messages [deg][checks], syndrome bits, secondary mask): a block-row
    of 1-64 edges over 3 checks."""
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


def _pack_words(bits):
    """The kernel's word planes: slot k's two bits in word k // 16 at bit
    2k mod 32 (csrc/fused_qc.cu::minsum_check)."""
    words = [torch.zeros_like(bits[0], dtype=torch.int64)
             for _ in range((2 * len(bits) + 31) // 32)]
    for k, b in enumerate(bits):
        words[k // 16] |= b.to(torch.int64) << (2 * k % 32)
    return words


def _unpack_values(p1, p2, words, deg, neg_same):
    """The kernel's stored_value for every slot, from the word planes."""
    vals = []
    for k in range(deg):
        b = (words[k // 16] >> (2 * k % 32)) & 3
        v = torch.where(b & 2 != 0, p2, p1)
        vals.append(v if neg_same else torch.where(b & 1 != 0, v, -v))
    return vals


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit patterns, or NaN in both (a NaN message's sign reaches no
    decision)."""
    same = got.view(torch.int32) == want.view(torch.int32)
    return bool((same | (got.isnan() & want.isnan())).all())


@pytest.mark.parametrize("use_threshold,threshold", [(False, 0.0),
                                                     (True, 0.75),
                                                     (True, -0.5)])
@pytest.mark.parametrize("alg,primary,secondary", [
    ("NMSA", 0.8, 1.0), ("OMSA", 0.3, 1.0), ("ANMSA", 0.88, 0.5),
    ("AOMSA", 0.5, 3.0)])
def test_compressed_words_rebuild_every_value(alg, primary, secondary,
                                              use_threshold, threshold):
    upd = _RowUpdate(TAlg[alg], use_threshold, primary, secondary, threshold,
                     torch.device("cpu"))
    neg_same = use_threshold and threshold < 0.0

    @settings(max_examples=80, deadline=None, derandomize=True)
    @given(_rows())
    def check(row):
        msgs, syn, second = row
        f = upd.factor(second.to(torch.int8)) if upd.adaptive \
            else upd.primary
        want = upd(msgs, syn, f)
        p1, p2, bits = qc_stream.compress_row(upd, msgs, syn,
                                              second & upd.adaptive)
        got = _unpack_values(p1, p2, _pack_words(bits), len(msgs), neg_same)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert _same_bits(g, w)

    check()


def test_fused_table_layout():
    code = qc_from_arrays(np.array([[0, -1, 3, 1, -1],
                                    [2, 1, -1, -1, 0],
                                    [-1, 2, 1, 0, 3]]), 4)
    rows, cols, num_be = base_tables(code)
    mb, nb = code.base_checks, code.base_bits
    table = fused_qc.fused_table(code)
    assert table[:mb + 1 + 2 * num_be] == launch.block_edge_table(code)
    assert len(table) == mb + 1 + 3 * num_be + nb + 1
    entries = table[mb + 1 + 2 * num_be:mb + 1 + 3 * num_be]
    col_ptr = table[mb + 1 + 3 * num_be:]
    assert col_ptr == list(np.cumsum([0] + [len(c) for c in cols]))
    for c, col in enumerate(cols):
        got = entries[col_ptr[c]:col_ptr[c + 1]]
        assert got == [e | (r << 8) | ((e - table[r]) << 16)
                       for (e, r, _) in col]
