"""Fused generic wrappers (qkd_ldpc_v_tpu_torch/ops/fused_generic.py).

On the CPU the wrappers run their plain torch versions. Those must equal
the JAX float32 XLA decoder plus ``calculate_syndrome`` and the key
comparison exactly (conv, keys, iterations and, in decode mode, decisions)
for the min-sum family with and without the clamp, and hold to the JAX
fused Pallas decoder (interpret mode, f32 transport) at the tolerance of
tests/test_pallas_generic.py::test_matches_xla_decoder. The launch counter
stays 0 on the CPU, and the engine gate equals the JAX package's.

Tests marked ``cuda`` compare the CUDA kernel with its plain version on the
card and skip without one: the trial and decode modes, the frame mode on
rate-adapted frames (ragged batches, and the all-shortened neighbourhood of
one bit, where sums overflow to inf and NaN), and the mc mode against
``channel.mc_channel`` and the plain trial; each for the min-sum family
and the SPA pair (forced LLRs in decode mode). They import no JAX, so on a
machine without JAX they run with the conftest left out:

    python -m pytest tests/test_torch_fused_generic.py -m cuda --noconftest -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.convert import hmatrix_from_rows
from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc
from qkd_ldpc_v_tpu_torch.models.hmatrix import from_dense, read_sparse_matrix_alist
from qkd_ldpc_v_tpu_torch.ops import fused_generic, generic_stream, launch
from qkd_ldpc_v_tpu_torch.ops.channel import (
    calculate_syndrome,
    inject_errors,
    log_ratio,
)
from qkd_ldpc_v_tpu_torch.models.layout import layout_for
from qkd_ldpc_v_tpu_torch.rate_adapt import adapt_code_rate
from test_torch_fused_qc import all_shortened_plan, rate_adapted_frames

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ALIST = REPO / "sparse_matrices" / "matrices_alist"
CAP = 30
THRESHOLD = 4.0
FACTORS = {"NMSA": (0.8, 1.0), "OMSA": (0.3, 1.0), "ANMSA": (0.88, 0.5),
           "AOMSA": (0.3, 0.6)}
# The card tests also run the SPA pair, which takes no factors.
CARD_FACTORS = dict(FACTORS, SPA=(1.0, 1.0), SPA_APPROX=(1.0, 1.0))


def irregular_dense():
    """tests/test_pallas_generic.py::irregular_matrix: column weights 2..5,
    mixed row weights."""
    rng = np.random.default_rng(11)
    n, m = 288, 144
    dense = np.zeros((m, n), dtype=np.int8)
    for col in range(n):
        rows = rng.choice(m, size=2 + (col % 4), replace=False)
        dense[rows, col] = 1
    for row in range(m):
        if dense[row].sum() == 0:
            dense[row, rng.integers(0, n)] = 1
    return dense


def _keys(n, batch, num_errors, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    alice = torch.tensor(rng.integers(0, 2, (batch, n)), dtype=torch.int8,
                         device=device)
    bits = torch.tensor(rng.integers(0, 2**32, (batch, n)), dtype=torch.int64,
                        device=device)
    return alice, inject_errors(bits, alice, num_errors, wide=True)


@pytest.fixture(scope="module")
def medium():
    """The conftest's medium code (N=512, column weight 3) and 16 frames
    with 40 errors (QBER 0.078), in its waterfall: some frames fail within
    the cap."""
    matrix = generate_regular_ldpc(num_bits=512, num_checks=256,
                                   column_weight=3, seed=3)
    alice, bob = _keys(512, 16, 40, seed=3)
    return matrix, alice, bob, log_ratio(40 / 512)


def _jax_reference(matrix, alg, use_thr, alice, bob, lp, f1, f2, thr):
    """JAX float32 XLA decoder + calculate_syndrome + key compare."""
    import jax.numpy as jnp
    from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
    from qkd_ldpc_v_tpu.models.layout import compile_layout
    from qkd_ldpc_v_tpu.ops.channel import calculate_syndrome as jsyn
    from qkd_ldpc_v_tpu.ops.decoders import get_decoder
    from qkd_ldpc_v_tpu.models.hmatrix import HMatrix as JHMatrix

    jm = JHMatrix([np.asarray(c) for c in matrix.bit_nodes],
                  [np.asarray(r) for r in matrix.check_nodes],
                  matrix.is_regular)
    layout = compile_layout(jm)
    a = jnp.asarray(alice.numpy())
    llr = jnp.where(jnp.asarray(bob.numpy()) == 1, -np.float32(lp),
                    np.float32(lp)).astype(jnp.float32)
    syn = jsyn(layout, a)
    res = get_decoder(layout, JAlg[alg], CAP, use_thr, dtype=jnp.float32)(
        llr, syn, f1, f2, thr)
    keys = np.all(np.asarray(res.decision) == alice.numpy(), axis=1)
    return (np.asarray(res.syndromes_match), keys, np.asarray(res.iterations),
            np.asarray(res.decision), np.asarray(llr), np.asarray(syn))


@pytest.mark.parametrize("alg", list(FACTORS))
@pytest.mark.parametrize("use_thr", [False, True])
def test_plain_trial_and_decode_equal_jax_xla(medium, alg, use_thr):
    matrix, alice, bob, lp = medium
    f1, f2 = FACTORS[alg]
    thr = THRESHOLD if use_thr else 0.0
    jconv, jkeys, jiters, jdec, jllr, jsyn = _jax_reference(
        matrix, alg, use_thr, alice, bob, lp, f1, f2, thr)
    assert 0 < jconv.sum() < len(jconv)
    fused_generic.reset_counts()
    trial = fused_generic.make_fused_generic_trial(matrix, TAlg[alg], CAP,
                                                   use_thr)
    conv, keys, iters = trial(alice, bob, lp, f1, f2, thr)
    np.testing.assert_array_equal(conv.numpy(), jconv)
    np.testing.assert_array_equal(keys.numpy(), jkeys)
    np.testing.assert_array_equal(iters.numpy(), jiters)
    decode = fused_generic.make_fused_generic_decoder(matrix, TAlg[alg], CAP,
                                                      use_thr)
    res = decode(torch.tensor(jllr), torch.tensor(jsyn), f1, f2, thr)
    np.testing.assert_array_equal(res.decision.numpy(), jdec)
    np.testing.assert_array_equal(res.syndromes_match.numpy(), jconv)
    np.testing.assert_array_equal(res.iterations.numpy(), jiters)
    assert fused_generic.counts() == (0, 0)


@pytest.mark.parametrize("alg", list(FACTORS))
def test_plain_decode_holds_to_pallas_generic(medium, alg):
    """The JAX fused Pallas decoder (interpret mode, f32 transport) and the
    plain decode: equal convergence; non-adaptive iterations and converged
    decisions equal; adaptive iterations within 4 (the TPU kernel's
    decision-in-LSB perturbation), decisions equal where both converge at
    the same iteration. QBER 0.03, as in that test."""
    import jax
    from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
    from qkd_ldpc_v_tpu.models.hmatrix import HMatrix as JHMatrix
    from qkd_ldpc_v_tpu.ops.pallas_generic import make_pallas_generic_decoder

    matrix = medium[0]
    alice, bob = _keys(512, 8, 15, seed=5)
    lp = log_ratio(15 / 512)
    f1, f2 = FACTORS[alg]
    layout = layout_for(matrix)
    lpt = torch.tensor(lp)
    llr = torch.where(bob == 1, -lpt, lpt)
    syn = calculate_syndrome(layout, alice)
    jm = JHMatrix([np.asarray(c) for c in matrix.bit_nodes],
                  [np.asarray(r) for r in matrix.check_nodes],
                  matrix.is_regular)
    fused = make_pallas_generic_decoder(jm, JAlg[alg], CAP, True,
                                        batch_tile=4, interpret=True,
                                        transport="f32")
    rk = jax.device_get(fused(llr.numpy(), syn.numpy(), f1, f2, 60.0))
    res = fused_generic.make_fused_generic_decoder(matrix, TAlg[alg], CAP,
                                                   True)(llr, syn, f1, f2, 60.0)
    conv = res.syndromes_match.numpy()
    np.testing.assert_array_equal(conv, np.asarray(rk.syndromes_match))
    iters = res.iterations.numpy()
    if not TAlg[alg].is_adaptive:
        np.testing.assert_array_equal(iters, rk.iterations)
        np.testing.assert_array_equal(res.decision.numpy()[conv],
                                      np.asarray(rk.decision)[conv])
    else:
        assert np.abs(iters - rk.iterations).max() <= 4
        same = conv & (iters == rk.iterations)
        np.testing.assert_array_equal(res.decision.numpy()[same],
                                      np.asarray(rk.decision)[same])


def test_odd_batch_and_irregular_code():
    """Bit degrees 2..5 and an odd batch of 5 frames: the plain trial equals
    the plain decode plus the key compare, and every frame decodes at an
    easy point."""
    matrix = from_dense(irregular_dense())
    assert len(layout_for(matrix).bit_groups) == 4
    alice, bob = _keys(matrix.num_bit_nodes, 5, 5, seed=19)
    lp = log_ratio(5 / matrix.num_bit_nodes)
    trial = fused_generic.make_fused_generic_trial(matrix, TAlg.NMSA, 40, False)
    conv, keys, iters = trial(alice, bob, lp, 0.8, 1.0, 0.0)
    assert conv.shape == keys.shape == iters.shape == (5,)
    assert bool(conv.all()) and bool(keys.all())
    lpt = torch.tensor(lp)
    res = fused_generic.make_fused_generic_decoder(matrix, TAlg.NMSA, 40, False)(
        torch.where(bob == 1, -lpt, lpt),
        calculate_syndrome(layout_for(matrix), alice), 0.8, 1.0, 0.0)
    assert res.decision.shape == (5, matrix.num_bit_nodes)
    assert torch.equal(res.iterations, iters)
    assert torch.equal((res.decision == alice).all(dim=1), keys)


def _staircase(n):
    """Bit j on checks 0..j (degree j + 1), n bits and n checks: every
    degree class holds one node, so each pads to a full 128-lane block and
    the TPU layout's edge rows are sum(1..n)."""
    dense = np.zeros((n, n), dtype=np.int8)
    for j in range(n):
        dense[:j + 1, j] = 1
    return dense


def test_gate_equals_jax_generic_plan_feasible(monkeypatch):
    from qkd_ldpc_v_tpu.models.hmatrix import from_dense as jfrom_dense
    from qkd_ldpc_v_tpu.ops import pallas_generic
    from qkd_ldpc_v_tpu.ops.pallas_generic import generic_plan_feasible

    # The Clos regroup tables come after JAX's tile check and do not bear
    # on its verdict.
    monkeypatch.setattr(pallas_generic, "build_permute_plan", lambda g: None)
    # 15 classes: 120 edge rows, 1 tile; 33 classes: 561 rows, 5 tiles.
    denses = [irregular_dense(), _staircase(15), _staircase(33)]
    verdicts = [fused_generic.generic_feasible(from_dense(d)) for d in denses]
    assert verdicts == [generic_plan_feasible(jfrom_dense(d)) for d in denses]
    assert verdicts == [True, True, False]
    # 31 classes: 496 rows, the last code inside 4 tiles.
    assert fused_generic.generic_feasible(from_dense(_staircase(31)))
    # More than MAX_TILES * 128 * 128 edges: out before any row count.
    big = hmatrix_from_rows([np.arange(8 * k, 8 * k + 8) for k in range(8193)],
                            8 * 8193)
    assert big.num_edges > 65536
    assert not fused_generic.generic_feasible(big)


def test_wrappers_check_inputs(medium):
    matrix, alice, bob, lp = medium
    trial = fused_generic.make_fused_generic_trial(matrix, TAlg.NMSA, CAP, False)
    with pytest.raises(TypeError):
        trial(alice.to(torch.int32), bob, lp)
    with pytest.raises(ValueError):
        trial(alice[:, :100], bob[:, :100], lp)
    # The SPA pair builds for every mode and runs its plain version on the
    # CPU.
    spa = fused_generic.make_fused_generic_trial(matrix, TAlg.SPA, CAP, False)
    fused_generic.reset_counts()
    got = spa(alice, bob, lp, 1.0, 1.0, 0.0)
    want = spa.plain(alice, bob, lp, 1.0, 1.0, 0.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fused_generic.counts() == (0, 0)
    for make in (fused_generic.make_fused_generic_montecarlo,
                 fused_generic.make_fused_generic_frame_trial,
                 fused_generic.make_fused_generic_decoder):
        make(matrix, TAlg.SPA_APPROX, CAP, True)
    alice_meta = torch.empty(alice.shape, dtype=torch.int8, device="meta")
    fused_generic.reset_counts()
    with pytest.raises(NotImplementedError, match="meta"):
        trial(alice_meta, alice_meta, lp)
    assert fused_generic.counts() == (0, 0)


def test_launch_tables_address_every_edge_once(medium):
    """The kernel's tables: check-major and bit-major offsets tile the E
    edges, and the bit-major slots of each bit point at check-major edges
    whose bit is that bit, in ascending check order."""
    matrix = medium[0]
    layout = layout_for(matrix)
    n, m, e = layout.num_bits, layout.num_checks, layout.num_edges
    t = generic_stream.launch_tables(layout)
    assert t.shape == (2 * e + 2 * n + 2 * m + 2,)
    cptr, t = t[:m + 1], t[m + 1:]
    cbit, t = t[:e], t[e:]
    bptr, t = t[:n + 1], t[n + 1:]
    bedge, t = t[:e], t[e:]
    bit_ext, chk_ext = t[:n], t[n:]
    assert cptr[-1] == bptr[-1] == e
    assert sorted(bedge.tolist()) == list(range(e))
    check_of_edge = np.repeat(np.arange(m), np.diff(cptr))
    for i in range(n):
        edges = bedge[bptr[i]:bptr[i + 1]]
        assert (cbit[edges] == i).all()
        ext_checks = chk_ext[check_of_edge[edges]]
        np.testing.assert_array_equal(ext_checks,
                                      matrix.bit_nodes[bit_ext[i]])


# ---------------------------------------------------------------------------
# On the card: kernel == plain, exactly.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused generic kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("alg", list(CARD_FACTORS))
@pytest.mark.parametrize("use_thr", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, alg, use_thr):
    codes = [
        (from_dense(irregular_dense()), 0.06),
        (read_sparse_matrix_alist(ALIST / "(N=1024,M=82,R=0.92,CW=5,SEED=65).mtrx"),
         0.012),
        (read_sparse_matrix_alist(ALIST / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx"),
         0.032),
        # At the gate's edge (E = 65536): the messages live in global memory.
        (generate_regular_ldpc(32768, 16384, 2, seed=1), 0.01),
    ]
    f1, f2 = CARD_FACTORS[alg]
    thr = THRESHOLD if use_thr else 0.0
    for matrix, qber in codes:
        n = matrix.num_bit_nodes
        ne = int(n * qber)
        alice, bob = _keys(n, 63, ne, seed=7, device=cuda_device)
        lp = log_ratio(ne / n)
        trial = fused_generic.make_fused_generic_trial(matrix, TAlg[alg], CAP,
                                                       use_thr)
        got = trial(alice, bob, lp, f1, f2, thr)
        want = trial.plain(alice, bob, lp, f1, f2, thr)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
        lpt = torch.tensor(lp, device=cuda_device)
        llr = torch.where(bob == 1, -lpt, lpt)
        if alg.startswith("SPA"):
            # A zero LLR (the 0/0 ratio) and |LLR| >= 20 (tanh = +-1, the
            # guard clamps).
            llr[0, 0] = 0.0
            llr[1] *= 8.0
        syn = calculate_syndrome(layout_for(matrix), alice)
        dec = fused_generic.make_fused_generic_decoder(matrix, TAlg[alg], CAP,
                                                       use_thr)
        got = dec(llr, syn, f1, f2, thr)
        want = dec.plain(llr, syn, f1, f2, thr)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("alg", list(CARD_FACTORS))
@pytest.mark.parametrize("use_thr", [False, True])
def test_frame_kernel_matches_plain_on_card(cuda_device, alg, use_thr):
    """The frame mode on rate-adapted frames: the medium code (R=0.5 to
    about 0.48 at QBER 0.08) and the 1k alist code with check degree 63 (at
    QBER 0.005), ragged batches of 1, 7 and 13 frames, and the all-shortened
    neighbourhood of bit 0 (also at a primary factor of 1.25), with the
    clamp off and on."""
    codes = [
        (generate_regular_ldpc(num_bits=512, num_checks=256, column_weight=3,
                               seed=3), 0.08, 1.3),
        (read_sparse_matrix_alist(ALIST / "(N=1024,M=82,R=0.92,CW=5,SEED=65).mtrx"),
         0.005, 1.5),
    ]
    f1, f2 = CARD_FACTORS[alg]
    thr = THRESHOLD if use_thr else 0.0
    for matrix, qber, eff in codes:
        params = adapt_code_rate(np.random.default_rng(3), matrix, qber, 0.1,
                                 eff)
        assert len(params.punctured_bits) and len(params.shortened_bits)
        trial = fused_generic.make_fused_generic_frame_trial(
            matrix, TAlg[alg], CAP, use_thr)
        forced = all_shortened_plan(matrix, params)
        # The forced plan also at a primary factor of 1.25: its messages
        # overflow to inf and inf - inf gives NaN.
        for plan, batch, fac in ((params, 1, f1), (params, 7, f1),
                                 (params, 13, f1), (forced, 13, f1),
                                 (forced, 13, 1.25)):
            frame, llr = rate_adapted_frames(matrix, plan, batch, qber,
                                             seed=9, device=cuda_device)
            got = trial(frame, llr, fac, f2, thr)
            want = trial.plain(frame, llr, fac, f2, thr)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("alg", list(CARD_FACTORS))
@pytest.mark.parametrize("use_thr", [False, True])
def test_mc_kernel_matches_plain_on_card(cuda_device, alg, use_thr):
    """The mc mode (keys drawn in the kernel at each bit's external
    position) against ``mc_channel`` and the plain trial, each code in its
    waterfall, from frame 300 of the chunk; the code at the gate's edge
    keeps its messages in global memory."""
    from qkd_ldpc_v_tpu_torch.simulation import chunk_seed

    codes = [
        (from_dense(irregular_dense()), 0.06),
        (read_sparse_matrix_alist(ALIST / "(N=1024,M=82,R=0.92,CW=5,SEED=65).mtrx"),
         0.012),
        (read_sparse_matrix_alist(ALIST / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx"),
         0.032),
        (generate_regular_ldpc(32768, 16384, 2, seed=1), 0.01),
    ]
    f1, f2 = CARD_FACTORS[alg]
    thr = THRESHOLD if use_thr else 0.0
    seed = chunk_seed(11, 0, 4)
    for matrix, qber in codes:
        n = matrix.num_bit_nodes
        ne = int(n * qber)
        mc = fused_generic.make_fused_generic_montecarlo(matrix, TAlg[alg],
                                                         CAP, use_thr)
        args = (seed, 300, 63, ne, log_ratio(ne / n), f1, f2, thr)
        got = mc(*args, device=cuda_device)
        want = mc.plain(*args, device=cuda_device)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())


ALIST10K = ALIST / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx"
ALIST1K_DEG63 = ALIST / "(N=1024,M=82,R=0.92,CW=5,SEED=65).mtrx"


def _forced(matrix, alg, checks, threads=None):
    """The fused generic kernel's four wrappers of one algorithm, cap CAP,
    clamp off, with the launch plan forced to ``checks`` (and
    ``threads``)."""
    plan_for = launch.cached_plans(
        lambda m, flags, device: fused_generic._Launch(m, flags, device,
                                                       checks, threads))
    args = ("fused generic", fused_generic.COUNTS, plan_for, matrix,
            TAlg[alg], CAP, False)
    frame = launch.kernel_frame_trial(
        "fused generic", fused_generic.COUNTS, plan_for, matrix,
        launch.generic_flags(TAlg[alg]), matrix.num_bit_nodes, CAP, False,
        fused_generic.make_fused_generic_frame_trial(matrix, TAlg[alg], CAP,
                                                     False).plain)
    return (launch.generic_trial(*args),
            launch.generic_decoder(*args),
            launch.generic_montecarlo(*args), frame)


def _all_modes(matrix, alg, qber, wrappers, device, batch=37):
    """Each mode's outputs of ``wrappers`` (trial, decode, mc, frame) on
    seeded inputs, each held to its plain version exactly. Returns them."""
    from qkd_ldpc_v_tpu_torch.simulation import chunk_seed

    trial, decode, mc, frame = wrappers
    f1, f2 = CARD_FACTORS[alg]
    n = matrix.num_bit_nodes
    ne = int(n * qber)
    lp = log_ratio(ne / n)
    alice, bob = _keys(n, batch, ne, seed=5, device=device)
    lpt = torch.tensor(lp, device=device)
    llr = torch.where(bob == 1, -lpt, lpt)
    syn = calculate_syndrome(layout_for(matrix), alice)
    params = adapt_code_rate(np.random.default_rng(3), matrix, qber, 0.1, 1.5)
    fr, fllr = rate_adapted_frames(matrix, params, batch, qber, seed=9,
                                   device=device)
    mc_args = (chunk_seed(11, 0, 4), 300, batch, ne, lp, f1, f2, 0.0)
    calls = [(trial, (alice, bob, lp, f1, f2, 0.0), {}),
             (decode, (llr, syn, f1, f2, 0.0), {}),
             (mc, mc_args, {"device": device}),
             (frame, (fr, fllr, f1, f2, 0.0), {})]
    outs = []
    for fn, args, kwargs in calls:
        got = tuple(fn(*args, **kwargs))
        want = fn.plain(*args, **kwargs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
        outs.append(got)
    return outs


@pytest.mark.cuda
def test_plan_matches_library_on_card(cuda_device):
    """``launch_plan``'s bytes and slice floats equal the library's layout
    for every mode, check update and storage, on codes that take each
    storage; the 10k alist code runs 2 blocks per SM (min-sum) and 1
    (the SPA pair)."""
    lib = kernels.library()
    assert lib.fused_generic_max_threads() == 1024
    codes = [read_sparse_matrix_alist(ALIST10K),
             read_sparse_matrix_alist(ALIST1K_DEG63),
             from_dense(irregular_dense()),
             generate_regular_ldpc(32768, 16384, 2, seed=1)]
    for matrix in codes:
        n, m, _, max_deg = fused_generic.code_shape(layout_for(matrix))
        for alg in ("NMSA", "AOMSA", "SPA", "SPA_APPROX"):
            flags = launch.generic_flags(TAlg[alg])
            for checks in ("shared", "global"):
                slice_flag = fused_generic.SLICE if checks == "global" else 0
                for mode, code in launch.MODES.items():
                    try:
                        plan = fused_generic.launch_plan(matrix, flags, mode,
                                                         checks)
                    except NotImplementedError:
                        assert checks == "shared"
                        continue
                    assert plan.shared_bytes == lib.fused_generic_shared_bytes(
                        n, m, max_deg, flags | slice_flag, code)
                    if checks == "global":
                        assert plan.slice_floats == \
                            lib.fused_generic_slice_floats(m, max_deg, flags)
    matrix = codes[0]
    for alg, per_sm in (("NMSA", 2), ("SPA_APPROX", 1)):
        plan = fused_generic._Launch(matrix, launch.generic_flags(TAlg[alg]),
                                     cuda_device)
        assert all(v == per_sm for v in plan.per_sm.values())


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["NMSA", "AOMSA", "SPA", "SPA_APPROX"])
def test_global_slice_layout_on_card(cuda_device, alg):
    """The 10k alist code with its checks forced into the per-block global
    slice (a persistent grid): every mode equals the plain version and the
    shared layout's outputs."""
    matrix = read_sparse_matrix_alist(ALIST10K)
    shared = _all_modes(matrix, alg, 0.03, _forced(matrix, alg, "shared"),
                        cuda_device)
    forced = _all_modes(matrix, alg, 0.03, _forced(matrix, alg, "global"),
                        cuda_device)
    for s, g in zip(shared, forced):
        for a, b in zip(s, g):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("alg", list(CARD_FACTORS))
def test_mixed_converging_and_capped_frames_on_card(cuda_device, alg):
    """One batch of the 10k alist code that mixes an error-free frame (it
    converges at once), frames in the easy region and frames far in the
    waterfall that run to the cap, trial and decode modes."""
    matrix = read_sparse_matrix_alist(ALIST10K)
    n = matrix.num_bit_nodes
    parts = [_keys(n, 1, 0, seed=1, device=cuda_device),
             _keys(n, 20, int(n * 0.02), seed=2, device=cuda_device),
             _keys(n, 20, int(n * 0.07), seed=3, device=cuda_device)]
    alice = torch.cat([p[0] for p in parts])
    bob = torch.cat([p[1] for p in parts])
    lp = log_ratio(0.03)
    f1, f2 = CARD_FACTORS[alg]
    trial = fused_generic.make_fused_generic_trial(matrix, TAlg[alg], CAP,
                                                   False)
    got = trial(alice, bob, lp, f1, f2, 0.0)
    want = trial.plain(alice, bob, lp, f1, f2, 0.0)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    conv, iters = got[0].cpu(), got[2].cpu()
    assert bool(conv[0]) and int(iters[0]) <= 1
    assert not bool(conv[21:].any()) and bool((iters[21:] == CAP).all())
    lpt = torch.tensor(lp, device=cuda_device)
    dec = fused_generic.make_fused_generic_decoder(matrix, TAlg[alg], CAP,
                                                   False)
    args = (torch.where(bob == 1, -lpt, lpt),
            calculate_syndrome(layout_for(matrix), alice), f1, f2, 0.0)
    got = dec(*args)
    want = dec.plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("alg", list(CARD_FACTORS))
def test_degree63_code_every_mode_on_card(cuda_device, alg):
    """The 1k alist code with check degrees 62-63 (four words of edge bits,
    longer than the register run): trial, decode, mc and frame modes, each
    equal to its plain version."""
    matrix = read_sparse_matrix_alist(ALIST1K_DEG63)
    _all_modes(matrix, alg, 0.004, _forced(matrix, alg, None), cuda_device,
               batch=63)


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["SPA", "SPA_APPROX"])
@pytest.mark.parametrize("checks", ["shared", "global"])
def test_spa_pair_both_storages_on_card(cuda_device, alg, checks):
    """The SPA pair with its f32 values in shared memory (one block of 1024
    threads per SM at the 10k alist code) and in the global slice, decode
    mode on LLRs with a zero (the 0/0 ratio) and eight times the channel's
    magnitude (tanh rounds to +-1), and mc mode, each equal to its plain
    version."""
    from qkd_ldpc_v_tpu_torch.simulation import chunk_seed

    matrix = read_sparse_matrix_alist(ALIST10K)
    trial, decode, mc, _ = _forced(matrix, alg, checks)
    n = matrix.num_bit_nodes
    ne = int(n * 0.03)
    alice, bob = _keys(n, 40, ne, seed=7, device=cuda_device)
    lpt = torch.tensor(log_ratio(ne / n), device=cuda_device)
    llr = torch.where(bob == 1, -lpt, lpt)
    llr[0, 0] = 0.0
    llr[1] *= 8.0
    syn = calculate_syndrome(layout_for(matrix), alice)
    for fn, args, kwargs in (
            (decode, (llr, syn, 1.0, 1.0, 0.0), {}),
            (mc, (chunk_seed(11, 0, 4), 300, 40, ne, log_ratio(ne / n), 1.0,
                  1.0, 0.0), {"device": cuda_device})):
        got = fn(*args, **kwargs)
        want = fn.plain(*args, **kwargs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
