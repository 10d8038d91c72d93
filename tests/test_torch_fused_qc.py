"""Fused QC wrappers (qkd_ldpc_v_tpu_torch/ops/fused_qc.py).

On the CPU the wrappers run their plain torch versions; those must equal
the JAX package's fused Pallas kernel in interpret mode on the same keys,
exactly (conv, keys, iterations and, in decode mode, decisions). Each mode
is checked with NMSA and OMSA across both schedules. The launch counter
stays 0 on the CPU.

Tests marked ``cuda`` compare the CUDA kernel with its plain version on the
card and skip without one: the trial and decode modes, the frame mode on
rate-adapted frames (ragged batches, and a frame whose checks around one bit
have every other bit shortened, so that sums overflow to inf and NaN), and
the mc mode against ``channel.mc_channel`` and the plain trial; and the
SPA pair (SPA, SPA-lin-approx) in all four modes, forced frames included.
They
import no JAX, so on a machine without JAX they run with the conftest left
out:

    python -m pytest tests/test_torch_fused_qc.py -m cuda --noconftest -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.models.qc import generate_qc_ldpc, read_qc_matrix
from qkd_ldpc_v_tpu_torch.ops import fused_qc, launch, philox
from qkd_ldpc_v_tpu_torch.ops.channel import (
    build_frames,
    inject_errors,
    log_ratio,
    qc_syndrome,
)
from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams, adapt_code_rate

torch.set_num_threads(2)

CAP = 25
THRESHOLD = 2.5


def _keys(n, batch, num_errors, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    alice = torch.tensor(rng.integers(0, 2, (batch, n)), dtype=torch.int8,
                         device=device)
    bits = torch.tensor(rng.integers(0, 2**32, (batch, n)), dtype=torch.int64,
                        device=device)
    return alice, inject_errors(bits, alice, num_errors, wide=True)


def all_shortened_plan(matrix, params, bit=0):
    """``params`` with every other bit of each check on ``bit`` shortened
    (and taken out of the punctured set), ``bit`` itself in the payload:
    each check of ``bit`` then has all its other bits shortened. Their
    float32-maximum LLRs make check->bit messages of that size, whose sums
    overflow to inf, and inf - inf gives NaN when the clamp is off."""
    others = {int(b) for c in matrix.bit_nodes[bit]
              for b in matrix.check_nodes[int(c)]} - {bit}
    punct = [int(p) for p in params.punctured_bits
             if int(p) not in others and int(p) != bit]
    short = sorted(({int(s) for s in params.shortened_bits} | others) - {bit})
    return HMatrixParams(punctured_bits=np.array(punct, dtype=np.int32),
                         shortened_bits=np.array(short, dtype=np.int32))


def rate_adapted_frames(matrix, params, batch, qber, seed, device="cpu",
                        dtype=torch.float32):
    """(alice_frame int8, llr) [batch, N] of ``params``' frame plan, built
    by ``channel.build_frames`` from seeded keys with exactly
    ``floor(N * qber)`` errors over the full N bits."""
    n = matrix.num_bit_nodes
    ne = int(n * qber)
    alice, bob = _keys(n, batch, ne, seed, device)
    rng = np.random.default_rng(seed + 1)
    punct = torch.tensor(rng.integers(0, 2, (batch, n)), dtype=torch.int8,
                         device=device)
    pos_class, gather = tsim.make_frame_plan(n, params)
    return build_frames(
        alice, bob, punct, torch.tensor(pos_class == 0, device=device),
        torch.tensor(pos_class == 1, device=device),
        torch.tensor(gather.astype(np.int64), device=device),
        log_ratio(ne / n, dtype), dtype)


@pytest.fixture(scope="module")
def qc():
    return generate_qc_ldpc(8, 4, 128, 3, seed=5)


@pytest.fixture(scope="module")
def keys(qc):
    # 80 errors in 1024 bits: most frames converge within the cap, some do
    # not, so frozen and final decisions are both compared.
    return _keys(qc.num_bit_nodes, 8, 80, seed=3)


@pytest.mark.parametrize("alg,f1,f2,schedule", [
    ("NMSA", 0.8, 1.0, "flooding"),
    ("OMSA", 0.3, 1.0, "layered"),
])
def test_trial_cpu_matches_pallas_trial(qc, keys, alg, f1, f2, schedule):
    import jax
    from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
    from qkd_ldpc_v_tpu.ops.pallas_qc import make_pallas_qc_trial

    alice, bob = keys
    n = qc.num_bit_nodes
    qber = 80 / n
    fused_qc.reset_counts()
    trial = fused_qc.make_fused_qc_trial(qc, TAlg[alg], CAP, False, schedule)
    conv, ok, iters = trial(alice, bob, log_ratio(qber), f1, f2, 0.0)
    jtrial = make_pallas_qc_trial(qc, JAlg[alg], CAP, False, batch_tile=8,
                                  interpret=True, schedule=schedule)
    jconv, jok, jiters = jax.device_get(
        jtrial(alice.numpy(), bob.numpy(), qber, f1, f2, 0.0))
    assert 0 < int(conv.sum()) < len(conv)
    np.testing.assert_array_equal(conv.numpy(), jconv)
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_array_equal(iters.numpy(), jiters)
    assert fused_qc.counts() == (0, 0)


@pytest.mark.parametrize("alg,f1,f2,schedule,use_thr", [
    ("OMSA", 0.3, 1.0, "flooding", True),
    ("NMSA", 0.8, 1.0, "layered", False),
])
def test_decode_cpu_matches_pallas_decoder(qc, keys, alg, f1, f2, schedule,
                                           use_thr):
    import jax
    from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
    from qkd_ldpc_v_tpu.ops.pallas_qc import make_pallas_qc_decoder

    alice, bob = keys
    lp = torch.tensor(log_ratio(80 / qc.num_bit_nodes))
    llr = torch.where(bob == 1, -lp, lp)
    syn = qc_syndrome(qc, alice)
    thr = THRESHOLD if use_thr else 0.0
    fused_qc.reset_counts()
    dec = fused_qc.make_fused_qc_decoder(qc, TAlg[alg], CAP, use_thr, schedule)
    res = dec(llr, syn, f1, f2, thr)
    jdec = make_pallas_qc_decoder(qc, JAlg[alg], CAP, use_thr, batch_tile=8,
                                  interpret=True, schedule=schedule)
    jres = jax.device_get(jdec(llr.numpy(), syn.numpy(), f1, f2, thr))
    np.testing.assert_array_equal(res.decision.numpy(), jres.decision)
    np.testing.assert_array_equal(res.syndromes_match.numpy(),
                                  jres.syndromes_match)
    np.testing.assert_array_equal(res.iterations.numpy(), jres.iterations)
    assert fused_qc.counts() == (0, 0)


def test_wrappers_check_inputs(qc, keys):
    alice, bob = keys
    trial = fused_qc.make_fused_qc_trial(qc, TAlg.NMSA, CAP, False)
    with pytest.raises(TypeError):
        trial(alice.to(torch.int32), bob, 3.0)
    with pytest.raises(ValueError):
        trial(alice[:, :100], bob[:, :100], 3.0)
    with pytest.raises(ValueError):
        trial(alice.t().contiguous().t(), bob, 3.0)
    with pytest.raises(ValueError, match="schedule"):
        fused_qc.make_fused_qc_trial(qc, TAlg.NMSA, CAP, False, "zigzag")
    # The SPA pair floods: the layered schedule raises before any launch,
    # and the flooding trial runs its plain version on the CPU.
    for alg in (TAlg.SPA, TAlg.SPA_APPROX):
        for make in (fused_qc.make_fused_qc_trial,
                     fused_qc.make_fused_qc_montecarlo,
                     fused_qc.make_fused_qc_frame_trial,
                     fused_qc.make_fused_qc_decoder):
            with pytest.raises(ValueError, match="layered"):
                make(qc, alg, CAP, False, "layered")
    fused_qc.reset_counts()
    spa = fused_qc.make_fused_qc_trial(qc, TAlg.SPA_APPROX, CAP, False)
    got = spa(alice, bob, 3.0, 1.0, 1.0, 0.0)
    want = spa.plain(alice, bob, 3.0, 1.0, 1.0, 0.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fused_qc.counts() == (0, 0)
    assert fused_qc.COUNTS.plain("trial") == 2


def test_non_cpu_tensors_never_take_the_plain_path(qc):
    """A tensor on a device other than the CPU either launches the kernel or
    raises; here (meta tensors, no kernel) it must raise, and neither counter
    moves."""
    n = qc.num_bit_nodes
    alice = torch.empty((2, n), dtype=torch.int8, device="meta")
    trial = fused_qc.make_fused_qc_trial(qc, TAlg.NMSA, CAP, False)
    fused_qc.reset_counts()
    with pytest.raises(NotImplementedError, match="meta"):
        trial(alice, alice, 3.0)
    assert fused_qc.counts() == (0, 0)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing returns None or falls back."""
    monkeypatch.setattr(kernels, "_LIBRARY", None)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "NVCC_DEFAULT", tmp_path / "nvcc")
    monkeypatch.setattr(kernels.shutil, "which", lambda _name: None)
    with pytest.raises(kernels.KernelBuildError, match="nvcc"):
        kernels.library()


# ---------------------------------------------------------------------------
# On the card: kernel == plain, exactly.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused QC kernel has no CPU mode")
    return torch.device("cuda")


HEADLINE = (Path(__file__).resolve().parent.parent / "sparse_matrices"
            / "matrices_qc" / "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx")
CUDA_CASES = [
    (alg, f1, f2, schedule, use_thr)
    for (alg, f1, f2) in [("NMSA", 0.8, 1.0), ("OMSA", 0.3, 1.0),
                          ("ANMSA", 0.88, 0.5), ("AOMSA", 0.3, 0.6)]
    for schedule in ("flooding", "layered")
    for use_thr in (False, True)
]


@pytest.mark.cuda
@pytest.mark.parametrize("alg,f1,f2,schedule,use_thr", CUDA_CASES)
def test_kernel_matches_plain_on_card(cuda_device, alg, f1, f2, schedule,
                                      use_thr):
    # QBERs in each code's waterfall: some frames converge, some do not.
    for code, qber in ((generate_qc_ldpc(8, 4, 128, 3, seed=5), 0.075),
                       (read_qc_matrix(HEADLINE), 0.036)):
        n = code.num_bit_nodes
        ne = int(n * qber)
        alice, bob = _keys(n, 64, ne, seed=7, device=cuda_device)
        thr = THRESHOLD if use_thr else 0.0
        lp = log_ratio(ne / n)
        trial = fused_qc.make_fused_qc_trial(code, TAlg[alg], CAP, use_thr,
                                             schedule)
        got = trial(alice, bob, lp, f1, f2, thr)
        want = trial.plain(alice, bob, lp, f1, f2, thr)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
        lpt = torch.tensor(lp, device=cuda_device)
        llr = torch.where(bob == 1, -lpt, lpt)
        syn = qc_syndrome(code, alice)
        dec = fused_qc.make_fused_qc_decoder(code, TAlg[alg], CAP, use_thr,
                                             schedule)
        got = dec(llr, syn, f1, f2, thr)
        want = dec.plain(llr, syn, f1, f2, thr)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("alg,f1,f2", [("NMSA", 0.8, 1.0), ("OMSA", 0.3, 1.0),
                                       ("ANMSA", 0.88, 0.5),
                                       ("AOMSA", 0.3, 0.6)])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("use_thr", [False, True])
def test_frame_kernel_matches_plain_on_card(cuda_device, alg, f1, f2,
                                            schedule, use_thr):
    """The frame mode on rate-adapted frames of the 1k QC code (R=0.5 to
    about 0.48 at QBER 0.08): ragged batches of 1, 7 and 13 frames, and the
    all-shortened neighbourhood of bit 0 (also at a primary factor of 1.25),
    with the clamp off and on."""
    code = generate_qc_ldpc(8, 4, 128, 3, seed=5)
    matrix = code.to_hmatrix()
    params = adapt_code_rate(np.random.default_rng(3), matrix, 0.08, 0.1, 1.3)
    assert len(params.punctured_bits) and len(params.shortened_bits)
    thr = THRESHOLD if use_thr else 0.0
    trial = fused_qc.make_fused_qc_frame_trial(code, TAlg[alg], CAP, use_thr,
                                               schedule)
    forced = all_shortened_plan(matrix, params)
    # The forced plan also at a primary factor of 1.25: its messages
    # overflow to inf and inf - inf gives NaN.
    for plan, batch, fac in ((params, 1, f1), (params, 7, f1),
                             (params, 13, f1), (forced, 13, f1),
                             (forced, 13, 1.25)):
        frame, llr = rate_adapted_frames(matrix, plan, batch, 0.08, seed=9,
                                         device=cuda_device)
        got = trial(frame, llr, fac, f2, thr)
        want = trial.plain(frame, llr, fac, f2, thr)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
def test_selection_bytes_equal_the_library(cuda_device):
    assert philox.SELECTION_BYTES == kernels.library().mc_selection_bytes()


@pytest.mark.cuda
@pytest.mark.parametrize("alg,f1,f2,schedule,use_thr", CUDA_CASES)
def test_mc_kernel_matches_plain_on_card(cuda_device, alg, f1, f2, schedule,
                                         use_thr):
    """The mc mode (keys drawn in the kernel) against ``mc_channel`` and the
    plain trial: each code in its waterfall, a ragged batch of 37 frames
    from frame 1000 of the chunk, and a batch without errors."""
    seed = tsim.chunk_seed(5, 2, 3)
    for code, qber in ((generate_qc_ldpc(8, 4, 128, 3, seed=5), 0.075),
                       (read_qc_matrix(HEADLINE), 0.036)):
        n = code.num_bit_nodes
        thr = THRESHOLD if use_thr else 0.0
        mc = fused_qc.make_fused_qc_montecarlo(code, TAlg[alg], CAP, use_thr,
                                               schedule)
        for frame0, batch, ne in ((0, 64, int(n * qber)),
                                  (1000, 37, int(n * qber)), (0, 5, 0)):
            args = (seed, frame0, batch, ne, log_ratio(max(ne, 1) / n), f1,
                    f2, thr)
            got = mc(*args, device=cuda_device)
            want = mc.plain(*args, device=cuda_device)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w.cpu())
            if ne == 0:
                assert bool(got[1].all())


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["SPA", "SPA_APPROX"])
@pytest.mark.parametrize("thr", [None, 2.5, 100.0])
def test_spa_kernel_matches_plain_on_card(cuda_device, alg, thr):
    """The SPA pair in the trial, decode, frame and mc modes (flooding)
    against the plain versions, with the clamp off, below the channel's
    |LLR| and above it. The decode mode's LLRs carry a zero (the 0/0 ratio)
    in frame 0 and eight times the channel's magnitude in frame 1 (tanh
    rounds to +-1 and the guard clamps); the frame mode takes the
    all-shortened neighbourhood of bit 0 (inf and NaN)."""
    use_thr = thr is not None
    t = thr if use_thr else 0.0
    code = read_qc_matrix(HEADLINE)
    n = code.num_bit_nodes
    ne = int(n * 0.03)
    lp = log_ratio(ne / n)
    alice, bob = _keys(n, 64, ne, seed=13, device=cuda_device)
    kinds = {
        "trial": (fused_qc.make_fused_qc_trial, (alice, bob, lp, 1.0, 1.0, t)),
    }
    lpt = torch.tensor(lp, device=cuda_device)
    llr = torch.where(bob == 1, -lpt, lpt)
    llr[0, 0] = 0.0
    llr[1] *= 8.0
    kinds["decode"] = (fused_qc.make_fused_qc_decoder,
                       (llr, qc_syndrome(code, alice), 1.0, 1.0, t))
    small = generate_qc_ldpc(8, 4, 128, 3, seed=5)
    matrix = small.to_hmatrix()
    params = adapt_code_rate(np.random.default_rng(3), matrix, 0.08, 0.1, 1.3)
    frame, fllr = rate_adapted_frames(matrix, all_shortened_plan(matrix,
                                                                 params),
                                      13, 0.08, seed=9, device=cuda_device)
    for kind, (make, args) in kinds.items():
        fn = make(code, TAlg[alg], CAP, use_thr)
        got, want = fn(*args), fn.plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu()), kind
    trial = fused_qc.make_fused_qc_frame_trial(small, TAlg[alg], CAP, use_thr)
    got, want = trial(frame, fllr, 1.0, 1.0, t), trial.plain(frame, fllr, 1.0,
                                                             1.0, t)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    mc = fused_qc.make_fused_qc_montecarlo(code, TAlg[alg], CAP, use_thr)
    args = (tsim.chunk_seed(5, 2, 3), 1000, 37, ne, lp, 1.0, 1.0, t)
    got, want = mc(*args, device=cuda_device), mc.plain(*args,
                                                        device=cuda_device)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


# ---------------------------------------------------------------------------
# The redesigned layout on the card: the plan against the library, shapes
# that stress it, a batch that mixes converging and capped frames, and the
# SPA pair's messages in global memory.
# ---------------------------------------------------------------------------

QC_DIR = HEADLINE.parent
R035 = QC_DIR / "(N=10240,M=6656,R=0.35,CW=4,Z=256,SEED=41).mtrx"


def _shape_code(name):
    """(code, QBER in its waterfall) of the shapes that stress the layout:
    26 base rows, rows of 40 edges (three words of edge bits, checks longer
    than the register run), Z = 100 (not a warp multiple) and Z = 1024."""
    from qkd_ldpc_v_tpu_torch.models.qc import generate_qc_peg

    if name == "rows26":
        return read_qc_matrix(R035), 0.1
    if name == "deg40":
        return generate_qc_peg(40, 3, 96, 3, seed=1), 0.004
    if name == "z100":
        return generate_qc_peg(12, 4, 100, 3, seed=1), 0.04
    return generate_qc_peg(8, 4, 1024, 3, seed=1), 0.075


def _assert_equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
def test_launch_plan_equals_the_library(cuda_device):
    lib = kernels.library()
    codes = [read_qc_matrix(HEADLINE), read_qc_matrix(R035),
             generate_qc_ldpc(8, 4, 128, 3, seed=5)]
    codes += [_shape_code(name)[0] for name in ("deg40", "z100", "z1024")]
    for code in codes:
        shape = launch.shape_of(code)
        assert lib.fused_qc_threads(code.lifting) \
            == fused_qc.launch_plan(code, 0, "trial").threads
        for flags in list(range(8)) + [8, 16]:
            for messages in (("shared", "global") if flags >= 8
                             else ("shared",)):
                extra = fused_qc.SPA_GLOBAL if messages == "global" else 0
                for mode, code_of in launch.MODES.items():
                    plan = fused_qc.launch_plan(code, flags, mode, messages)
                    assert lib.fused_qc_shared_bytes(
                        *shape, flags | extra, code_of) == plan.shared_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rows26", "deg40", "z100", "z1024"])
@pytest.mark.parametrize("alg,f1,f2,schedule", [
    ("NMSA", 0.8, 1.0, "flooding"), ("NMSA", 0.8, 1.0, "layered"),
    ("AOMSA", 0.3, 0.6, "flooding"), ("ANMSA", 0.88, 0.5, "layered")])
def test_stress_shapes_match_plain_on_card(cuda_device, name, alg, f1, f2,
                                           schedule):
    """The trial, decode, frame and mc modes on each stressing shape, in its
    waterfall (some frames converge, some run to the cap)."""
    code, qber = _shape_code(name)
    n = code.num_bit_nodes
    ne = int(n * qber)
    lp = log_ratio(ne / n)
    algorithm = TAlg[alg]
    alice, bob = _keys(n, 48, ne, seed=21, device=cuda_device)
    trial = fused_qc.make_fused_qc_trial(code, algorithm, CAP, False,
                                         schedule)
    got = trial(alice, bob, lp, f1, f2, 0.0)
    _assert_equal(got, trial.plain(alice, bob, lp, f1, f2, 0.0))
    # Flooding fails some frames of each shape at its QBER; layered
    # converges more of them.
    assert 0 < int(got[0].sum()) and (int(got[0].sum()) < 48
                                      or schedule == "layered")
    lpt = torch.tensor(lp, device=cuda_device)
    llr = torch.where(bob == 1, -lpt, lpt)
    dec = fused_qc.make_fused_qc_decoder(code, algorithm, CAP, True,
                                         schedule)
    syn = qc_syndrome(code, alice)
    _assert_equal(dec(llr, syn, f1, f2, THRESHOLD),
                  dec.plain(llr, syn, f1, f2, THRESHOLD))
    frame_trial = fused_qc.make_fused_qc_frame_trial(code, algorithm, CAP,
                                                     False, schedule)
    _assert_equal(frame_trial(alice, llr, f1, f2, 0.0),
                  frame_trial.plain(alice, llr, f1, f2, 0.0))
    mc = fused_qc.make_fused_qc_montecarlo(code, algorithm, CAP, False,
                                           schedule)
    args = (tsim.chunk_seed(9, 0, 1), 500, 37, ne, lp, f1, f2, 0.0)
    _assert_equal(mc(*args, device=cuda_device),
                  mc.plain(*args, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("alg,f1,f2", [("NMSA", 0.8, 1.0),
                                       ("ANMSA", 0.88, 0.5)])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_mixed_batch_matches_plain_on_card(cuda_device, alg, f1, f2,
                                           schedule):
    """One batch whose frames converge at once (no errors), within the cap
    (the waterfall) and never (far past it), interleaved."""
    code = read_qc_matrix(HEADLINE)
    n = code.num_bit_nodes
    parts = [_keys(n, 8, ne, seed=s, device=cuda_device)
             for s, ne in ((1, 0), (2, int(n * 0.036)), (3, int(n * 0.06)))]
    order = torch.arange(24, device=cuda_device).reshape(3, 8).t().reshape(-1)
    alice = torch.cat([a for a, _ in parts])[order].contiguous()
    bob = torch.cat([b for _, b in parts])[order].contiguous()
    lp = log_ratio(0.036)
    trial = fused_qc.make_fused_qc_trial(code, TAlg[alg], CAP, False,
                                         schedule)
    got = trial(alice, bob, lp, f1, f2, 0.0)
    _assert_equal(got, trial.plain(alice, bob, lp, f1, f2, 0.0))
    assert bool(got[0][0::3].all()) and not bool(got[0][2::3].any())
    lpt = torch.tensor(lp, device=cuda_device)
    llr = torch.where(bob == 1, -lpt, lpt)
    syn = qc_syndrome(code, alice)
    dec = fused_qc.make_fused_qc_decoder(code, TAlg[alg], CAP, False,
                                         schedule)
    _assert_equal(dec(llr, syn, f1, f2, 0.0), dec.plain(llr, syn, f1, f2, 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["SPA", "SPA_APPROX"])
def test_spa_global_messages_match_plain_on_card(cuda_device, alg):
    """The SPA pair with its messages forced into the per-block global slice
    (the plan's choice where a frame's do not fit in shared memory): trial,
    decode, frame and mc modes, on batches larger than the resident blocks,
    so that each block walks several frames."""
    def forced(code, flags, device):
        return fused_qc._Launch(code, flags, device, messages="global")

    plans = launch.cached_plans(forced)
    algorithm = TAlg[alg]
    code = generate_qc_ldpc(8, 4, 128, 3, seed=5)
    n = code.num_bit_nodes
    ne = int(n * 0.075)
    lp = log_ratio(ne / n)
    flags = launch.kernel_flags(algorithm, False)
    resident = plans(code, flags, cuda_device).resident["trial"]
    batch = resident + 37
    alice, bob = _keys(n, batch, ne, seed=5, device=cuda_device)
    for use_thr, thr in ((False, 0.0), (True, THRESHOLD)):
        trial = launch.qc_trial("fused QC", fused_qc.COUNTS, plans, code,
                                  algorithm, CAP, use_thr, "flooding")
        _assert_equal(trial(alice, bob, lp, 1.0, 1.0, thr),
                      trial.plain(alice, bob, lp, 1.0, 1.0, thr))
        lpt = torch.tensor(lp, device=cuda_device)
        llr = torch.where(bob == 1, -lpt, lpt)
        dec = launch.qc_decoder("fused QC", fused_qc.COUNTS, plans, code,
                                  algorithm, CAP, use_thr, "flooding")
        syn = qc_syndrome(code, alice)
        _assert_equal(dec(llr, syn, 1.0, 1.0, thr),
                      dec.plain(llr, syn, 1.0, 1.0, thr))
        frame = launch.qc_frame_trial("fused QC", fused_qc.COUNTS, plans,
                                        code, algorithm, CAP, use_thr,
                                        "flooding")
        _assert_equal(frame(alice, llr, 1.0, 1.0, thr),
                      frame.plain(alice, llr, 1.0, 1.0, thr))
        mc = launch.qc_montecarlo("fused QC", fused_qc.COUNTS, plans, code,
                                    algorithm, CAP, use_thr, "flooding")
        args = (tsim.chunk_seed(5, 2, 3), 1000, batch, ne, lp, 1.0, 1.0, thr)
        _assert_equal(mc(*args, device=cuda_device),
                      mc.plain(*args, device=cuda_device))
