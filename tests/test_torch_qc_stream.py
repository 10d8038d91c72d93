"""Streamed QC wrappers (qkd_ldpc_v_tpu_torch/ops/qc_stream.py) and the
sweep's QC kernel choice (simulation.qc_kernel).

On the CPU the wrappers run their plain torch versions; those must equal
the JAX package's streamed Pallas kernel in interpret mode on the same keys,
exactly: decisions, convergence and iterations in decode mode for NMSA,
OMSA, ANMSA and AOMSA in both schedules, plus a clamp case; conv, keys and
iterations in trial mode. The channels hold an easy half (every frame
converges) and a hard half (some frames run to the iteration cap). The
adaptive pair under flooding is held exactly where JAX's streamed kernel
allows it, which is stricter than the JAX package's own test of that
kernel (converged frames only, iterations within 3).

Two differences of the JAX streamed kernel are pinned, not followed; the
port follows the reference decoder, the JAX XLA decoder and both JAX fused
kernels, which agree (ROADMAP.md §3):
  * ANMSA flooding: two hard frames that run to the cap end with other
    decisions (they differ by iteration 6). That case is held at the JAX
    package's tolerance class against the streamed kernel and exactly
    against the fused one.
  * With the message clamp below the channel-LLR magnitude, the streamed
    kernel clamps the first flooding sweep's channel messages, which the
    others leave unclamped.

Tests marked ``cuda`` compare the CUDA kernel with its plain version and
with the fused QC kernel on the card (trial, decode and mc modes, the
min-sum family and the SPA pair), and the
Python limit constants with the built library; they skip without a CUDA
device. They import no JAX, so
on a machine without JAX they run with the conftest left out:

    python -m pytest tests/test_torch_qc_stream.py -m cuda --noconftest -q
"""

import dataclasses
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu_torch import engines, kernels
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.config import MatrixFormat as TFormat
from qkd_ldpc_v_tpu_torch.convert import config_from_dict
from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix as tread_matrix
from qkd_ldpc_v_tpu_torch.models.qc import generate_qc_peg, read_qc_matrix
from qkd_ldpc_v_tpu_torch.ops import fused_qc, launch, qc_stream
from qkd_ldpc_v_tpu_torch.ops.channel import log_ratio, qc_syndrome

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
QC_DIR = REPO / "sparse_matrices" / "matrices_qc"
QC_ASSETS = sorted(QC_DIR.glob("*.mtrx"))
CAP = 30
EASY, HARD = 30, 90  # errors per 1024-bit frame
ALGS = [
    ("NMSA", 0.8, 1.0),
    ("OMSA", 0.3, 1.0),
    ("ANMSA", 0.88, 0.5),
    ("AOMSA", 0.3, 0.6),
]
# Where JAX's streamed kernel differs from the exact trajectory that the
# reference decoder, the JAX XLA decoder, both JAX fused kernels and the port
# share (ROADMAP.md §3).
STREAM_TOLERANCE = {("ANMSA", "flooding")}


@pytest.fixture(scope="module")
def qc():
    """tests/test_pallas_qc_stream.py's code: N=1024, 4 x 8 base, Z=128."""
    return generate_qc_peg(8, 4, 128, column_weight=3, seed=7)


def _frames(n, num_errors, batch, rng):
    alice = rng.integers(0, 2, (batch, n)).astype(np.int8)
    bob = alice.copy()
    for i in range(batch):
        bob[i, rng.choice(n, size=num_errors, replace=False)] ^= 1
    return alice, bob


@pytest.fixture(scope="module")
def channels(qc):
    """Per error count: 8 frames' keys, LLRs and syndrome as tensors."""
    rng = np.random.default_rng(3)
    n = qc.num_bit_nodes
    out = {}
    for ne in (EASY, HARD):
        alice, bob = _frames(n, ne, 8, rng)
        lp = torch.tensor(log_ratio(ne / n))
        bob_t = torch.tensor(bob)
        alice_t = torch.tensor(alice)
        out[ne] = dict(alice=alice_t, bob=bob_t,
                       llr=torch.where(bob_t == 1, -lp, lp),
                       syn=qc_syndrome(qc, alice_t), log_p=float(lp))
    return out


def _both(channels, key):
    return torch.cat([channels[EASY][key], channels[HARD][key]])


def _jax_qc(qc):
    from qkd_ldpc_v_tpu.models.qc import generate_qc_peg as jgen

    jqc = jgen(8, 4, 128, column_weight=3, seed=7)
    np.testing.assert_array_equal(jqc.shifts, qc.shifts)
    return jqc


def _assert_decode_equal(got, want):
    np.testing.assert_array_equal(got.decision.numpy(), np.asarray(want.decision))
    np.testing.assert_array_equal(got.syndromes_match.numpy(),
                                  np.asarray(want.syndromes_match))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("alg,f1,f2", ALGS)
def test_decode_cpu_matches_pallas_stream(qc, channels, alg, f1, f2, schedule):
    import jax
    from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
    from qkd_ldpc_v_tpu.ops.pallas_qc_stream import make_pallas_qc_stream_decoder

    llr, syn = _both(channels, "llr"), _both(channels, "syn")
    qc_stream.reset_counts()
    got = qc_stream.make_qc_stream_decoder(qc, TAlg[alg], CAP, False,
                                           schedule)(llr, syn, f1, f2, 0.0)
    jdec = make_pallas_qc_stream_decoder(_jax_qc(qc), JAlg[alg], CAP, False,
                                         interpret=True, schedule=schedule)
    want = jax.device_get(jdec(llr.numpy(), syn.numpy(), f1, f2, 0.0))
    assert bool(got.syndromes_match[:8].all())
    assert int((got.iterations == CAP).sum()) > 0
    assert qc_stream.counts() == (0, 0)
    if (alg, schedule) not in STREAM_TOLERANCE:
        _assert_decode_equal(got, want)
        return
    # JAX's streamed kernel leaves the exact trajectory here at two frames
    # that run to the cap (ROADMAP.md §3): it is held at the JAX package's
    # own tolerance class, and the port exactly to JAX's fused kernel.
    conv = got.syndromes_match.numpy()
    np.testing.assert_array_equal(conv, np.asarray(want.syndromes_match))
    np.testing.assert_array_equal(got.decision.numpy()[conv],
                                  np.asarray(want.decision)[conv])
    assert np.abs(got.iterations.numpy() - np.asarray(want.iterations)).max() <= 3
    differ = (got.decision.numpy() != np.asarray(want.decision)).any(axis=1)
    assert (got.iterations.numpy()[differ] == CAP).all()
    from qkd_ldpc_v_tpu.ops.pallas_qc import make_pallas_qc_decoder

    fused = make_pallas_qc_decoder(_jax_qc(qc), JAlg[alg], CAP, False,
                                   batch_tile=8, interpret=True)
    _assert_decode_equal(got, jax.device_get(
        fused(llr.numpy(), syn.numpy(), f1, f2, 0.0)))


def test_decode_clamp_matches_pallas_stream(qc, channels):
    """The message clamp above the channel-LLR magnitude, where the JAX
    streamed kernel agrees with the reference decoder."""
    import jax
    from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
    from qkd_ldpc_v_tpu.ops.pallas_qc_stream import make_pallas_qc_stream_decoder

    llr, syn = _both(channels, "llr"), _both(channels, "syn")
    assert float(llr.abs().max()) < 4.0
    got = qc_stream.make_qc_stream_decoder(qc, TAlg.NMSA, CAP, True)(
        llr, syn, 0.8, 1.0, 4.0)
    jdec = make_pallas_qc_stream_decoder(_jax_qc(qc), JAlg.NMSA, CAP, True,
                                         interpret=True)
    want = jax.device_get(jdec(llr.numpy(), syn.numpy(), 0.8, 1.0, 4.0))
    _assert_decode_equal(got, want)


def test_clamp_below_channel_llr_follows_the_fused_kernel(qc, channels):
    """Clamp 2.5 under |LLR| = 3.5: the port equals the JAX fused kernel
    (and through it the XLA decoder); the JAX streamed kernel, which clamps
    the first sweep's channel messages, does not (ROADMAP.md §3)."""
    import jax
    from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
    from qkd_ldpc_v_tpu.ops.pallas_qc import make_pallas_qc_decoder
    from qkd_ldpc_v_tpu.ops.pallas_qc_stream import make_pallas_qc_stream_decoder

    llr, syn = channels[EASY]["llr"], channels[EASY]["syn"]
    args = (llr.numpy(), syn.numpy(), 0.8, 1.0, 2.5)
    jqc = _jax_qc(qc)
    got = qc_stream.make_qc_stream_decoder(qc, TAlg.NMSA, CAP, True)(
        llr, syn, 0.8, 1.0, 2.5)
    fused = jax.device_get(make_pallas_qc_decoder(
        jqc, JAlg.NMSA, CAP, True, batch_tile=8, interpret=True)(*args))
    _assert_decode_equal(got, fused)
    stream = jax.device_get(make_pallas_qc_stream_decoder(
        jqc, JAlg.NMSA, CAP, True, interpret=True)(*args))
    assert not np.array_equal(np.asarray(stream.iterations),
                              np.asarray(fused.iterations))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_trial_cpu_matches_pallas_stream(qc, channels, schedule):
    import jax
    from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
    from qkd_ldpc_v_tpu.ops.pallas_qc_stream import make_pallas_qc_stream_trial

    jtrial = make_pallas_qc_stream_trial(_jax_qc(qc), JAlg.NMSA, CAP, False,
                                         interpret=True, schedule=schedule)
    trial = qc_stream.make_qc_stream_trial(qc, TAlg.NMSA, CAP, False, schedule)
    n = qc.num_bit_nodes
    conv_all = []
    for ne in (EASY, HARD):
        ch = channels[ne]
        got = trial(ch["alice"], ch["bob"], ch["log_p"], 0.8, 1.0, 0.0)
        want = jax.device_get(jtrial(ch["alice"].numpy(), ch["bob"].numpy(),
                                     ne / n, 0.8, 1.0, 0.0))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        conv_all.append(got[0])
    conv = torch.cat(conv_all)
    assert 0 < int(conv.sum()) < len(conv)


def test_wrappers_check_inputs(qc, channels):
    ch = channels[EASY]
    trial = qc_stream.make_qc_stream_trial(qc, TAlg.NMSA, CAP, False)
    with pytest.raises(TypeError):
        trial(ch["alice"].to(torch.int32), ch["bob"], 3.0)
    with pytest.raises(ValueError):
        trial(ch["alice"][:, :100], ch["bob"][:, :100], 3.0)
    dec = qc_stream.make_qc_stream_decoder(qc, TAlg.NMSA, CAP, False)
    with pytest.raises(ValueError):
        dec(ch["llr"], ch["syn"][:, :10])
    with pytest.raises(ValueError, match="schedule"):
        qc_stream.make_qc_stream_trial(qc, TAlg.NMSA, CAP, False, "zigzag")
    # The SPA pair floods: the layered schedule raises before any launch.
    for make in (qc_stream.make_qc_stream_trial,
                 qc_stream.make_qc_stream_montecarlo,
                 qc_stream.make_qc_stream_decoder):
        with pytest.raises(ValueError, match="layered"):
            make(qc, TAlg.SPA, CAP, False, "layered")
    qc_stream.make_qc_stream_decoder(qc, TAlg.SPA, CAP, False)


def test_non_cpu_tensors_never_take_the_plain_path(qc):
    """A tensor on a device other than the CPU launches the kernel or
    raises; meta tensors have no kernel, so both wrappers raise and neither
    counter moves."""
    n, m = qc.num_bit_nodes, qc.num_check_nodes
    keys = torch.empty((2, n), dtype=torch.int8, device="meta")
    qc_stream.reset_counts()
    with pytest.raises(NotImplementedError, match="meta"):
        qc_stream.make_qc_stream_trial(qc, TAlg.NMSA, CAP, False)(keys, keys, 3.0)
    with pytest.raises(NotImplementedError, match="meta"):
        qc_stream.make_qc_stream_decoder(qc, TAlg.NMSA, CAP, False)(
            torch.empty((2, n), device="meta"),
            torch.empty((2, m), dtype=torch.int8, device="meta"))
    assert qc_stream.counts() == (0, 0)


def test_kernel_limits_raise():
    """Beyond the kernel's limits a launch raises before any build."""
    from qkd_ldpc_v_tpu_torch.convert import qc_from_arrays

    wide = qc_from_arrays(np.zeros((1, 2), dtype=np.int32),
                          qc_stream.MAX_LIFTING * 2)
    with pytest.raises(NotImplementedError, match="lifting size"):
        qc_stream._check_limits(wide)
    many = qc_from_arrays(
        np.zeros((2, qc_stream.MAX_BLOCK_EDGES // 2 + 1), dtype=np.int32), 128)
    with pytest.raises(NotImplementedError, match="block edges"):
        qc_stream._check_limits(many)


@pytest.mark.parametrize("path", QC_ASSETS, ids=[p.stem for p in QC_ASSETS])
def test_gate_equals_jax_qc_stream_feasible(path):
    from qkd_ldpc_v_tpu.models.qc import read_qc_matrix as jread
    from qkd_ldpc_v_tpu.ops.pallas_qc_stream import qc_stream_feasible

    assert engines.qc_stream_feasible(read_qc_matrix(path)) \
        == qc_stream_feasible(jread(path))


def _cfg(**tpu):
    from qkd_ldpc_v_tpu.config import Config

    return config_from_dict(dataclasses.asdict(Config(use_pallas=True, **tpu)))


@pytest.mark.parametrize("path", QC_ASSETS, ids=[p.stem for p in QC_ASSETS])
def test_qc_kernel_routing_on_every_qc_asset(path, monkeypatch):
    """fused_qc for the 1k and 10k QC assets, qc_stream for every N=102400
    one, in both schedules, decided without building anything."""

    def no_build():
        raise AssertionError("routing must not build the kernels")

    monkeypatch.setattr(kernels, "library", no_build)
    matrix = tread_matrix(path, TFormat.QC)
    want = "qc_stream" if matrix.num_bit_nodes == 102400 else "fused_qc"
    for schedule in ("flooding", "layered"):
        layered = schedule == "layered"
        engine = tsim.select_engine(matrix, _cfg(schedule=schedule))
        assert engine == "qc"
        assert tsim.qc_kernel(matrix.qc, engine, layered) == want
        assert fused_qc.fused_qc_fits(matrix.qc, layered) == (want == "fused_qc")
        forced = tsim.select_engine(
            matrix, _cfg(schedule=schedule, force_engine="qc_stream"))
        assert forced == "qc_stream"
        assert tsim.qc_kernel(matrix.qc, forced, layered) == "qc_stream"
    with pytest.raises(ValueError, match="not a QC engine"):
        tsim.qc_kernel(matrix.qc, "generic", False)


def _jax_key_source(seed):
    import jax
    import jax.numpy as jnp
    from qkd_ldpc_v_tpu.ops import channel as jch

    def source(sim_number, chunk_index, batch, n):
        ka, ke, _ = jch.trial_keys(seed, sim_number, chunk_index)
        alice = np.asarray(jch.generate_keys(ka, batch, n))
        bits = np.asarray(jax.random.bits(ke, (batch, n), jnp.uint32))
        return alice, bits.astype(np.int64)
    return source


QBER = 0.075


def test_run_combination_forced_qc_stream_matches_jax(tmp_path, caplog):
    """force_engine = qc_stream: the port's run equals the JAX package's
    forced streamed run (its Pallas kernel in interpret mode) as a
    SimResult and as CSV bytes, and the kernel choice is logged once."""
    from qkd_ldpc_v_tpu import simulation as jsim
    from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, MatrixFormat
    from qkd_ldpc_v_tpu.config import RQBERRange
    from qkd_ldpc_v_tpu.models.qc import generate_qc_ldpc
    from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams as JParams
    from qkd_ldpc_v_tpu_torch.convert import qc_from_arrays
    from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams as TParams

    jqc = generate_qc_ldpc(8, 4, 128, 3, seed=5)
    jm = jqc.to_hmatrix()
    tm = qc_from_arrays(jqc.shifts, jqc.lifting).to_hmatrix()
    jcfg = Config(trials_number=24, simulation_seed=5,
                  decoding_algorithm=DecodingAlgorithm.NMSA,
                  decoding_alg_max_iterations=30,
                  matrix_format=MatrixFormat.QC,
                  r_qber_ranges=(RQBERRange(0.99, QBER, QBER, 0.01),),
                  batch_size=16, use_pallas=True, schedule="layered",
                  force_engine="qc_stream")
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert jsim.pallas_engine(jm, jcfg) == "qc_stream"
    assert tsim.select_engine(tm, tcfg) == "qc_stream"
    want = jsim.run_combination(
        jm, jsim.SimCombination(QBER, JParams(), jsim.ScalingFactors(0.8)),
        jcfg, sim_number=1)
    qc_stream.reset_counts()
    fused_qc.reset_counts()
    with caplog.at_level(logging.INFO, logger=tsim.__name__):
        got = tsim.run_combination(
            tm, tsim.SimCombination(QBER, TParams(), tsim.ScalingFactors(0.8)),
            tcfg, 1, "cpu", key_source=_jax_key_source(jcfg.simulation_seed))
    assert [r.getMessage() for r in caplog.records if r.name == tsim.__name__] \
        == ["engine qc_stream: the qc_stream kernel (N=1024, Z=128)"]
    assert qc_stream.counts() == (0, 0) and fused_qc.counts() == (0, 0)
    assert 0.0 < got.ratio_trials_success_ldpc < 1.0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    jpath = jsim.write_file([want], jcfg, "00h-00m-01s", tmp_path / "jax")
    tpath = tsim.write_file([got], tcfg, "00h-00m-01s", tmp_path / "torch")
    assert tpath.name == jpath.name
    assert tpath.read_bytes() == jpath.read_bytes()


# ---------------------------------------------------------------------------
# On the card: kernel == plain and == the fused kernel, exactly.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the streamed QC kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _card_keys(n, batch, num_errors, seed, device):
    from qkd_ldpc_v_tpu_torch.ops.channel import inject_errors

    gen = np.random.default_rng(seed)
    alice = torch.tensor(gen.integers(0, 2, (batch, n)), dtype=torch.int8,
                         device=device)
    bits = torch.tensor(gen.integers(0, 2**32, (batch, n)), dtype=torch.int64,
                        device=device)
    return alice, inject_errors(bits, alice, num_errors, wide=True)


FLAGSHIP = QC_DIR / "(N=102400,M=30720,R=0.70,CW=3,Z=2048,SEED=56).mtrx"
HEADLINE = QC_DIR / "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx"
QC1K = QC_DIR / "(N=1024,M=384,R=0.62,CW=3,Z=128,SEED=33).mtrx"
ALGS_BY_NAME = {name: (f1, f2) for name, f1, f2 in ALGS}


@pytest.mark.cuda
def test_limit_constants_equal_the_library(cuda_device):
    lib = kernels.library()
    assert (fused_qc.MAX_LIFTING, fused_qc.MAX_BLOCK_EDGES,
            fused_qc.MAX_BASE_CHECKS) == (lib.fused_qc_max_lifting(),
                                          lib.fused_qc_max_block_edges(),
                                          lib.fused_qc_max_base_checks())
    kernels.library()
    assert (qc_stream.MAX_LIFTING, qc_stream.MAX_BLOCK_EDGES,
            qc_stream.MAX_BASE_CHECKS) == (lib.qc_stream_max_lifting(),
                                           lib.qc_stream_max_block_edges(),
                                           lib.qc_stream_max_base_checks())
    assert max(qc_stream.CLUSTER_SIZES) == lib.qc_stream_max_cluster()
    assert qc_stream.MAX_BASE_BITS == lib.qc_stream_max_base_bits()
    # The Python plan mirrors the kernel's layout on every QC asset.
    for path in QC_ASSETS:
        code = read_qc_matrix(path)
        mb, nb, z, num_be, max_deg = launch.shape_of(code)
        for cluster in qc_stream.CLUSTER_SIZES:
            assert qc_stream.threads_for(z, cluster) == \
                lib.qc_stream_threads(z, cluster)
            for mode, code_of in qc_stream._MODES.items():
                assert qc_stream.shared_bytes(
                    mb, nb, z, num_be, cluster, mode) == \
                    lib.qc_stream_shared_bytes(mb, nb, z, num_be, cluster,
                                               code_of)
        for flags, spa in ((0, False), (8, True)):
            assert qc_stream.scratch_words(mb, z, num_be, max_deg, spa) == \
                lib.qc_stream_scratch_words(mb, z, num_be, max_deg, flags)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("alg,f1,f2", ALGS)
def test_kernel_matches_plain_on_card(cuda_device, alg, f1, f2, schedule):
    # The flagship near its waterfall (some frames fail) and the headline
    # code, where the fused kernel must give the same results.
    for path, qber, frames in ((FLAGSHIP, 0.037, 16), (HEADLINE, 0.036, 64)):
        code = read_qc_matrix(path)
        n = code.num_bit_nodes
        ne = int(n * qber)
        alice, bob = _card_keys(n, frames, ne, seed=7, device=cuda_device)
        lp = log_ratio(ne / n)
        trial = qc_stream.make_qc_stream_trial(code, TAlg[alg], CAP, False,
                                               schedule)
        got = trial(alice, bob, lp, f1, f2, 0.0)
        want = trial.plain(alice, bob, lp, f1, f2, 0.0)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
        if n == 10240:
            fused = fused_qc.make_fused_qc_trial(code, TAlg[alg], CAP, False,
                                                 schedule)(alice, bob, lp, f1,
                                                           f2, 0.0)
            for g, w in zip(got, fused):
                assert torch.equal(g.cpu(), w.cpu())
        lpt = torch.tensor(lp, device=cuda_device)
        llr = torch.where(bob == 1, -lpt, lpt)
        syn = qc_syndrome(code, alice)
        dec = qc_stream.make_qc_stream_decoder(code, TAlg[alg], CAP, True,
                                               schedule)
        got = dec(llr, syn, f1, f2, 2.5)
        want = dec.plain(llr, syn, f1, f2, 2.5)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("alg,f1,f2", ALGS)
def test_mc_kernel_matches_plain_on_card(cuda_device, alg, f1, f2, schedule):
    """The mc mode against ``mc_channel`` and the plain trial on the
    flagship near its waterfall (a batch from frame 100 of the chunk) and
    on the headline code, where the fused kernel's mc mode must give the
    same results."""
    from qkd_ldpc_v_tpu_torch.simulation import chunk_seed

    seed = chunk_seed(7, 1, 2)
    for path, qber, frames in ((FLAGSHIP, 0.037, 16), (HEADLINE, 0.036, 64)):
        code = read_qc_matrix(path)
        n = code.num_bit_nodes
        ne = int(n * qber)
        args = (seed, 100, frames, ne, log_ratio(ne / n), f1, f2, 0.0)
        mc = qc_stream.make_qc_stream_montecarlo(code, TAlg[alg], CAP, False,
                                                 schedule)
        got = mc(*args, device=cuda_device)
        want = mc.plain(*args, device=cuda_device)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
        if n == 10240:
            fused = fused_qc.make_fused_qc_montecarlo(
                code, TAlg[alg], CAP, False, schedule)(*args,
                                                       device=cuda_device)
            for g, w in zip(got, fused):
                assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["SPA", "SPA_APPROX"])
def test_spa_kernel_matches_plain_on_card(cuda_device, alg):
    """The SPA pair (flooding) in the trial, decode and mc modes against the
    plain versions on the flagship and the headline code, where the fused
    kernel must give the same results. The decode mode takes the clamp
    below the channel's |LLR| and forced LLRs: a zero (the 0/0 ratio) in
    frame 0 and eight times the channel's magnitude in frame 1."""
    from qkd_ldpc_v_tpu_torch.simulation import chunk_seed

    for path, frames in ((FLAGSHIP, 16), (HEADLINE, 64)):
        code = read_qc_matrix(path)
        n = code.num_bit_nodes
        ne = int(n * 0.03)
        lp = log_ratio(ne / n)
        alice, bob = _card_keys(n, frames, ne, seed=7, device=cuda_device)
        trial = qc_stream.make_qc_stream_trial(code, TAlg[alg], CAP, False)
        got = trial(alice, bob, lp, 1.0, 1.0, 0.0)
        want = trial.plain(alice, bob, lp, 1.0, 1.0, 0.0)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
        lpt = torch.tensor(lp, device=cuda_device)
        llr = torch.where(bob == 1, -lpt, lpt)
        llr[0, 0] = 0.0
        llr[1] *= 8.0
        syn = qc_syndrome(code, alice)
        dec = qc_stream.make_qc_stream_decoder(code, TAlg[alg], CAP, True)
        got = dec(llr, syn, 1.0, 1.0, 2.5)
        want = dec.plain(llr, syn, 1.0, 1.0, 2.5)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
        args = (chunk_seed(7, 1, 2), 100, frames, ne, lp, 1.0, 1.0, 0.0)
        mc = qc_stream.make_qc_stream_montecarlo(code, TAlg[alg], CAP, False)
        got = mc(*args, device=cuda_device)
        want = mc.plain(*args, device=cuda_device)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
        if n == 10240:
            fused = fused_qc.make_fused_qc_montecarlo(
                code, TAlg[alg], CAP, False)(*args, device=cuda_device)
            for g, w in zip(got, fused):
                assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [4, 16])
@pytest.mark.parametrize("schedule,alg", [("flooding", "NMSA"),
                                          ("layered", "AOMSA"),
                                          ("flooding", "ANMSA"),
                                          ("flooding", "SPA")])
def test_forced_cluster_matches_plain_on_card(cuda_device, cluster, schedule,
                                              alg):
    """A plan forced to 4 or 16 CTAs per cluster (every committed asset
    takes 1 or 2): trial, decode and mc modes equal the plain versions, on
    the flagship near its waterfall (at 16 CTAs of 128 threads, 6400 bits a
    share, so some base columns span two CTAs) and, at 4 CTAs, on the 1k
    QC code (8 base columns: a cluster has at most nb CTAs)."""
    from qkd_ldpc_v_tpu_torch.simulation import chunk_seed

    def forced(code, flags, device):
        return qc_stream._Launch(code, flags, device, cluster=cluster)

    plans = launch.cached_plans(forced)
    f1, f2 = dict(ALGS_BY_NAME, SPA=(1.0, 1.0))[alg]
    algorithm = TAlg[alg]
    codes = ((FLAGSHIP, 0.037, 12), (QC1K, 0.06, 40))
    for path, qber, frames in codes[:1] if cluster == 16 else codes:
        code = read_qc_matrix(path)
        n = code.num_bit_nodes
        ne = int(n * qber)
        lp = log_ratio(ne / n)
        trial = launch.qc_trial("streamed QC", qc_stream.COUNTS, plans,
                                  code, algorithm, CAP, False, schedule)
        alice, bob = _card_keys(n, frames, ne, seed=11, device=cuda_device)
        got = trial(alice, bob, lp, f1, f2, 0.0)
        want = trial.plain(alice, bob, lp, f1, f2, 0.0)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
        flags = launch.kernel_flags(algorithm, schedule == "layered")
        assert plans(code, flags, cuda_device).plans["trial"].cluster \
            == cluster
        lpt = torch.tensor(lp, device=cuda_device)
        llr = torch.where(bob == 1, -lpt, lpt)
        syn = qc_syndrome(code, alice)
        dec = launch.qc_decoder("streamed QC", qc_stream.COUNTS, plans,
                                  code, algorithm, CAP, True, schedule)
        got = dec(llr, syn, f1, f2, 2.5)
        want = dec.plain(llr, syn, f1, f2, 2.5)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
        mc = launch.qc_montecarlo("streamed QC", qc_stream.COUNTS, plans,
                                    code, algorithm, CAP, False, schedule)
        mc_args = (chunk_seed(5, 1, 0), 7, frames, ne, lp, f1, f2, 0.0)
        got = mc(*mc_args, device=cuda_device)
        want = mc.plain(*mc_args, device=cuda_device)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
