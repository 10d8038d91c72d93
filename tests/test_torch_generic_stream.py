"""Streamed generic wrappers (qkd_ldpc_v_tpu_torch/ops/generic_stream.py)
and the sweep's ``stream`` engine.

On the CPU the wrappers run their plain torch versions (the f32 generic
torch decoder, ``calculate_syndrome`` and the key compare). On the N=288
irregular code of tests/test_pallas_stream.py they must equal the JAX f32
XLA decoder exactly, and hold to the JAX streamed Pallas kernel (interpret
mode, f32 transport, ``cap_rows=8``, ``batch_tile=4``) at the parity level
the JAX package's own test of that kernel holds: NMSA and OMSA with equal
convergence, iterations and converged decisions; ANMSA and AOMSA with equal
convergence and iterations within 4 (the TPU kernel tests the adaptive pair
half an iteration early), decisions equal where both stop at the same
iteration. Both modes, the message clamp off and on.

The gate equals the JAX package's ``stream_feasible`` on every committed
asset; the sweep's ``stream`` engine equals JAX's XLA run as a SimResult
and as CSV bytes on an N=22000 code inside that gate, and JAX's forced
streamed run (f32 transport) on the N=288 code. JAX's default bf16x2
transport is only statistically equal to the reference (ROADMAP.md §3):
at an easy operating point every frame still decodes to Alice's key, with
iteration counts within 4 of the port's.

Tests marked ``cuda`` compare the CUDA kernel with its plain version on the
card and the shared-memory rule with the built library; they skip without a
CUDA device. They import no JAX, so on a machine without JAX they run with
the conftest left out:

    python -m pytest tests/test_torch_generic_stream.py -m cuda --noconftest -q
"""

import dataclasses
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu_torch import engines, kernels
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.config import MatrixFormat as TFormat
from qkd_ldpc_v_tpu_torch.convert import config_from_dict
from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc
from qkd_ldpc_v_tpu_torch.models.hmatrix import from_dense
from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix as tread_matrix
from qkd_ldpc_v_tpu_torch.models.layout import layout_for
from qkd_ldpc_v_tpu_torch.ops import fused_generic, generic_stream, launch
from qkd_ldpc_v_tpu_torch.ops.channel import (
    calculate_syndrome,
    inject_errors,
    log_ratio,
)
from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams as TParams

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ALIST = REPO / "sparse_matrices" / "matrices_alist"
CAP = 30
CAP_ROWS = 8
THRESHOLD = 6.0
# The JAX streamed kernels are built once per algorithm with the clamp on;
# a clamp at the largest float32 leaves every finite message as it is.
NO_CLAMP = float(np.finfo(np.float32).max)
ALGS = [
    ("NMSA", 0.8, 1.0),
    ("OMSA", 0.3, 1.0),
    ("ANMSA", 0.88, 0.5),
    ("AOMSA", 0.3, 0.6),
]
FORMATS = ("ALIST", "SPARSE_1", "SPARSE_2", "UNCOMPRESSED", "QC")
_ASSETS = sorted(
    (path, fmt)
    for fmt in FORMATS
    for path in (REPO / "sparse_matrices" / TFormat[fmt].directory_name).glob("*.mtrx")
)


def irregular_dense():
    """tests/test_pallas_stream.py::irregular: N=288, M=144, column weights
    2..5, mixed row weights."""
    rng = np.random.default_rng(11)
    n, m = 288, 144
    dense = np.zeros((m, n), dtype=np.int8)
    for col in range(n):
        dense[rng.choice(m, size=2 + (col % 4), replace=False), col] = 1
    for row in range(m):
        if dense[row].sum() == 0:
            dense[row, rng.integers(0, n)] = 1
    return dense


def stream_sized_code():
    """tests/test_torch_simulation.py::_stream_sized_code: N=22000, column
    weight 3, 66000 edges, inside the JAX stream gate and outside the
    generic one."""
    return generate_regular_ldpc(num_bits=22000, num_checks=11000,
                                 column_weight=3, seed=5)


def mixed_degree_code():
    """N=3000, M=1600: checks of 3 (100), 6 (500), 9 (400), 10 (400), 12
    (100) and 30 (100) edges, each on the bits of least weight so far
    (column weights 5 and 6). One CTA holds every group size. Its checks
    fill the cluster kernel's register runs of 6, 10 and 12 slots exactly,
    leave the last slot of the 10-slot run unused (9 edges), leave three
    slots of the 6-slot run unused (3 edges: two read slot 0's total again,
    the last loads nothing), and take the two-pass path (30 edges)."""
    rng = np.random.default_rng(21)
    degrees = ([3] * 100 + [6] * 500 + [9] * 400 + [10] * 400 + [12] * 100
               + [30] * 100)
    n = 3000
    dense = np.zeros((len(degrees), n), dtype=np.int8)
    weight = np.zeros(n, dtype=np.int64)
    for row in rng.permutation(len(degrees)):
        order = rng.permutation(n)
        pick = order[np.argsort(weight[order], kind="stable")[:degrees[row]]]
        dense[row, pick] = 1
        weight[pick] += 1
    return from_dense(dense)


def _jax_matrix(matrix):
    from qkd_ldpc_v_tpu.models.hmatrix import HMatrix as JHMatrix

    return JHMatrix([np.asarray(c) for c in matrix.bit_nodes],
                    [np.asarray(r) for r in matrix.check_nodes],
                    matrix.is_regular)


@pytest.fixture(scope="module")
def irregular():
    return from_dense(irregular_dense())


def channel_case(matrix, batch, qber, seed):
    """tests/test_pallas_stream.py::channel_case, as numpy arrays: Alice's
    and Bob's keys, the LLRs and Alice's syndrome. The LLR magnitude is
    ``channel.log_ratio``'s, the value JAX's trial forms from the QBER."""
    rng = np.random.default_rng(seed)
    n = matrix.num_bit_nodes
    alice = rng.integers(0, 2, (batch, n)).astype(np.int8)
    bob = alice ^ (rng.random((batch, n)) < qber).astype(np.int8)
    log_p = np.float32(log_ratio(qber))
    llr = np.where(bob == 1, -log_p, log_p).astype(np.float32)
    syn = calculate_syndrome(layout_for(matrix), torch.tensor(alice)).numpy()
    return alice, bob, llr, syn


@pytest.fixture(scope="module")
def channel(irregular):
    """tests/test_pallas_stream.py's case for the JAX streamed kernel:
    8 frames at QBER 0.02 (seed 3)."""
    return channel_case(irregular, 8, 0.02, 3)


def _jax_decoder(matrix, alg, use_thr, transport="f32"):
    """JAX's streamed decode kernel, interpret mode."""
    import jax
    from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
    from qkd_ldpc_v_tpu.ops.pallas_stream import make_pallas_stream_decoder

    return jax.jit(make_pallas_stream_decoder(
        _jax_matrix(matrix), JAlg[alg], CAP, use_thr, batch_tile=4,
        interpret=True, cap_rows=CAP_ROWS, transport=transport))


@pytest.fixture(scope="module")
def jax_stream(irregular):
    """alg -> JAX's streamed (decode, trial) kernels on the N=288 code, f32
    transport, the clamp on (``NO_CLAMP`` turns it off), built at first
    use."""
    import jax
    from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
    from qkd_ldpc_v_tpu.ops.pallas_stream import make_pallas_stream_trial

    built = {}

    def get(alg):
        if alg not in built:
            trial = jax.jit(make_pallas_stream_trial(
                _jax_matrix(irregular), JAlg[alg], CAP, True, batch_tile=4,
                interpret=True, cap_rows=CAP_ROWS, transport="f32"))
            built[alg] = (_jax_decoder(irregular, alg, True), trial)
        return built[alg]

    return get


def _jax_xla(matrix, alg, use_thr, llr, syn, f1, f2, thr):
    import jax
    import jax.numpy as jnp
    from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
    from qkd_ldpc_v_tpu.models.layout import compile_layout
    from qkd_ldpc_v_tpu.ops.decoders import make_decoder

    dec = make_decoder(compile_layout(_jax_matrix(matrix)), JAlg[alg], CAP,
                       use_thr, jnp.float32)
    return jax.device_get(dec(llr, syn, f1, f2, thr))


def _np(res):
    return (np.asarray(res.decision), np.asarray(res.syndromes_match),
            np.asarray(res.iterations))


def _assert_at_stream_parity(alg, got, want):
    """``got`` (decisions, conv, iterations) of the port against JAX's
    streamed kernel, at that kernel's own test's parity level."""
    dec, conv, iters = got
    jdec, jconv, jiters = want
    np.testing.assert_array_equal(conv, jconv)
    if not TAlg[alg].is_adaptive:
        np.testing.assert_array_equal(iters, jiters)
        np.testing.assert_array_equal(dec[conv], jdec[conv])
        return
    assert np.abs(iters - jiters).max() <= 4
    same = conv & jconv & (iters == jiters)
    np.testing.assert_array_equal(dec[same], jdec[same])


@pytest.mark.parametrize("use_thr", [False, True])
@pytest.mark.parametrize("alg,f1,f2", ALGS)
def test_cpu_path_matches_jax_xla_and_pallas_stream(irregular, channel,
                                                    jax_stream, alg, f1, f2,
                                                    use_thr):
    """Decode and trial on the CPU: exactly JAX's f32 XLA decoder (plus the
    syndrome and the key compare), and JAX's streamed kernel at its parity
    level."""
    import jax

    alice, bob, llr, syn = channel
    thr = THRESHOLD if use_thr else 0.0
    generic_stream.reset_counts()
    dec = generic_stream.make_generic_stream_decoder(irregular, TAlg[alg],
                                                     CAP, use_thr)
    got = _np(dec(torch.tensor(llr), torch.tensor(syn), f1, f2, thr))
    xla = _np(_jax_xla(irregular, alg, use_thr, llr, syn, f1, f2, thr))
    for g, w in zip(got, xla):
        np.testing.assert_array_equal(g, w)
    assert got[1].all()

    jdec, jtrial = jax_stream(alg)
    jthr = THRESHOLD if use_thr else NO_CLAMP
    _assert_at_stream_parity(alg, got, _np(jax.device_get(
        jdec(llr, syn, f1, f2, jthr))))

    trial = generic_stream.make_generic_stream_trial(irregular, TAlg[alg],
                                                     CAP, use_thr)
    conv, keys, iters = (t.numpy() for t in trial(
        torch.tensor(alice), torch.tensor(bob), log_ratio(0.02), f1, f2, thr))
    np.testing.assert_array_equal(conv, xla[1])
    np.testing.assert_array_equal(iters, xla[2])
    np.testing.assert_array_equal(keys, (xla[0] == alice).all(axis=1))
    jconv, jkeys, jiters = (np.asarray(t) for t in jax.device_get(
        jtrial(alice, bob, 0.02, f1, f2, jthr)))
    np.testing.assert_array_equal(conv, jconv)
    np.testing.assert_array_equal(keys[conv], jkeys[conv])
    if TAlg[alg].is_adaptive:
        assert np.abs(iters - jiters).max() <= 4
    else:
        np.testing.assert_array_equal(iters, jiters)
    assert generic_stream.counts() == (0, 0, 0, 0)


def test_unconverged_frames_match_jax_xla(irregular):
    """A hard channel (QBER 0.09, cap 6) where frames run to the cap: the
    whole decision matrix equals the XLA decoder's, converged or not."""
    alice, bob, llr, syn = channel_case(irregular, 8, 0.09, 37)
    got = generic_stream.make_generic_stream_decoder(
        irregular, TAlg.NMSA, 6, False)(torch.tensor(llr), torch.tensor(syn),
                                        0.8, 1.0, 0.0)
    import jax
    import jax.numpy as jnp
    from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
    from qkd_ldpc_v_tpu.models.layout import compile_layout
    from qkd_ldpc_v_tpu.ops.decoders import make_decoder

    want = jax.device_get(make_decoder(
        compile_layout(_jax_matrix(irregular)), JAlg.NMSA, 6, False,
        jnp.float32)(llr, syn, 0.8, 1.0, 0.0))
    assert not np.asarray(want.syndromes_match).all()
    for g, w in zip(_np(got), _np(want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("alg,f1,f2", [ALGS[0], ALGS[3]])
def test_jax_bf16x2_transport_is_only_statistically_equal(irregular, alg, f1,
                                                          f2):
    """JAX's default transport (bf16x2, messages rounded in flight) at the
    easy point of tests/test_pallas_stream.py::test_bf16x2_transport_decodes
    (QBER 0.02, seed 23): every frame decodes to Alice's key in both
    packages, and JAX's iteration counts lie within 4 of the port's, which
    follows the f32 XLA decoder (ROADMAP.md §3)."""
    import jax

    alice, bob, _, syn = channel_case(irregular, 8, 0.02, 23)
    # That test's LLRs: the magnitude's double-precision log, then float32
    # (the adaptive pair's iteration counts move with its last bit).
    log_p = float(np.log(0.98 / 0.02))
    llr = np.where(bob == 1, -log_p, log_p).astype(np.float32)
    got = generic_stream.make_generic_stream_decoder(
        irregular, TAlg[alg], CAP, False)(torch.tensor(llr),
                                          torch.tensor(syn), f1, f2, 0.0)
    want = jax.device_get(_jax_decoder(irregular, alg, False, "bf16x2")(
        llr, syn, f1, f2, 0.0))
    assert bool(got.syndromes_match.all())
    assert np.asarray(want.syndromes_match).all()
    np.testing.assert_array_equal(got.decision.numpy(), alice)
    np.testing.assert_array_equal(np.asarray(want.decision), alice)
    assert np.abs(got.iterations.numpy() - np.asarray(want.iterations)).max() <= 4


@pytest.mark.parametrize("path,fmt", _ASSETS,
                         ids=[f"{f}-{p.stem}" for p, f in _ASSETS])
def test_gate_equals_jax_stream_feasible(path, fmt):
    from qkd_ldpc_v_tpu.config import MatrixFormat as JFormat
    from qkd_ldpc_v_tpu.models.hmatrix import read_matrix as jread_matrix
    from qkd_ldpc_v_tpu.ops.pallas_stream import stream_feasible

    assert engines.stream_feasible(tread_matrix(path, TFormat[fmt])) \
        == stream_feasible(jread_matrix(path, JFormat[fmt]))


def test_gate_on_the_test_codes(irregular):
    from qkd_ldpc_v_tpu.ops.pallas_stream import stream_feasible

    codes = [irregular, stream_sized_code()]
    verdicts = [engines.stream_feasible(c) for c in codes]
    assert verdicts == [stream_feasible(_jax_matrix(c)) for c in codes]
    assert verdicts == [False, True]
    assert not fused_generic.generic_feasible(codes[1])


def _jax_cfg(**kw):
    from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, MatrixFormat
    from qkd_ldpc_v_tpu.config import RQBERRange

    qber = kw.pop("qber")
    base = dict(trials_number=24, simulation_seed=5,
                decoding_algorithm=DecodingAlgorithm.NMSA,
                decoding_alg_max_iterations=CAP,
                matrix_format=MatrixFormat.ALIST,
                r_qber_ranges=(RQBERRange(0.99, qber, qber, 0.01),),
                batch_size=16)  # two chunks, the second one short
    base.update(kw)
    return Config(**base)


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


def _run_both(jm, tm, jcfg, tcfg, qber, tmp_path):
    """(JAX SimResult, port SimResult) of one combination with JAX's keys,
    and their CSVs' equality."""
    from qkd_ldpc_v_tpu import simulation as jsim
    from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams as JParams

    want = jsim.run_combination(
        jm, jsim.SimCombination(qber, JParams(), jsim.ScalingFactors(0.8)),
        jcfg, sim_number=1)
    generic_stream.reset_counts()
    got = tsim.run_combination(
        tm, tsim.SimCombination(qber, TParams(), tsim.ScalingFactors(0.8)),
        tcfg, 1, "cpu", key_source=_jax_key_source(jcfg.simulation_seed))
    assert generic_stream.counts() == (0, 0, 0, 0)
    jpath = jsim.write_file([want], jcfg, "00h-00m-01s", tmp_path / "jax")
    tpath = tsim.write_file([got], tcfg, "00h-00m-01s", tmp_path / "torch")
    assert tpath.name == jpath.name
    assert tpath.read_bytes() == jpath.read_bytes()
    return want, got


def test_stream_engine_run_matches_jax_xla(tmp_path):
    """The N=22000 code through the port's ``stream`` engine against JAX's
    ``use_pallas = false`` run: equal SimResult and CSV bytes."""
    from qkd_ldpc_v_tpu import simulation as jsim

    tm = stream_sized_code()
    jm = _jax_matrix(tm)
    qber = 0.075
    jcfg = _jax_cfg(qber=qber, use_pallas=False)
    tcfg = config_from_dict(dataclasses.asdict(_jax_cfg(qber=qber,
                                                        use_pallas=True)))
    assert jsim.pallas_engine(jm, _jax_cfg(qber=qber, use_pallas=True)) \
        == "stream"
    assert tsim.select_engine(tm, tcfg) == "stream"
    want, got = _run_both(jm, tm, jcfg, tcfg, qber, tmp_path)
    assert got.ratio_trials_success_ldpc > 0.0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_forced_stream_run_matches_jax_stream(monkeypatch, tmp_path):
    """Both packages' gates patched to ``stream`` on the N=288 code, as
    the JAX package's own sweep test of that engine forces it
    (tests/test_pallas_stream.py:454): the port's NMSA statistics equal
    JAX's streamed run with f32 transport, and the port's trial is the
    streamed one. The code is read afresh, so that no verdict kept for the
    module's copy hides the patched gates."""
    from qkd_ldpc_v_tpu import simulation as jsim
    from qkd_ldpc_v_tpu.ops import pallas_generic, pallas_stream

    monkeypatch.setattr(pallas_generic, "generic_plan_feasible", lambda m: False)
    monkeypatch.setattr(pallas_stream, "stream_feasible", lambda m: True)
    orig = pallas_stream.make_pallas_stream_trial
    called = []
    monkeypatch.setattr(
        pallas_stream, "make_pallas_stream_trial",
        lambda *a, **k: called.append(1) or orig(
            *a, cap_rows=CAP_ROWS, transport="f32", **k))
    monkeypatch.setattr(engines, "generic_feasible", lambda m: False)
    monkeypatch.setattr(engines, "stream_feasible", lambda m: True)

    qber = 0.07
    tm = from_dense(irregular_dense())
    jm = _jax_matrix(tm)
    jcfg = _jax_cfg(qber=qber, use_pallas=True)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert jsim.pallas_engine(jm, jcfg) == "stream"
    assert tsim.select_engine(tm, tcfg) == "stream"
    want, got = _run_both(jm, tm, jcfg, tcfg, qber, tmp_path)
    assert called and generic_stream.COUNTS.plain("trial") > 0
    assert 0.0 < got.ratio_trials_success_ldpc < 1.0
    assert got.ratio_trials_success_ldpc == want.ratio_trials_success_ldpc
    assert got.iter_success_mean == want.iter_success_mean
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_forced_stream_on_the_10k_alist_code_and_spa(irregular):
    """``force_engine = stream`` sends a code inside the generic gate to the
    streamed kernel where JAX's gate admits it; SPA runs on the stream
    engine too."""
    from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm

    alist = tread_matrix(ALIST / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx",
                         TFormat.ALIST)
    forced = config_from_dict(dataclasses.asdict(
        Config(use_pallas=True, force_engine="stream")))
    assert tsim.select_engine(alist, forced) == "stream"
    spa = config_from_dict(dataclasses.asdict(
        Config(use_pallas=True, decoding_algorithm=DecodingAlgorithm.SPA,
               force_engine="stream")))
    assert tsim.select_engine(alist, spa) == "stream"
    with pytest.raises(ValueError, match="force_engine"):
        tsim.select_engine(irregular, forced)


def test_wrappers_check_inputs(irregular, channel):
    alice, bob, llr, syn = (torch.tensor(x) for x in channel)
    trial = generic_stream.make_generic_stream_trial(irregular, TAlg.NMSA,
                                                     CAP, False)
    with pytest.raises(TypeError):
        trial(alice.to(torch.int32), bob, 3.0)
    with pytest.raises(ValueError):
        trial(alice[:, :100], bob[:, :100], 3.0)
    with pytest.raises(ValueError, match="contiguous"):
        trial(alice.t().contiguous().t(), bob, 3.0)
    dec = generic_stream.make_generic_stream_decoder(irregular, TAlg.NMSA,
                                                     CAP, False)
    with pytest.raises(ValueError):
        dec(llr, syn[:, :10])
    with pytest.raises(TypeError):
        dec(llr.double(), syn)
    # The SPA pair builds in both modes and runs its plain version on the
    # CPU, which equals the fused generic wrapper's.
    for alg in (TAlg.SPA, TAlg.SPA_APPROX):
        spa = generic_stream.make_generic_stream_decoder(irregular, alg, CAP,
                                                         False)
        want = fused_generic.make_fused_generic_decoder(irregular, alg, CAP,
                                                        False)(llr, syn)
        for g, w in zip(spa(llr, syn), want):
            assert torch.equal(g, w)
        generic_stream.make_generic_stream_trial(irregular, alg, CAP, False)


def test_non_cpu_tensors_never_take_the_plain_path(irregular):
    """A tensor on a device other than the CPU launches the kernel or
    raises; meta tensors have no kernel, so both wrappers raise and neither
    counter moves."""
    n, m = irregular.num_bit_nodes, irregular.num_check_nodes
    keys = torch.empty((2, n), dtype=torch.int8, device="meta")
    generic_stream.reset_counts()
    with pytest.raises(NotImplementedError, match="meta"):
        generic_stream.make_generic_stream_trial(irregular, TAlg.NMSA, CAP,
                                                 False)(keys, keys, 3.0)
    with pytest.raises(NotImplementedError, match="meta"):
        generic_stream.make_generic_stream_decoder(irregular, TAlg.NMSA, CAP,
                                                   False)(
            torch.empty((2, n), device="meta"),
            torch.empty((2, m), dtype=torch.int8, device="meta"))
    assert generic_stream.counts() == (0, 0, 0, 0)


@pytest.mark.parametrize("n,m,fits", [
    (102400, 31744, True),    # the 100k alist code: 134,144 bytes
    (150000, 45000, True),
    (200000, 60000, False),   # N=200k at rate 0.7
])
def test_shared_memory_rule(n, m, fits):
    """A group's bit-packed decisions and syndrome (one byte per node at
    F=8) must fit in a block's shared memory; beyond it the launch plan
    raises, naming N and M, before anything is built."""
    assert generic_stream.shared_bytes(n, m) == -(-(n + m) // 16) * 16
    if fits:
        generic_stream.check_shared_memory(n, m)
        return
    with pytest.raises(NotImplementedError, match=f"N={n}, M={m}"):
        generic_stream.check_shared_memory(n, m)


# The 100k alist code's shape, for the launch-plan arithmetic.
N100K, M100K, E100K = 102400, 31744, 307200
# Bytes of one block's scratch slice at N100K (csrc/generic_stream.cu::
# slice_of): the messages 4*E*F, then Bob's and Alice's planes (F/8 bytes
# per bit each, trial) or the LLR plane 4*N*F (decode), then the syndrome
# plane (F/8 bytes per check) at F=16; every part starts at a 256-byte
# boundary (all these sizes already do).
SLICE100K = {
    (8, True): 4 * E100K * 8 + 2 * N100K,                    # 10,035,200
    (8, False): 4 * E100K * 8 + 4 * N100K * 8,               # 13,107,200
    (16, True): 4 * E100K * 16 + 4 * N100K + 2 * M100K,      # 20,133,888
    (16, False): 4 * E100K * 16 + 4 * N100K * 16 + 2 * M100K,
}
# Resident blocks of each group size on an H100 (one per SM).
H100_RESIDENT = {8: 132, 16: 132}


@pytest.mark.parametrize("case", [
    # (what, arguments, expected)
    ("shared", (N100K, M100K, 8), 134144),     # N + M bytes at F=8
    ("shared", (N100K, M100K, 16), 204800),    # 2N: the syndrome leaves
    ("shared", (288, 144, 8), 432),
    ("shared", (288, 145, 8), 448),            # rounded up to 16
    ("launch", (1, 8, True), (1, 1, SLICE100K[8, True])),
    ("launch", (130, 8, True), (17, 17, 17 * SLICE100K[8, True])),
    ("launch", (4096, 8, True), (512, 132, 132 * SLICE100K[8, True])),
    ("launch", (4096, 8, False), (512, 132, 132 * SLICE100K[8, False])),
    ("launch", (1, 16, True), (1, 1, SLICE100K[16, True])),
    ("launch", (130, 16, False), (9, 9, 9 * SLICE100K[16, False])),
    ("launch", (4096, 16, True), (256, 132, 132 * SLICE100K[16, True])),
    ("group", (1, H100_RESIDENT), 8),
    ("group", (130, H100_RESIDENT), 8),
    ("group", (2096, H100_RESIDENT), 8),       # 131 groups of 16
    ("group", (2097, H100_RESIDENT), 16),      # 132: F=16 fills the grid
    ("group", (4096, H100_RESIDENT), 16),      # the main path's chunk
    ("group", (4096, {8: 132}), 8),            # only F=8 fits the code
    ("refuse", (200000, 60000, 8), "N=200000, M=60000"),  # rate 0.7
    ("refuse", (120000, 36000, 16), "N=120000, M=36000"),  # 2N > 227 KB
    ("refuse", (102400, 31744, 64), "group size 64"),
])
def test_launch_plan_arithmetic(case):
    """The launch plan's sizes, computed without a card: a block's shared
    memory, and at the 100k alist code with 132 resident blocks (one per
    SM of an H100) the group count, grid and scratch bytes of a launch and
    the group size a launch takes; codes whose planes do not fit, and group
    sizes without a kernel, are refused before anything is built."""
    what, args, want = case
    if what == "shared":
        assert generic_stream.shared_bytes(*args) == want
    elif what == "group":
        assert generic_stream.group_for(*args) == want
    elif what == "launch":
        batch, group, trial = args
        assert generic_stream.launch_shape(batch, 132, N100K, M100K, E100K,
                                           group, trial) == want
    else:
        n, m, group = args
        with pytest.raises((NotImplementedError, ValueError), match=want):
            generic_stream.check_shared_memory(n, m, group)


@pytest.mark.parametrize("group", generic_stream.GROUPS)
@pytest.mark.parametrize("alg,f1,f2", [ALGS[0], ALGS[3]])
@pytest.mark.parametrize("mode", ["trial", "decode"])
def test_plain_decoder_is_frame_separable(irregular, mode, alg, f1, f2,
                                          group):
    """The premise of the kernel's frame groups: the plain f32 decoder's
    result on a batch equals the concatenation of its results on groups of
    F frames, the ragged last group included, so a group that iterates on
    with some frames frozen changes no frame's outcome. 21 frames of the
    N=288 code in its waterfall (QBER 0.07, cap 12): some converge at once,
    some late, some never."""
    alice, bob, llr, syn = (torch.tensor(x) for x in
                            channel_case(irregular, 21, 0.07, 41))
    if mode == "trial":
        fn = generic_stream.make_generic_stream_trial(
            irregular, TAlg[alg], 12, False, group)
        args = (log_ratio(0.07), f1, f2, 0.0)
        whole = fn(alice, bob, *args)
        parts = [fn(alice[s:s + group].contiguous(),
                    bob[s:s + group].contiguous(), *args)
                 for s in range(0, 21, group)]
    else:
        fn = generic_stream.make_generic_stream_decoder(
            irregular, TAlg[alg], 12, False, group)
        whole = fn(llr, syn, f1, f2, 0.0)
        parts = [fn(llr[s:s + group].contiguous(), syn[s:s + group].contiguous(),
                    f1, f2, 0.0) for s in range(0, 21, group)]
    conv, iters = whole[0 if mode == "trial" else 1], whole[2]
    assert 0 < int(conv.sum()) < 21
    assert len(set(iters.tolist())) > 2
    for w, *ps in zip(whole, *parts):
        assert torch.equal(w, torch.cat(ps))


def test_library_name_follows_headers(tmp_path, monkeypatch):
    """The library is named by a hash of every source and header in csrc/:
    editing a header's bytes (csrc/generic_decode.cuh, which both generic
    kernels include) must give another library, and an untouched copy the
    same one."""
    copy = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, copy)
    before = kernels.library_path()
    monkeypatch.setattr(kernels, "CSRC", copy)
    assert kernels.library_path() == before
    header = copy / "generic_decode.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    edited = kernels.library_path()
    assert edited != before
    (copy / "generic_stream.cu").write_bytes(
        (copy / "generic_stream.cu").read_bytes() + b"\n")
    assert kernels.library_path() not in (before, edited)
    assert [p.name for p in kernels.sources()] == sorted(
        p.name for p in kernels.CSRC.glob("*.cu"))


# ---------------------------------------------------------------------------
# The cluster kernel (csrc/generic_cluster.cu): its plan, its tables, and a
# plain model of its compressed checks and its schedule.
# ---------------------------------------------------------------------------

# One CTA's shared bytes at the 100k alist code for F frames in a cluster of
# 2F CTAs (every CTA holds 51200 / F bits of each of the F frames): the
# degree groups and votes (1168), the syndrome bits of 15872 / F checks for
# each frame (1984), the totals (204800), Alice's and Bob's bits (6400
# each).
SHARED100K = 1168 + 1984 + 4 * 51200 + 2 * 6400


@pytest.mark.parametrize("case", [
    # (mode, algorithm, n, m, e, max check degree, frames asked,
    #  (frames, cluster, shared bytes) or None)
    ("trial", "NMSA", N100K, M100K, E100K, 10, None, (8, 16, SHARED100K)),
    ("trial", "OMSA", N100K, M100K, E100K, 10, None, (8, 16, SHARED100K)),
    ("trial", "ANMSA", N100K, M100K, E100K, 10, None, (8, 16, SHARED100K)),
    ("trial", "AOMSA", N100K, M100K, E100K, 10, None, (8, 16, SHARED100K)),
    ("trial", "NMSA", N100K, M100K, E100K, 10, 1, (1, 2, SHARED100K)),
    ("trial", "NMSA", N100K, M100K, E100K, 10, 4, (4, 8, SHARED100K)),
    ("trial", "SPA", N100K, M100K, E100K, 10, None, None),
    ("trial", "SPA_APPROX", N100K, M100K, E100K, 10, None, None),
    ("decode", "NMSA", N100K, M100K, E100K, 10, None, None),
    ("decode", "AOMSA", N100K, M100K, E100K, 10, None, None),
    # The 10k alist code forced to the stream engine: one CTA holds a group
    # of 4 frames; 8 take two.
    ("trial", "NMSA", 10240, 2841, 40960, 15, None, (4, 1, 176672)),
    ("trial", "NMSA", 10240, 2841, 40960, 15, 8, (8, 2, 176688)),
    # N=800k fits 16 CTAs one frame at a time; N=1M fits no cluster.
    ("trial", "NMSA", 800000, 250000, 2400000, 10, None, (1, 16, 215704)),
    ("trial", "NMSA", 1000000, 310000, 3000000, 10, None, None),
    # A check of 33 edges does not fit a record's two words.
    ("trial", "NMSA", N100K, M100K, E100K, 33, None, None),
])
def test_cluster_plan_rule(case):
    """Which launches take the cluster kernel and its shape, without a card:
    trial mode of the min-sum family on a code whose per-CTA share fits
    some cluster takes it, with the largest group of up to PLAN_FRAMES
    frames that one CTA holds, else PLAN_FRAMES frames (fewer where no
    cluster holds that many) in the smallest cluster that holds them; every
    other launch takes the batch-minor kernel."""
    mode, alg, n, m, e, deg, frames, want = case
    assert generic_stream.PLAN_FRAMES == 8
    plan = generic_stream.cluster_plan(mode, alg in ("SPA", "SPA_APPROX"),
                                       n, m, e, deg, 2, 1, frames)
    if want is None:
        assert plan is None
        return
    assert (plan.frames, plan.cluster, plan.shared_bytes) == want
    assert plan.shared_bytes <= launch.MAX_SHARED_BYTES
    assert plan.threads == 1024
    assert plan.record_bytes == -(-16 * m * plan.frames // 256) * 256
    assert plan.table_bytes == 4 * (4 * 3 + 2 * e + n)
    if n == N100K and plan.frames == 8:
        # 7 clusters in flight keep 31.3 MB in the 50 MB L2.
        assert plan.working_set(7) == 7 * 4063232 + 2867248


def _decoded_tables(layout, cluster):
    """The cluster tables read back as the kernel reads them: per check
    group (start, count, degree, bits [count, degree]) and per bit group
    (start, count, degree, checks, slots [count, degree]), and bit_ext."""
    t = generic_stream.cluster_tables(layout, cluster).astype(np.int64)
    gc, gb = len(layout.check_groups), len(layout.bit_groups)
    share = generic_stream._share(layout.num_bits, cluster)
    groups = t[:4 * (gc + gb)].reshape(-1, 4)
    e = layout.num_edges
    cword = t[4 * (gc + gb):4 * (gc + gb) + e]
    bword = t[4 * (gc + gb) + e:4 * (gc + gb) + 2 * e]
    checks, bits = [], []
    for start, count, deg, off in groups[:gc]:
        w = cword[off:off + count * deg].reshape(deg, count).T
        checks.append((start, count, deg, (w >> 24) * share + (w & 0xffffff)))
    for start, count, deg, off in groups[gc:]:
        w = bword[off:off + count * deg].reshape(deg, count).T
        bits.append((start, count, deg, w >> 5, w & 31))
    return checks, bits, t[4 * (gc + gb) + 2 * e:]


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_cluster_tables_address_every_edge(irregular, cluster):
    """The cluster tables name each check's bits in the layout's slot order
    (through the rank and local index of the CTA that holds them), each
    bit's (check, slot) pairs in its slot order (ascending check index, the
    plain decoder's bit-total order), and the external bit order."""
    for matrix in (irregular, stream_sized_code()):
        layout = layout_for(matrix)
        checks, bits, bit_ext = _decoded_tables(layout, cluster)
        for g, (start, count, deg, b) in zip(layout.check_groups, checks):
            assert (start, count, deg) == (g.node_start, g.count, g.degree)
            np.testing.assert_array_equal(b, g.neighbor)
        edge_bit = np.asarray(layout.check_edge_bit)
        cptr = launch.edge_offsets(layout.check_groups, layout.num_checks)
        for g, (start, count, deg, c, k) in zip(layout.bit_groups, bits):
            assert (start, count, deg) == (g.node_start, g.count, g.degree)
            np.testing.assert_array_equal(c, g.neighbor)
            np.testing.assert_array_equal(
                edge_bit[cptr[c] + k],
                np.repeat(np.arange(start, start + count)[:, None], deg, 1))
        np.testing.assert_array_equal(bit_ext, layout.bit_order)


def _record(msgs, syn, factor, offset, use_thr, thr):
    """Plain model of the kernel's record of min-sum checks (``new_record``
    and ``edge_bits``): from the bit->check messages [c, d, B] in slot
    order, the syndrome bits [c, B] and the factor [c, B], the clamped pair
    (p1, p2) [c, B] and per edge the bits m > 0 (or every sign bit set where
    the threshold is negative) and |m| == min1 [c, d, B]. The chain runs in
    slot order with NaN-keeping min and max; min2 is inf where every |m| of
    a check of two or more edges is inf."""
    f32 = torch.float32
    a = msgs.abs()
    min1 = a[:, 0]
    min2 = torch.full_like(min1, float(np.finfo(np.float32).max))
    neg = torch.zeros_like(syn, dtype=torch.bool)
    for k in range(msgs.shape[1]):
        if k:
            min2 = torch.minimum(min2, torch.maximum(min1, a[:, k]))
            min1 = torch.minimum(min1, a[:, k])
        neg = neg ^ (msgs[:, k] < 0)
    if msgs.shape[1] >= 2:
        min2 = torch.where(torch.isinf(min1), min1, min2)
    one = torch.ones((), dtype=f32)
    rs = torch.where(syn == 1, -one, one) * torch.where(neg, -one, one)
    bound = torch.tensor(thr if use_thr else float("inf"), dtype=f32)

    def value(eabs):
        v = (rs * one * torch.maximum(eabs - factor, torch.zeros((), dtype=f32))
             if offset else factor * rs * one * eabs)
        return torch.minimum(torch.maximum(v, -bound), bound)

    pos = (msgs > 0) | (use_thr and thr < 0)
    return value(min1), value(min2), pos, a == min1[:, None]


def _rebuild(p1, p2, pos, eq):
    """The kernel's ``stored_value``: p2 where |m| == min1, else p1, negated
    where the sign bit is clear."""
    v = torch.where(eq, p2[:, None], p1[:, None])
    return torch.where(pos, v, -v)


@pytest.mark.parametrize("thr", [None, 2.5, -1.0])
@pytest.mark.parametrize("alg,f1,f2", ALGS)
def test_compressed_check_model_rebuilds_plain_values(alg, f1, f2, thr):
    """The record (a value pair and two bits an edge) rebuilds the plain
    decoder's clamped f32 check->bit values bit for bit: random rows of
    degrees 2-16, with ties at the minimum, +0 and -0 messages, rows whose
    every |m| is inf and rows with a NaN; the clamp off, on, and at a
    negative threshold, where every value is the threshold."""
    from qkd_ldpc_v_tpu_torch.ops.decoders import _minsum_values

    rng = np.random.default_rng(5)
    f32 = torch.float32
    one = torch.ones((), dtype=f32)
    big = torch.tensor(float(np.finfo(np.float32).max), dtype=f32)
    offset = alg in ("OMSA", "AOMSA")
    for deg in (2, 3, 9, 10, 16):
        msgs = torch.tensor(rng.normal(0, 3, (64, deg, 8)), dtype=f32)
        msgs[1:8, 1] = msgs[1:8, 0].abs()           # ties at the minimum
        msgs[8:12, :2] = 0.0
        msgs[12:16, 0] = -0.0
        msgs[16:20] = float("inf") * torch.sign(msgs[16:20])
        msgs[20:24, deg - 1] = float("nan")
        msgs[24:28] = msgs[24:28].round()           # many ties
        syn = torch.tensor(rng.integers(0, 2, (64, 8)), dtype=torch.int8)
        second = torch.tensor(rng.integers(0, 2, (64, 8)), dtype=torch.bool)
        factor = torch.where(second, torch.tensor(f2, dtype=f32),
                             torch.tensor(f1, dtype=f32))
        want = _minsum_values(msgs, torch.where(syn == 1, -one, one),
                              factor[:, None, :], not offset, big, one)
        if thr is not None:
            want = torch.clamp(want, min=-torch.tensor(thr, dtype=f32),
                               max=torch.tensor(thr, dtype=f32))
        got = _rebuild(*_record(msgs, syn, factor, offset, thr is not None,
                                0.0 if thr is None else thr))
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        assert bool(same.all()), (deg, int((~same).sum()))
        # Bit for bit, signed zeros included (a NaN's sign aside).
        finite = ~torch.isnan(want)
        assert torch.equal(got[finite].view(torch.int32),
                           want[finite].view(torch.int32))


def _cluster_model_trial(layout, cluster, alg, cap, use_thr, alice, bob,
                         log_p, f1, f2, thr):
    """Plain model of the cluster kernel's trial (``decode_frame``) read
    from its tables: flooding with the message formed on read as clamp(t -
    v) from the totals and the stored records (the first sweep unclamped),
    the decision parity taken in the check pass (the adaptive pair's factor
    and the convergence test of the sweep before), the bit pass's
    llr-first totals over the stored values in slot order, one parity-only
    pass after the last sweep, and each frame's exit at its vote."""
    checks, bits, bit_ext = _decoded_tables(layout, cluster)
    f32 = torch.float32
    adaptive = TAlg[alg].is_adaptive
    offset = alg in ("OMSA", "AOMSA")
    ext = torch.tensor(bit_ext)
    a_int = alice[:, ext].t().to(torch.bool)
    lp = torch.tensor(log_p, dtype=f32)
    llr = torch.where(bob[:, ext].t() == 1, -lp, lp)
    batch = alice.shape[0]
    tot = llr.clone()
    syn = [a_int[torch.tensor(b)].sum(dim=1) % 2 for (_, _, _, b) in checks]
    neg_same = use_thr and thr < 0
    zero = torch.zeros((), dtype=f32) * (1.0 if neg_same else -1.0)
    recs = [(zero.expand(count, batch), zero.expand(count, batch),
             torch.full((count, deg, batch), neg_same),
             torch.zeros((count, deg, batch), dtype=torch.bool))
            for (_, count, deg, _) in checks]
    active = torch.ones(batch, dtype=torch.bool)
    conv = torch.zeros(batch, dtype=torch.bool)
    iters = torch.full((batch,), cap, dtype=torch.int32)
    final = tot.clone()
    big = torch.tensor(float("inf"), dtype=f32)

    def parity():
        return torch.stack([
            ((syn[i] + (tot[torch.tensor(b)] <= 0).sum(dim=1)) % 2 == 1
             ).any(dim=0) for i, (_, _, _, b) in enumerate(checks)]).any(dim=0)

    for it in range(cap):
        bound = torch.tensor(thr, dtype=f32) if use_thr and it > 0 else big
        new, bad = [], torch.zeros(batch, dtype=torch.bool)
        for i, (_, count, deg, b) in enumerate(checks):
            t = tot[torch.tensor(b)]
            par = (syn[i] + (t <= 0).sum(dim=1)) % 2 == 1
            bad |= par.any(dim=0)
            m = torch.minimum(torch.maximum(t - _rebuild(*recs[i]), -bound),
                              bound)
            factor = torch.where(par & adaptive, torch.tensor(f2, dtype=f32),
                                 torch.tensor(f1, dtype=f32))
            new.append(_record(m, syn[i], factor, offset, use_thr, thr))
        vote = bad if (adaptive or it > 0) else torch.ones_like(bad)
        newly = active & ~vote
        conv |= newly
        iters = torch.where(newly, it + 1 if adaptive else it, iters)
        final = torch.where(newly[None, :], tot, final)
        active &= vote
        if not bool(active.any()):
            break
        recs = new
        values = torch.zeros((layout.num_checks, 32, batch), dtype=f32)
        for (start, count, deg, _), rec in zip(checks, recs):
            values[start:start + count, :deg] = _rebuild(*rec)
        tot = llr.clone()
        for start, count, deg, c, k in bits:
            for j in range(deg):
                tot[start:start + count] = (tot[start:start + count]
                                            + values[c[:, j], k[:, j]])
    else:
        if not adaptive and cap > 0:
            conv |= active & ~parity()
    final = torch.where(active[None, :], tot, final)
    keys = ((final <= 0) == a_int).all(dim=0)
    return conv, keys, iters


@pytest.mark.parametrize("use_thr", [False, True])
@pytest.mark.parametrize("alg,f1,f2", ALGS)
def test_cluster_schedule_model_equals_plain(irregular, alg, f1, f2, use_thr):
    """The cluster kernel's schedule, modelled from its tables at two CTAs
    a cluster, equals the plain f32 trial bit for bit on 21 frames of the
    N=288 code in its waterfall (some converge at once, some late, some
    run to the cap)."""
    alice, bob, _, _ = (torch.tensor(x) for x in
                        channel_case(irregular, 21, 0.07, 41))
    thr = THRESHOLD if use_thr else 0.0
    want = generic_stream.make_generic_stream_trial(
        irregular, TAlg[alg], 12, use_thr)(alice, bob, log_ratio(0.07), f1,
                                           f2, thr)
    got = _cluster_model_trial(layout_for(irregular), 2, alg, 12, use_thr,
                               alice, bob, log_ratio(0.07), f1, f2, thr)
    assert 0 < int(want[0].sum()) < 21
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("frames", generic_stream.CLUSTER_FRAMES)
def test_mixed_degree_code_plans(frames):
    """The mixed-degree code's shape, on which the card's test of the
    cluster kernel at every group size runs: each check degree as asked,
    column weights 4 and 5, and one CTA of 1024 threads for each group
    size."""
    layout = layout_for(mixed_degree_code())
    assert [(g.degree, g.count) for g in layout.check_groups] == [
        (3, 100), (6, 500), (9, 400), (10, 400), (12, 100), (30, 100)]
    assert [(g.degree, g.count) for g in layout.bit_groups] == [
        (5, 2900), (6, 100)]
    plan = generic_stream._layout_plan(layout, "trial", False, frames)
    assert (plan.frames, plan.cluster, plan.threads) == (frames, 1, 1024)


# ---------------------------------------------------------------------------
# On the card: kernel == plain, exactly.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the streamed generic kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def _card_keys(n, batch, num_errors, seed, device):
    gen = np.random.default_rng(seed)
    alice = torch.tensor(gen.integers(0, 2, (batch, n)), dtype=torch.int8,
                         device=device)
    bits = torch.tensor(gen.integers(0, 2**32, (batch, n)), dtype=torch.int64,
                        device=device)
    return alice, inject_errors(bits, alice, num_errors, wide=True)


@pytest.mark.cuda
def test_shared_bytes_equal_the_library(cuda_device):
    lib = kernels.library()
    for group in generic_stream.GROUPS:
        for n, m in ((288, 144), (22000, 11000), (102400, 31744),
                     (200000, 60001)):
            assert lib.generic_stream_shared_bytes(n, m, group) \
                == generic_stream.shared_bytes(n, m, group)
            for trial in (0, 1):
                assert lib.generic_stream_scratch_bytes(
                    n, m, 3 * n, group, trial) == \
                    generic_stream.scratch_bytes(n, m, 3 * n, group,
                                                 bool(trial))
        assert generic_stream.shared_bytes(102400, 31744, group) \
            <= launch.MAX_SHARED_BYTES
    assert lib.generic_stream_shared_bytes(288, 144, 4) == -1


def _assert_kernel_equals_plain(matrix, alg, f1, f2, use_thr, thr, alice,
                                bob, lp, group):
    """Trial and decode of the streamed kernel at ``group`` frames per
    block against the plain version, exactly; returns the trial's conv and
    iterations."""
    device = alice.device
    trial = generic_stream.make_generic_stream_trial(matrix, TAlg[alg], CAP,
                                                     use_thr, group)
    got = trial(alice, bob, lp, f1, f2, thr)
    want = trial.plain(alice, bob, lp, f1, f2, thr)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    lpt = torch.tensor(lp, device=device)
    llr = torch.where(bob == 1, -lpt, lpt)
    syn = calculate_syndrome(layout_for(matrix), alice)
    dec = generic_stream.make_generic_stream_decoder(matrix, TAlg[alg], CAP,
                                                     use_thr, group)
    got_d = dec(llr, syn, f1, f2, thr)
    want_d = dec.plain(llr, syn, f1, f2, thr)
    torch.cuda.synchronize()
    for g, w in zip(got_d, want_d):
        assert torch.equal(g.cpu(), w.cpu())
    return got[0].cpu(), got[2].cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("group", generic_stream.GROUPS)
@pytest.mark.parametrize("use_thr", [False, True])
@pytest.mark.parametrize("alg,f1,f2",
                         ALGS + [("SPA", 1.0, 1.0), ("SPA_APPROX", 1.0, 1.0)])
def test_kernel_matches_plain_on_card(cuda_device, alg, f1, f2, use_thr,
                                      group):
    # Each code in its waterfall, so some frames run to the cap; 63 and 40
    # frames leave a ragged last group at both group sizes.
    thr = 2.5 if use_thr else 0.0
    for matrix, qber, frames in ((from_dense(irregular_dense()), 0.07, 63),
                                 (stream_sized_code(), 0.078, 40)):
        n = matrix.num_bit_nodes
        ne = int(n * qber)
        alice, bob = _card_keys(n, frames, ne, seed=7, device=cuda_device)
        _assert_kernel_equals_plain(matrix, alg, f1, f2, use_thr, thr, alice,
                                    bob, log_ratio(ne / n), group)


@pytest.mark.cuda
@pytest.mark.parametrize("group", generic_stream.GROUPS)
@pytest.mark.parametrize("frames", [1, 7, 9, 13, 130])
def test_ragged_batches_on_card(cuda_device, frames, group):
    """Batches that leave the last group short (or make it the only one)
    equal the plain version, NMSA and AOMSA."""
    matrix = stream_sized_code()
    n = matrix.num_bit_nodes
    ne = int(n * 0.075)
    alice, bob = _card_keys(n, frames, ne, seed=frames, device=cuda_device)
    for alg, f1, f2 in (ALGS[0], ALGS[3]):
        _assert_kernel_equals_plain(matrix, alg, f1, f2, False, 0.0, alice,
                                    bob, log_ratio(ne / n), group)


@pytest.mark.cuda
@pytest.mark.parametrize("group", generic_stream.GROUPS)
@pytest.mark.parametrize("alg,f1,f2", ALGS)
def test_mixed_convergence_group_on_card(cuda_device, alg, f1, f2, group):
    """One group that mixes a frame without errors (it converges at once)
    with frames deep in the waterfall that run to the cap: the frozen
    frame's outcome and the others' equal the plain version."""
    matrix = stream_sized_code()
    n = matrix.num_bit_nodes
    ne = int(n * 0.09)
    alice, bob = _card_keys(n, group, ne, seed=3, device=cuda_device)
    bob[0] = alice[0]
    conv, iters = _assert_kernel_equals_plain(
        matrix, alg, f1, f2, False, 0.0, alice, bob, log_ratio(ne / n), group)
    assert bool(conv[0]) and int(iters[0]) == 1
    assert int(iters.max()) == CAP


@pytest.mark.cuda
@pytest.mark.parametrize("group", generic_stream.GROUPS)
def test_all_shortened_frames_fault_pin_on_card(cuda_device, group):
    """Pins the repair of a fault this kernel had (ROADMAP.md section 3): on
    rate-adapted frames where every check around one bit has all its other
    bits shortened, bit totals overflow to inf; where every |message| of a
    check is inf, the plain decoder's second minimum is inf, and this
    kernel's chain used to keep the float32 maximum it starts from (and
    fminf / fmaxf drop a NaN). With the NONFINITE helpers of the fused
    generic kernel its decode mode equals the plain version there, with the
    clamp off and on, and at a primary factor of 1.25, where inf - inf gives
    NaN."""
    from test_torch_fused_qc import all_shortened_plan, rate_adapted_frames
    from qkd_ldpc_v_tpu_torch.rate_adapt import adapt_code_rate

    matrix = stream_sized_code()
    params = adapt_code_rate(np.random.default_rng(3), matrix, 0.08, 0.1, 1.3)
    frame, llr = rate_adapted_frames(matrix, all_shortened_plan(matrix, params),
                                     16, 0.08, seed=9, device=cuda_device)
    syn = calculate_syndrome(layout_for(matrix), frame)
    for use_thr, primary in ((False, 0.8), (True, 0.8), (False, 1.25)):
        dec = generic_stream.make_generic_stream_decoder(matrix, TAlg.NMSA,
                                                         CAP, use_thr, group)
        got = dec(llr, syn, primary, 1.0, 2.5)
        want = dec.plain(llr, syn, primary, 1.0, 2.5)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu()), (use_thr, primary)


@pytest.mark.cuda
@pytest.mark.parametrize("group", generic_stream.GROUPS)
@pytest.mark.parametrize("alg", ["SPA", "SPA_APPROX"])
def test_spa_long_checks_and_forced_frames_on_card(cuda_device, alg, group):
    """The SPA pair where a check's degree exceeds the register run (the 1k
    alist code, check degrees 62-63: the long loop), and in decode mode on
    forced LLRs (a zero, the 0/0 ratio; eight times the channel's
    magnitude, where tanh rounds to +-1 and the guard clamps) and on the
    all-shortened neighbourhood of one bit (inf and NaN), clamp off and
    on."""
    from test_torch_fused_qc import all_shortened_plan, rate_adapted_frames
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.rate_adapt import adapt_code_rate

    deg63 = read_sparse_matrix_alist(ALIST / "(N=1024,M=82,R=0.92,CW=5,SEED=65).mtrx")
    alice, bob = _card_keys(1024, 21, 5, seed=7, device=cuda_device)
    _assert_kernel_equals_plain(deg63, alg, 1.0, 1.0, False, 0.0, alice, bob,
                                log_ratio(5 / 1024), group)
    matrix = stream_sized_code()
    n = matrix.num_bit_nodes
    ne = int(n * 0.07)
    alice, bob = _card_keys(n, 13, ne, seed=5, device=cuda_device)
    lpt = torch.tensor(log_ratio(ne / n), device=cuda_device)
    llr = torch.where(bob == 1, -lpt, lpt)
    llr[0, 0] = 0.0
    llr[1] *= 8.0
    params = adapt_code_rate(np.random.default_rng(3), matrix, 0.08, 0.1, 1.3)
    frame, fllr = rate_adapted_frames(matrix, all_shortened_plan(matrix, params),
                                      16, 0.08, seed=9, device=cuda_device)
    layout = layout_for(matrix)
    for use_thr in (False, True):
        dec = generic_stream.make_generic_stream_decoder(matrix, TAlg[alg],
                                                         CAP, use_thr, group)
        for x, a in ((llr, alice), (fllr, frame)):
            syn = calculate_syndrome(layout, a)
            got = dec(x, syn, 1.0, 1.0, 2.5)
            want = dec.plain(x, syn, 1.0, 1.0, 2.5)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w.cpu()), use_thr


# ---------------------------------------------------------------------------
# On the card: the cluster kernel == plain, exactly, and its route.
# ---------------------------------------------------------------------------


def _alist100k():
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist

    return read_sparse_matrix_alist(
        ALIST / "(N=102400,M=31744,R=0.69,CW=3,SEED=67).mtrx")


def _assert_cluster_equals_plain(matrix, alg, f1, f2, use_thr, thr, alice,
                                 bob, lp):
    """A trial whose launch takes the cluster kernel with every frame equals
    the plain version and the batch-minor kernel exactly; returns its conv
    and iterations."""
    trial = generic_stream.make_generic_stream_trial(matrix, TAlg[alg], CAP,
                                                     use_thr)
    generic_stream.reset_counts()
    got = trial(alice, bob, lp, f1, f2, thr)
    torch.cuda.synchronize()
    assert generic_stream.counts() == (1, 0, 1, alice.shape[0])
    want = trial.plain(alice, bob, lp, f1, f2, thr)
    minor = generic_stream.make_generic_stream_trial(
        matrix, TAlg[alg], CAP, use_thr, generic_stream.GROUPS[0])(
            alice, bob, lp, f1, f2, thr)
    for g, w, o in zip(got, want, minor):
        assert torch.equal(g.cpu(), w.cpu())
        assert torch.equal(g.cpu(), o.cpu())
    return got[0].cpu(), got[2].cpu()


@pytest.mark.cuda
def test_cluster_plan_equals_the_library(cuda_device):
    """The Python mirror of the cluster kernel's layout (threads and shared
    bytes per CTA, record bytes per cluster, its limits) equals the
    library's for every group size and cluster size."""
    lib = kernels.library()
    for n, m in ((288, 144), (10240, 2841), (22000, 11000), (N100K, M100K),
                 (800000, 250000)):
        for f in generic_stream.CLUSTER_FRAMES:
            for c in generic_stream.CLUSTER_SIZES:
                assert lib.generic_cluster_threads(n, m, f, c) == min(
                    generic_stream.THREADS,
                    f * max(generic_stream._share(n, c),
                            generic_stream._share(m, c)))
                assert lib.generic_cluster_shared_bytes(n, m, f, c) \
                    == generic_stream.cluster_shared_bytes(n, m, f, c)
            assert lib.generic_cluster_record_bytes(m, f) \
                == -(-16 * m * f // 256) * 256
    assert (lib.generic_cluster_max_groups(), lib.generic_cluster_max_degree(),
            lib.generic_cluster_max_frames()) == (
        generic_stream.MAX_GROUPS, generic_stream.MAX_DEGREE,
        max(generic_stream.CLUSTER_FRAMES))


@pytest.mark.cuda
@pytest.mark.parametrize("use_thr", [False, True])
@pytest.mark.parametrize("alg,f1,f2", ALGS)
def test_cluster_kernel_matches_plain_at_100k_on_card(cuda_device, alg, f1,
                                                      f2, use_thr):
    """The N=102400 alist code in its waterfall (64 frames at QBER 0.038,
    cap 30), the clamp off and on: the cluster kernel equals the plain
    version and the batch-minor kernel in conv, keys and iterations."""
    matrix = _alist100k()
    n = matrix.num_bit_nodes
    ne = int(n * 0.038)
    alice, bob = _card_keys(n, 64, ne, seed=11, device=cuda_device)
    _assert_cluster_equals_plain(matrix, alg, f1, f2, use_thr,
                                 2.5 if use_thr else 0.0, alice, bob,
                                 log_ratio(ne / n))


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [-1, 1, 5])
def test_cluster_batches_off_the_clusters_in_flight_on_card(cuda_device,
                                                            extra):
    """Batches that are not a multiple of the groups the clusters in flight
    take at once (one group per cluster, plus or less a few frames; the last
    group ragged), and batches below one group, equal the plain version,
    NMSA and AOMSA."""
    matrix = stream_sized_code()
    n = matrix.num_bit_nodes
    plan = generic_stream.launch_plan(
        matrix, launch.generic_flags(TAlg.NMSA), cuda_device)
    for frames in (plan.clusters * plan.cluster.frames + extra,
                   plan.cluster.frames - 1 if extra < 0 else extra):
        if frames < 1:
            continue
        ne = int(n * 0.075)
        alice, bob = _card_keys(n, frames, ne, seed=frames,
                                device=cuda_device)
        for alg, f1, f2 in (ALGS[0], ALGS[3]):
            _assert_cluster_equals_plain(matrix, alg, f1, f2, False, 0.0,
                                         alice, bob, log_ratio(ne / n))


@pytest.mark.cuda
@pytest.mark.parametrize("alg,f1,f2", ALGS)
def test_cluster_frames_at_the_cap_on_card(cuda_device, alg, f1, f2):
    """Groups that mix frames without errors (they converge at once) with
    frames deep in the waterfall that run to the cap: every frame's outcome,
    the frozen ones' included, equals the plain version."""
    matrix = stream_sized_code()
    n = matrix.num_bit_nodes
    ne = int(n * 0.09)
    frames = 2 * max(generic_stream.CLUSTER_FRAMES) + 3
    alice, bob = _card_keys(n, frames, ne, seed=3, device=cuda_device)
    for f in (0, 5, frames - 1):
        bob[f] = alice[f]
    conv, iters = _assert_cluster_equals_plain(
        matrix, alg, f1, f2, False, 0.0, alice, bob, log_ratio(ne / n))
    assert bool(conv[0]) and int(iters[0]) == 1
    assert int(iters.max()) == CAP


@pytest.mark.cuda
@pytest.mark.parametrize("alg,f1,f2", [ALGS[0], ALGS[3]])
def test_cluster_long_checks_on_card(cuda_device, alg, f1, f2):
    """Checks of more than the register run's 16 edges (a regular code with
    rows of 30: the two-pass path, both words of the record) equal the
    plain version, the clamp off and on."""
    matrix = generate_regular_ldpc(num_bits=2000, num_checks=200,
                                   column_weight=3, seed=4)
    n = matrix.num_bit_nodes
    ne = int(n * 0.012)
    alice, bob = _card_keys(n, 41, ne, seed=13, device=cuda_device)
    for use_thr in (False, True):
        _assert_cluster_equals_plain(matrix, alg, f1, f2, use_thr,
                                     2.5 if use_thr else 0.0, alice, bob,
                                     log_ratio(ne / n))


@pytest.mark.cuda
def test_cluster_forced_stream_10k_on_card(cuda_device):
    """The 10k alist code forced to the stream engine takes the cluster
    kernel with one CTA a cluster (a group of 4 frames) and equals the
    plain version, the batch-minor kernel and the fused generic kernel."""
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist

    matrix = read_sparse_matrix_alist(
        ALIST / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx")
    plan = generic_stream.launch_plan(
        matrix, launch.generic_flags(TAlg.NMSA), cuda_device)
    assert (plan.cluster.frames, plan.cluster.cluster) == (4, 1)
    n = matrix.num_bit_nodes
    ne = int(n * 0.032)
    alice, bob = _card_keys(n, 257, ne, seed=5, device=cuda_device)
    lp = log_ratio(ne / n)
    for alg, f1, f2 in (ALGS[0], ALGS[3]):
        _assert_cluster_equals_plain(matrix, alg, f1, f2, False, 0.0, alice,
                                     bob, lp)
        trial = generic_stream.make_generic_stream_trial(matrix, TAlg[alg],
                                                         CAP, False)
        fused = fused_generic.make_fused_generic_trial(matrix, TAlg[alg], CAP,
                                                       False)
        for g, w in zip(trial(alice, bob, lp, f1, f2, 0.0),
                        fused(alice, bob, lp, f1, f2, 0.0)):
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
def test_cluster_route_counter_on_card(cuda_device):
    """The route counter: a min-sum trial launch takes the cluster kernel
    with every frame; decode mode, the SPA pair's trial and a launch that
    pins the batch-minor group size count a launch and leave the cluster
    counts as they were."""
    matrix = stream_sized_code()
    n, frames = matrix.num_bit_nodes, 37
    ne = int(n * 0.06)
    alice, bob = _card_keys(n, frames, ne, seed=9, device=cuda_device)
    lp = log_ratio(ne / n)
    lpt = torch.tensor(lp, device=cuda_device)
    llr = torch.where(bob == 1, -lpt, lpt)
    syn = calculate_syndrome(layout_for(matrix), alice)
    generic_stream.reset_counts()
    generic_stream.make_generic_stream_trial(matrix, TAlg.NMSA, CAP, False)(
        alice, bob, lp, 0.8)
    assert generic_stream.counts() == (1, 0, 1, frames)
    generic_stream.make_generic_stream_decoder(matrix, TAlg.NMSA, CAP, False)(
        llr, syn, 0.8)
    generic_stream.make_generic_stream_trial(matrix, TAlg.SPA, CAP, False)(
        alice, bob, lp)
    generic_stream.make_generic_stream_trial(matrix, TAlg.NMSA, CAP, False,
                                             generic_stream.GROUPS[1])(
        alice, bob, lp, 0.8)
    torch.cuda.synchronize()
    assert generic_stream.counts() == (4, 0, 1, frames)


def _cluster_at(matrix, alg, frames, device):
    """The cluster kernel's trial at ``frames`` frames a cluster: (plan,
    run), run(alice, bob, lp, f1, f2, use_thr, thr) -> (conv, keys,
    iterations)."""
    flags = launch.generic_flags(TAlg[alg])
    plan = generic_stream._Launch(matrix, flags, device, None, frames)

    def run(alice, bob, lp, f1, f2, use_thr, thr):
        batch = alice.shape[0]
        outs = tuple(torch.empty(batch, dtype=t, device=device)
                     for t in (torch.int8, torch.int8, torch.int32))
        err = plan.launch("trial", batch,
                          (alice.data_ptr(), bob.data_ptr(), batch),
                          (flags, int(use_thr), CAP, lp, f1, f2, thr), outs)
        assert err == 0, err
        torch.cuda.synchronize()
        return outs[0].bool(), outs[1].bool(), outs[2]
    return plan, run


@pytest.mark.cuda
@pytest.mark.parametrize("frames", generic_stream.CLUSTER_FRAMES)
@pytest.mark.parametrize("use_thr", [False, True])
@pytest.mark.parametrize("alg,f1,f2", ALGS)
def test_cluster_mixed_degrees_on_card(cuda_device, alg, f1, f2, use_thr,
                                       frames):
    """The cluster kernel at each group size (one CTA, P = 1024 / F slots)
    on the mixed-degree code: checks that fill their register run, runs
    with slots past the check's degree (the last loads nothing, the others
    read slot 0's total again), 12-edge checks and 30-edge checks (two
    passes) in one pass; 45 frames in the waterfall (a ragged last group;
    some converge, some run to the cap), the clamp off and on. Conv, keys
    and iterations equal the plain version bit for bit."""
    matrix = mixed_degree_code()
    n = matrix.num_bit_nodes
    ne = int(n * 0.068)
    alice, bob = _card_keys(n, 45, ne, seed=frames, device=cuda_device)
    lp, thr = log_ratio(ne / n), THRESHOLD if use_thr else 0.0
    plan, run = _cluster_at(matrix, alg, frames, cuda_device)
    assert (plan.cluster.frames, plan.cluster.cluster) == (frames, 1)
    got = run(alice, bob, lp, f1, f2, use_thr, thr)
    want = generic_stream.make_generic_stream_trial(
        matrix, TAlg[alg], CAP, use_thr).plain(alice, bob, lp, f1, f2, thr)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    assert 0 < int(got[0].sum()) < 45
