"""Rate-adapted frames and the frame trials of the port against the JAX
package, on the CPU.

  * ``channel.build_frames`` equals the frames and LLRs that the JAX
    sweep's rate-adaptive step (``_build_step``'s ``base_step``) hands to
    its decode tail, for the same key bits, in float32 and float64.
  * The plain fused-QC frame trial equals JAX's
    ``make_pallas_qc_frame_trial`` in interpret mode on a QC code with
    N=1024 and Z=128, in both schedules, with the clamp off and on, on a
    real adaptation point (punctured and shortened bits present) and on the
    all-shortened neighbourhood of one bit, where float32-maximum LLRs make
    bit totals overflow to inf, and a scaling factor above 1 makes
    check->bit messages inf and then NaN (the traps the kernels' min, max
    and clamp are built for).
  * The plain fused-generic frame trial equals JAX's XLA decoder plus its
    syndrome and the key compare, for the four min-sum algorithms, clamp
    off and on, on an untainted adaptation point of a committed 1k alist
    code and on its all-shortened neighbourhood; and equals JAX's fused
    Pallas frame kernel (interpret mode, f32 transport) under NMSA.
Every comparison is exact.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qkd_ldpc_v_tpu import simulation as jsim
from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
from qkd_ldpc_v_tpu.config import MatrixFormat as JFormat
from qkd_ldpc_v_tpu.models.hmatrix import read_matrix as jread_matrix
from qkd_ldpc_v_tpu.models.layout import compile_layout
from qkd_ldpc_v_tpu.models.qc import generate_qc_ldpc as jgenerate_qc
from qkd_ldpc_v_tpu.ops import channel as jch
from qkd_ldpc_v_tpu.ops.decoders import DecodeResult as JDecodeResult
from qkd_ldpc_v_tpu.ops.decoders import get_decoder as jget_decoder
from qkd_ldpc_v_tpu.ops.pallas_generic import make_pallas_generic_frame_trial
from qkd_ldpc_v_tpu.ops.pallas_qc import make_pallas_qc_frame_trial
from qkd_ldpc_v_tpu.rate_adapt import adapt_code_rate as jadapt
from qkd_ldpc_v_tpu.rate_adapt import get_punctured_bits_untainted as juntp
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.config import MatrixFormat as TFormat
from qkd_ldpc_v_tpu_torch.convert import qc_from_arrays
from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix as tread_matrix
from qkd_ldpc_v_tpu_torch.ops import fused_generic, fused_qc, qc_decoder
from qkd_ldpc_v_tpu_torch.ops.channel import build_frames, inject_errors, log_ratio
from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams
from test_torch_fused_qc import all_shortened_plan

torch.set_num_threads(2)

CAP = 25
THRESHOLD = 2.5
BATCH = 8
SEED = 4
QC_QBER = 0.08  # R = 0.5 adapted to about 0.48 (delta 0.1, f_EC 1.3)
ALIST_1K = (Path(__file__).resolve().parent.parent / "sparse_matrices"
            / "matrices_alist" / "(N=1024,M=384,R=0.62,CW=3,SEED=62).mtrx")
ALIST_QBER = 0.05  # R = 0.62 adapted to 0.60 (delta 0.1, f_EC 1.4)
FACTORS = {"NMSA": (0.8, 1.0), "OMSA": (0.3, 1.0), "ANMSA": (0.88, 0.5),
           "AOMSA": (0.3, 0.6)}
# NMSA with alpha 1.25: on the all-shortened neighbourhood the messages to
# its bit are 1.25 x the float32 maximum = inf, and inf - inf = NaN follows.
BIG_ALPHA = 1.25


def _factors(alg):
    if alg == "NMSA-big":
        return "NMSA", BIG_ALPHA, 1.0
    return (alg, *FACTORS[alg])


def _as_torch_params(jparams) -> HMatrixParams:
    return HMatrixParams(punctured_bits=np.asarray(jparams.punctured_bits),
                         shortened_bits=np.asarray(jparams.shortened_bits))


def _jax_keys(n, batch):
    """Alice's keys, the error-position bits and Alice's punctured draw of
    chunk 0, as the JAX sweep draws them (``trial_keys``, ``kpa``)."""
    ka, ke, kp = jch.trial_keys(SEED, 0, 0)
    alice = np.asarray(jch.generate_keys(ka, batch, n))
    bits = np.asarray(jax.random.bits(ke, (batch, n), jnp.uint32))
    kpa, _ = jax.random.split(kp)
    punct = np.asarray(jax.random.bernoulli(kpa, 0.5, (batch, n))).astype(np.int8)
    return (ka, ke, kp), alice, bits.astype(np.int64), punct


def _port_frames(params, n, qber, dtype=torch.float32):
    """The port's frames from the JAX key bits of chunk 0."""
    _, alice, bits, punct = _jax_keys(n, BATCH)
    ne = int(n * qber)
    a = torch.tensor(alice)
    bob = inject_errors(torch.tensor(bits), a, ne, wide=True)
    pos_class, gather = tsim.make_frame_plan(n, params)
    return build_frames(a, bob, torch.tensor(punct),
                        torch.tensor(pos_class == 0),
                        torch.tensor(pos_class == 1),
                        torch.tensor(gather.astype(np.int64)),
                        log_ratio(ne / n, dtype), dtype)


@pytest.fixture(scope="module")
def qc_codes():
    jqc = jgenerate_qc(8, 4, 128, 3, seed=5)
    tqc = qc_from_arrays(jqc.shifts, jqc.lifting)
    jm = jqc.to_hmatrix()
    jparams = jadapt(np.random.default_rng(3), jm, QC_QBER, 0.1, 1.3)
    assert len(jparams.punctured_bits) and len(jparams.shortened_bits)
    params = _as_torch_params(jparams)
    plans = {"point": params,
             "forced": all_shortened_plan(tqc.to_hmatrix(), params)}
    return jqc, tqc, jm, plans


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_build_frames_equals_jax_base_step(qc_codes, dtype, monkeypatch):
    """JAX's rate-adaptive ``base_step`` (engine xla) run eagerly, with its
    decoder replaced by a recorder: the LLRs it decodes and Alice's frame
    behind its syndrome equal ``build_frames`` on the same key bits."""
    _, _, jm, plans = qc_codes
    params = plans["point"]
    n = jm.num_bit_nodes
    seen = {}

    def recording_decoder(layout, *args, **kwargs):
        def decode(llr, syndrome, primary, secondary, threshold):
            seen["llr"] = np.asarray(llr)
            b = llr.shape[0]
            return JDecodeResult(decision=jnp.zeros(llr.shape, jnp.int8),
                                 syndromes_match=jnp.zeros(b, bool),
                                 iterations=jnp.zeros(b, jnp.int32))
        return decode

    syndrome_internal = jsim.syndrome_internal

    def recording_syndrome(layout, bits_int):
        seen["alice_int"] = np.asarray(bits_int)
        return syndrome_internal(layout, bits_int)

    monkeypatch.setattr(jsim, "get_decoder", recording_decoder)
    monkeypatch.setattr(jsim, "syndrome_internal", recording_syndrome)
    step = jsim._build_step(jm, JAlg.NMSA, CAP, False, True, BATCH, dtype)
    keys, _, _, _ = _jax_keys(n, BATCH)
    ne = int(n * QC_QBER)
    pos_class, gather = jsim.make_frame_plan(n, params)
    step(*keys, jnp.asarray(ne / n, dtype), jnp.int32(ne),
         jnp.asarray(0.8, dtype), jnp.asarray(1.0, dtype),
         jnp.asarray(0.0, dtype), jnp.asarray(pos_class), jnp.asarray(gather))
    bit_order = compile_layout(jm).bit_order
    jframe = np.empty_like(seen["alice_int"])
    jframe[:, bit_order] = seen["alice_int"]

    frame, llr = _port_frames(params, n, QC_QBER,
                              torch.float32 if dtype == "float32"
                              else torch.float64)
    np.testing.assert_array_equal(frame.numpy(), jframe)
    assert llr.numpy().dtype == seen["llr"].dtype
    np.testing.assert_array_equal(llr.numpy(), seen["llr"])
    shortened = params.shortened_bits
    assert np.all(llr.numpy()[:, shortened] == np.finfo(dtype).max)
    assert np.all(frame.numpy()[:, shortened] == 0)
    assert np.all(llr.numpy()[:, params.punctured_bits]
                  == np.asarray(1e-4, dtype))


@pytest.mark.parametrize("plan,schedule,use_thr,alg", [
    ("point", "flooding", False, "NMSA"),
    ("point", "layered", True, "NMSA"),
    ("point", "flooding", False, "AOMSA"),
    ("forced", "flooding", False, "NMSA"),
    ("forced", "flooding", True, "NMSA"),
    ("forced", "layered", False, "NMSA"),
    ("forced", "layered", True, "NMSA"),
    ("forced", "flooding", False, "NMSA-big"),
    ("forced", "layered", False, "NMSA-big"),
])
def test_plain_qc_frame_trial_equals_pallas_frame_kernel(
        qc_codes, plan, schedule, use_thr, alg):
    jqc, tqc, _, plans = qc_codes
    frame, llr = _port_frames(plans[plan], tqc.num_bit_nodes, QC_QBER)
    alg, f1, f2 = _factors(alg)
    thr = THRESHOLD if use_thr else 0.0
    jtrial = make_pallas_qc_frame_trial(jqc, JAlg[alg], CAP, use_thr,
                                        batch_tile=8, interpret=True,
                                        schedule=schedule)
    want = [np.asarray(x) for x in jtrial(frame.numpy(), llr.numpy(), f1, f2,
                                          thr)]
    fused_qc.reset_counts()
    trial = fused_qc.make_fused_qc_frame_trial(tqc, TAlg[alg], CAP, use_thr,
                                               schedule)
    got = trial(frame, llr, f1, f2, thr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert fused_qc.counts() == (0, 0)
    if plan == "point":
        assert 0 < want[0].sum() < BATCH  # some frames fail


@pytest.mark.parametrize("alpha,use_thr,expected", [
    (0.8, False, {"inf in"}),
    (0.8, True, set()),
    (BIG_ALPHA, False, {"inf out", "nan in", "nan out"}),
    (BIG_ALPHA, True, set()),
])
def test_forced_frames_reach_inf_and_nan(qc_codes, alpha, use_thr, expected,
                                         monkeypatch):
    """What the all-shortened neighbourhood does to the plain decoder's
    check pass (its bit->check inputs and check->bit outputs): with the
    clamp off the bit totals overflow to inf at alpha 0.8 (the outputs stay
    within alpha x the float32 maximum, since the second minimum starts
    there); at alpha 1.25 the messages to the bit overflow to inf, its total
    is inf and its next message inf - inf = NaN, which spreads; with the
    clamp on everything stays finite."""
    _, tqc, _, plans = qc_codes
    frame, llr = _port_frames(plans["forced"], tqc.num_bit_nodes, QC_QBER)
    update = qc_decoder._RowUpdate.__call__
    kinds = set()

    def note(values, side):
        for v in values:
            if torch.isnan(v).any():
                kinds.add("nan " + side)
            if torch.isinf(v).any():
                kinds.add("inf " + side)

    def watched(self, msgs, syn_bits, f):
        note(msgs, "in")
        vals = update(self, msgs, syn_bits, f)
        note(vals, "out")
        return vals

    monkeypatch.setattr(qc_decoder._RowUpdate, "__call__", watched)
    trial = fused_qc.make_fused_qc_frame_trial(tqc, TAlg.NMSA, CAP, use_thr)
    trial(frame, llr, alpha, 1.0, THRESHOLD if use_thr else 0.0)
    assert kinds == expected


@pytest.fixture(scope="module")
def alist_code():
    jm = jread_matrix(ALIST_1K, JFormat.ALIST)
    tm = tread_matrix(ALIST_1K, TFormat.ALIST)
    jm.punctured_bits_untainted = juntp(ALIST_1K, np.random.default_rng(0), jm)
    jparams = jadapt(np.random.default_rng(3), jm, ALIST_QBER, 0.1, 1.4,
                     use_untainted=True)
    assert len(jparams.punctured_bits) and len(jparams.shortened_bits)
    params = _as_torch_params(jparams)
    return jm, tm, {"point": params,
                    "forced": all_shortened_plan(tm, params)}


def _jax_xla_frame_trial(jm, alg, use_thr, frame, llr, f1, f2, thr):
    layout = compile_layout(jm)
    res = jget_decoder(layout, JAlg[alg], CAP, use_thr, dtype=jnp.float32)(
        jnp.asarray(llr), jch.calculate_syndrome(layout, jnp.asarray(frame)),
        f1, f2, thr)
    keys = np.all(np.asarray(res.decision) == frame, axis=1)
    return np.asarray(res.syndromes_match), keys, np.asarray(res.iterations)


@pytest.mark.parametrize("plan,alg,use_thr", [
    *[("point", alg, thr) for alg in FACTORS for thr in (False, True)],
    ("forced", "NMSA", False),
    ("forced", "NMSA", True),
    ("forced", "AOMSA", False),
    ("forced", "NMSA-big", False),
])
def test_plain_generic_frame_trial_equals_jax_xla(alist_code, plan, alg,
                                                  use_thr):
    jm, tm, plans = alist_code
    frame, llr = _port_frames(plans[plan], tm.num_bit_nodes, ALIST_QBER)
    alg, f1, f2 = _factors(alg)
    thr = THRESHOLD if use_thr else 0.0
    want = _jax_xla_frame_trial(jm, alg, use_thr, frame.numpy(), llr.numpy(),
                                f1, f2, thr)
    fused_generic.reset_counts()
    trial = fused_generic.make_fused_generic_frame_trial(tm, TAlg[alg], CAP,
                                                         use_thr)
    got = trial(frame, llr, f1, f2, thr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert fused_generic.counts() == (0, 0)


def test_plain_generic_frame_trial_equals_pallas_frame_kernel(alist_code):
    """NMSA, no clamp: JAX's fused generic frame kernel in interpret mode
    with the f32 transport gives the same statistics."""
    jm, tm, plans = alist_code
    frame, llr = _port_frames(plans["point"], tm.num_bit_nodes, ALIST_QBER)
    jtrial = make_pallas_generic_frame_trial(jm, JAlg.NMSA, CAP, False,
                                             batch_tile=8, interpret=True,
                                             transport="f32")
    want = [np.asarray(x) for x in jtrial(frame.numpy(), llr.numpy(), 0.8,
                                          1.0, 0.0)]
    got = fused_generic.make_fused_generic_frame_trial(
        tm, TAlg.NMSA, CAP, False)(frame, llr, 0.8, 1.0, 0.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert 0 < want[0].sum() < BATCH


def test_frame_trial_checks_inputs_and_devices(qc_codes):
    _, tqc, _, plans = qc_codes
    n = tqc.num_bit_nodes
    frame, llr = _port_frames(plans["point"], n, QC_QBER)
    trial = fused_qc.make_fused_qc_frame_trial(tqc, TAlg.NMSA, CAP, False)
    with pytest.raises(TypeError):
        trial(frame, llr.double())
    with pytest.raises(TypeError):
        trial(frame.to(torch.int32), llr)
    with pytest.raises(ValueError):
        trial(frame[:, :100], llr[:, :100])
    meta = torch.empty((2, n), dtype=torch.int8, device="meta")
    fused_qc.reset_counts()
    with pytest.raises(NotImplementedError, match="meta"):
        trial(meta, torch.empty((2, n), device="meta"))
    assert fused_qc.counts() == (0, 0)
