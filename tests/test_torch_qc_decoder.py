"""Plain torch QC decoders (qkd_ldpc_v_tpu_torch/ops/qc_decoder.py) against
the JAX package on the same code, keys and LLRs.

Flooding is held to the JAX roll decoder (``make_qc_decoder``, f32) and to
the fused Pallas decoder in interpret mode: decisions and convergence flags
exactly, iteration counts exactly for NMSA/OMSA and within the existing
tolerance class of 3 for the adaptive pair (tests/test_pallas_qc.py); on
these channels the adaptive counts came out exact as well. Layered is held
exactly to ``_layered_oracle`` and to the fused Pallas decoder (interpret),
for all four algorithms. The cases cover the message clamp on and off, each
on an easy channel (all frames converge) and a hard one (some frames hit
the iteration cap).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
from qkd_ldpc_v_tpu.models.layout import layout_for
from qkd_ldpc_v_tpu.models.qc import generate_qc_ldpc
from qkd_ldpc_v_tpu.ops.channel import calculate_syndrome
from qkd_ldpc_v_tpu.ops.pallas_qc import make_pallas_qc_decoder
from qkd_ldpc_v_tpu.ops.qc_decoder import make_qc_decoder
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.convert import qc_from_arrays
from qkd_ldpc_v_tpu_torch.ops.qc_decoder import decode_flooding, decode_layered

from test_pallas_qc import _layered_oracle

torch.set_num_threads(2)

CAP = 25
THRESHOLD = 2.5  # below log(0.96/0.04) = 3.18, so the clamp bites
ALGS = [
    ("NMSA", 0.8, 1.0),
    ("OMSA", 0.3, 1.0),
    ("ANMSA", 0.88, 0.5),
    ("AOMSA", 0.3, 0.6),
]


@pytest.fixture(scope="module")
def codes():
    jqc = generate_qc_ldpc(base_bits=8, base_checks=4, lifting=128,
                           column_weight=3, seed=5)
    return jqc, qc_from_arrays(jqc.shifts, jqc.lifting)


def _channel(jqc, p, seed):
    rng = np.random.default_rng(seed)
    batch, n = 8, jqc.num_bit_nodes
    alice = rng.integers(0, 2, (batch, n)).astype(np.int8)
    bob = alice ^ (rng.random((batch, n)) < p).astype(np.int8)
    log_p = np.float32(np.log((1 - p) / p))
    llr = np.where(bob == 1, -log_p, log_p).astype(np.float32)
    syn = np.asarray(calculate_syndrome(layout_for(jqc.to_hmatrix()),
                                        jnp.asarray(alice)))
    return alice, llr, syn


@pytest.fixture(scope="module")
def channels(codes):
    jqc, _ = codes
    return {"easy": _channel(jqc, 0.04, 0), "hard": _channel(jqc, 0.075, 1)}


def _torch_run(fn, tqc, llr, syn, alg, use_thr, f1, f2):
    r = fn(tqc, torch.tensor(llr), torch.tensor(syn), TAlg[alg], CAP,
           use_thr, f1, f2, THRESHOLD if use_thr else 0.0)
    return (r.decision.numpy(), r.syndromes_match.numpy(),
            r.iterations.numpy())


def _jax_run(dec, llr, syn, f1, f2, use_thr):
    r = dec(jnp.asarray(llr), jnp.asarray(syn), f1, f2,
            THRESHOLD if use_thr else 0.0)
    return (np.asarray(r.decision), np.asarray(r.syndromes_match),
            np.asarray(r.iterations))


def test_channels_cover_both_outcomes(codes, channels):
    _, tqc = codes
    _, llr, syn = channels["hard"]
    _, conv, _ = _torch_run(decode_flooding, tqc, llr, syn, "NMSA", False,
                            0.8, 1.0)
    assert 0 < conv.sum() < len(conv)
    _, llr, syn = channels["easy"]
    _, conv, _ = _torch_run(decode_flooding, tqc, llr, syn, "NMSA", False,
                            0.8, 1.0)
    assert conv.all()


@pytest.mark.parametrize("alg,f1,f2,use_thr", [
    ("NMSA", 0.8, 1.0, False),
    ("OMSA", 0.3, 1.0, True),
    ("ANMSA", 0.88, 0.5, True),
    ("AOMSA", 0.3, 0.6, False),
])
def test_flooding_matches_jax_roll_decoder(codes, channels, alg, f1, f2,
                                           use_thr):
    jqc, tqc = codes
    jdec = jax.jit(make_qc_decoder(jqc, JAlg[alg], CAP, use_thr, jnp.float32))
    _compare_flooding(tqc, jdec, channels, alg, f1, f2, use_thr)


# The Pallas flooding decoder equals the roll decoder (tests/test_pallas_qc.py),
# so two cases, one per clamp state, keep its interpret-mode compiles short.
@pytest.mark.parametrize("alg,f1,f2,use_thr", [
    ("NMSA", 0.8, 1.0, True),
    ("AOMSA", 0.3, 0.6, False),
])
def test_flooding_matches_pallas(codes, channels, alg, f1, f2, use_thr):
    jqc, tqc = codes
    jdec = jax.jit(make_pallas_qc_decoder(jqc, JAlg[alg], CAP, use_thr,
                                          batch_tile=8, interpret=True))
    _compare_flooding(tqc, jdec, channels, alg, f1, f2, use_thr)


def _compare_flooding(tqc, jdec, channels, alg, f1, f2, use_thr):
    for name in ("easy", "hard"):
        _, llr, syn = channels[name]
        d_t, c_t, i_t = _torch_run(decode_flooding, tqc, llr, syn, alg,
                                   use_thr, f1, f2)
        d_j, c_j, i_j = _jax_run(jdec, llr, syn, f1, f2, use_thr)
        np.testing.assert_array_equal(c_t, c_j, err_msg=name)
        np.testing.assert_array_equal(d_t, d_j, err_msg=name)
        if alg in ("NMSA", "OMSA"):
            np.testing.assert_array_equal(i_t, i_j, err_msg=name)
        else:
            # Tolerance class of the adaptive pair; on these channels the
            # counts came out exact when the test was written.
            assert np.abs(i_t.astype(int) - i_j).max() <= 3, name


@pytest.mark.parametrize("alg,f1,f2", ALGS)
def test_layered_matches_oracle(codes, channels, alg, f1, f2):
    jqc, tqc = codes
    for name in ("easy", "hard"):
        _, llr, syn = channels[name]
        d_t, c_t, i_t = _torch_run(decode_layered, tqc, llr, syn, alg, False,
                                   f1, f2)
        for f in range(llr.shape[0]):
            d_o, it_o, conv_o = _layered_oracle(
                jqc, llr[f], syn[f], JAlg[alg], f1, CAP, secondary=f2)
            assert bool(c_t[f]) == conv_o, (name, f)
            assert int(i_t[f]) == it_o, (name, f)
            np.testing.assert_array_equal(d_t[f], d_o, err_msg=f"{name} {f}")


@pytest.mark.parametrize("alg,f1,f2,use_thr", [
    ("NMSA", 0.8, 1.0, True),
    ("OMSA", 0.3, 1.0, False),
    ("ANMSA", 0.88, 0.5, False),
    ("AOMSA", 0.3, 0.6, True),
])
def test_layered_matches_pallas(codes, channels, alg, f1, f2, use_thr):
    jqc, tqc = codes
    jdec = jax.jit(make_pallas_qc_decoder(
        jqc, JAlg[alg], CAP, use_thr, batch_tile=8, interpret=True,
        schedule="layered"))
    for name in ("easy", "hard"):
        _, llr, syn = channels[name]
        got = _torch_run(decode_layered, tqc, llr, syn, alg, use_thr, f1, f2)
        want = _jax_run(jdec, llr, syn, f1, f2, use_thr)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_spa_is_not_ported(codes, channels):
    """The SPA pair floods and is not ported to the layered schedule: the
    flooding decode runs (tests/test_torch_spa.py holds it to the JAX
    package) and the layered one raises ``ValueError``, as JAX's ``_build``
    does."""
    _, tqc = codes
    _, llr, syn = channels["easy"]
    for alg in (TAlg.SPA, TAlg.SPA_APPROX):
        res = decode_flooding(tqc, torch.tensor(llr), torch.tensor(syn), alg,
                              CAP, False)
        assert bool(res.syndromes_match.all())
        with pytest.raises(ValueError, match="layered"):
            decode_layered(tqc, torch.tensor(llr), torch.tensor(syn), alg,
                           CAP, False)
