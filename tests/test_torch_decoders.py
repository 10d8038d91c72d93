"""The generic torch decoder (qkd_ldpc_v_tpu_torch/ops/decoders.py) and its
SPA-lin tables (ops/linapprox.py) against the JAX package and the oracle.

  * float64, all six algorithms, clamp off and on: decisions, convergence
    and iterations equal ``oracle.decode_oracle`` and the JAX float64
    decoder bit for bit (mirrors tests/test_decoders.py).
  * float32 min-sum family: equal to the JAX float32 decoder exactly.
  * float32 SPA pair: JAX's XLA decoder forms the row product with
    ``jnp.prod``, while torch multiplies sequentially from the syndrome
    sign in slot order (the Pallas and CUDA kernels' order), and XLA's f32
    tanh is its own approximation, so the messages' bits differ; the class
    is PARITY.md level 2: decisions and ``syndromes_match`` equal on every
    frame, the frames that fail within the cap included, and iterations
    within one.
  * bfloat16 decodes (mirrors tests/test_decoders.py::test_bfloat16_decodes).
  * The transcendentals and the linear approximations agree with JAX and
    with Python's ``math`` on dense grids.
"""

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
from qkd_ldpc_v_tpu.models.generator import generate_regular_ldpc as jgen
from qkd_ldpc_v_tpu.models.hmatrix import from_dense as jfrom_dense
from qkd_ldpc_v_tpu.models.layout import compile_layout as jcompile
from qkd_ldpc_v_tpu.ops import linapprox as jlin
from qkd_ldpc_v_tpu.ops.channel import calculate_syndrome as jsyndrome
from qkd_ldpc_v_tpu.ops.decoders import get_decoder as jget_decoder
from qkd_ldpc_v_tpu.oracle import decode_oracle
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.convert import hmatrix_from_rows
from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
from qkd_ldpc_v_tpu_torch.models.layout import compile_layout
from qkd_ldpc_v_tpu_torch.ops import linapprox as tlin
from qkd_ldpc_v_tpu_torch.ops.channel import calculate_syndrome
from qkd_ldpc_v_tpu_torch.ops.decoders import get_decoder, make_decoder

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ALGS = [a.name for a in TAlg]
FACTORS = {
    "SPA": (1.0, 1.0),
    "SPA_APPROX": (1.0, 1.0),
    "NMSA": (0.8, 1.0),
    "OMSA": (0.25, 1.0),
    "ANMSA": (0.88, 0.5),
    "AOMSA": (0.3, 0.6),
}


@pytest.fixture(scope="module")
def codes():
    """(JAX HMatrix, port HMatrix) pairs: the conftest's small and medium
    regular codes, made by the JAX generator and carried across."""
    out = {}
    for name, (n, m, seed) in {"small": (96, 48, 7), "medium": (512, 256, 3)}.items():
        jm = jgen(num_bits=n, num_checks=m, column_weight=3, seed=seed)
        out[name] = (jm, hmatrix_from_rows(jm.check_nodes, jm.num_bit_nodes))
    return out


def make_case(matrix, batch, qber, seed):
    """tests/test_decoders.py::make_case: keys, exactly int(n*qber) flips,
    f64 LLRs."""
    rng = np.random.default_rng(seed)
    n = matrix.num_bit_nodes
    alice = rng.integers(0, 2, size=(batch, n)).astype(np.int8)
    num_errors = int(n * qber)
    bob = alice.copy()
    for b in range(batch):
        pos = rng.permutation(n)[:num_errors]
        bob[b, pos] ^= 1
    q = num_errors / n
    log_p = np.log((1.0 - q) / q)
    llr = np.where(bob == 1, -log_p, log_p).astype(np.float64)
    return alice, bob, llr


def _torch_decode(matrix, alg, cap, use_thr, dtype, llr, syn, f1, f2, thr):
    dec = get_decoder(compile_layout(matrix), TAlg[alg], cap, use_thr, dtype)
    return dec(torch.as_tensor(llr).to(dtype), torch.as_tensor(syn), f1, f2, thr)


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("use_threshold", [False, True])
def test_f64_matches_oracle_and_jax(codes, alg, use_threshold):
    jm, tm = codes["small"]
    batch, cap, thr = 6, 60, 30.0
    alice, _, llr = make_case(jm, batch, qber=0.04, seed=int(TAlg[alg]) * 10)
    syn = calculate_syndrome(compile_layout(tm), torch.tensor(alice)).numpy()
    np.testing.assert_array_equal(
        syn, np.asarray(jsyndrome(jcompile(jm), jnp.asarray(alice))))
    f1, f2 = FACTORS[alg]
    res = _torch_decode(tm, alg, cap, use_threshold, torch.float64, llr, syn,
                        f1, f2, thr)
    jdec = jget_decoder(jcompile(jm), JAlg[alg], cap, use_threshold,
                        dtype=jnp.float64)
    jres = jdec(jnp.asarray(llr), jnp.asarray(syn), f1, f2, thr)
    np.testing.assert_array_equal(res.decision.numpy(), np.asarray(jres.decision))
    np.testing.assert_array_equal(res.syndromes_match.numpy(),
                                  np.asarray(jres.syndromes_match))
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(jres.iterations))
    for b in range(batch):
        o_dec, o_match, o_iters = decode_oracle(
            jm, llr[b], syn[b], int(TAlg[alg]), cap, f1, f2, thr, use_threshold)
        assert o_match == bool(res.syndromes_match[b]), b
        assert o_iters == int(res.iterations[b]), b
        np.testing.assert_array_equal(res.decision[b].numpy(), o_dec)


@pytest.mark.parametrize("alg", ALGS)
def test_zero_errors_converge_at_iteration_one(codes, alg):
    jm, tm = codes["small"]
    rng = np.random.default_rng(99)
    alice = rng.integers(0, 2, size=(4, tm.num_bit_nodes)).astype(np.int8)
    log_p = np.log((1 - 0.02) / 0.02)
    llr = np.where(alice == 1, -log_p, log_p)
    syn = calculate_syndrome(compile_layout(tm), torch.tensor(alice))
    f1, f2 = FACTORS[alg]
    res = _torch_decode(tm, alg, 50, False, torch.float64, llr, syn, f1, f2, 0.0)
    assert bool(res.syndromes_match.all())
    assert (res.iterations == 1).all()
    np.testing.assert_array_equal(res.decision.numpy(), alice)


def test_textbook_johnson_spa():
    """Johnson, *Introducing LDPC Codes*, example 2.5: one flipped bit, SPA
    with threshold 100, recovers Alice's word on the oracle's trajectory."""
    dense = np.array([[1, 1, 0, 1, 0, 0], [0, 1, 1, 0, 1, 0],
                      [1, 0, 0, 0, 1, 1], [0, 0, 1, 1, 0, 1]], dtype=np.int8)
    jm = jfrom_dense(dense)
    from qkd_ldpc_v_tpu_torch.models.hmatrix import from_dense

    tm = from_dense(dense)
    alice = np.array([[0, 0, 1, 0, 1, 1]], dtype=np.int8)
    bob = np.array([[1, 0, 1, 0, 1, 1]], dtype=np.int8)
    log_p = np.log((1 - 0.2) / 0.2)
    llr = np.where(bob == 1, -log_p, log_p)
    syn = calculate_syndrome(compile_layout(tm), torch.tensor(alice))
    res = _torch_decode(tm, "SPA", 100, True, torch.float64, llr, syn, 1.0,
                        1.0, 100.0)
    assert bool(res.syndromes_match[0])
    np.testing.assert_array_equal(res.decision[0].numpy(), alice[0])
    _, o_match, o_iters = decode_oracle(jm, llr[0], syn[0].numpy(), 0, 100,
                                        1.0, 1.0, 100.0, True)
    assert o_match and int(res.iterations[0]) == o_iters


@pytest.mark.parametrize("alg", ["NMSA", "OMSA", "ANMSA", "AOMSA"])
@pytest.mark.parametrize("use_threshold", [False, True])
def test_f32_min_sum_equals_jax(codes, alg, use_threshold):
    jm, tm = codes["medium"]
    # QBER 0.07 sits in this code's waterfall: some frames run to the cap.
    alice, _, llr = make_case(jm, 16, qber=0.07, seed=123)
    llr = llr.astype(np.float32)
    syn = calculate_syndrome(compile_layout(tm), torch.tensor(alice)).numpy()
    f1, f2 = FACTORS[alg]
    thr = 4.0
    res = _torch_decode(tm, alg, 40, use_threshold, torch.float32, llr, syn,
                        f1, f2, thr)
    jdec = jget_decoder(jcompile(jm), JAlg[alg], 40, use_threshold,
                        dtype=jnp.float32)
    jres = jdec(jnp.asarray(llr), jnp.asarray(syn), f1, f2, thr)
    conv = res.syndromes_match.numpy()
    assert 0 < conv.sum() < len(conv)
    np.testing.assert_array_equal(conv, np.asarray(jres.syndromes_match))
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(jres.iterations))
    np.testing.assert_array_equal(res.decision.numpy(), np.asarray(jres.decision))


@pytest.mark.parametrize("alg", ["SPA", "SPA_APPROX"])
def test_f32_spa_pair_tolerance_class(codes, alg):
    jm, tm = codes["medium"]
    alice, _, llr = make_case(jm, 16, qber=0.075, seed=321)
    llr = llr.astype(np.float32)
    syn = calculate_syndrome(compile_layout(tm), torch.tensor(alice)).numpy()
    res = _torch_decode(tm, alg, 40, True, torch.float32, llr, syn, 1.0, 1.0,
                        100.0)
    jres = jget_decoder(jcompile(jm), JAlg[alg], 40, True,
                        dtype=jnp.float32)(jnp.asarray(llr), jnp.asarray(syn),
                                           1.0, 1.0, 100.0)
    conv = res.syndromes_match.numpy()
    assert 0 < conv.sum() < len(conv)
    np.testing.assert_array_equal(conv, np.asarray(jres.syndromes_match))
    np.testing.assert_array_equal(res.decision.numpy(),
                                  np.asarray(jres.decision))
    iters = res.iterations.numpy().astype(np.int64)
    assert np.abs(iters - np.asarray(jres.iterations)).max() <= 1


@pytest.mark.parametrize("alg", ["NMSA", "SPA"])
def test_bfloat16_decodes(codes, alg):
    """bfloat16 runs the same decoder and corrects most frames at an easy
    point (SPA with the clamp: bf16 tanh saturates at |LLR| ~ 9)."""
    jm, tm = codes["medium"]
    alice, _, llr = make_case(jm, 16, qber=0.02, seed=321)
    syn = calculate_syndrome(compile_layout(tm), torch.tensor(alice))
    f1, f2 = FACTORS[alg]
    spa = alg == "SPA"
    res = _torch_decode(tm, alg, 80, spa, torch.bfloat16, llr, syn, f1, f2,
                        8.0 if spa else 0.0)
    assert res.decision.dtype == torch.int8
    keys_ok = (res.decision.numpy() == alice).all(axis=1)
    assert np.mean(res.syndromes_match.numpy() & keys_ok) >= 0.8


def test_spa_f32_guard_matches_f64_at_depth():
    """The 10k alist asset at QBER 0.03: guarded f32 SPA decodes every frame
    the f64 path decodes, with the same iterations and decisions (mirrors
    tests/test_decoders.py::test_spa_f32_guard_matches_f64_at_depth)."""
    tm = read_sparse_matrix_alist(
        REPO / "sparse_matrices" / "matrices_alist"
        / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx")
    layout = compile_layout(tm)
    alice, _, llr = make_case(tm, 4, qber=0.03, seed=77)
    syn = calculate_syndrome(layout, torch.tensor(alice))
    r64 = make_decoder(layout, TAlg.SPA, 100, False, torch.float64)(
        torch.tensor(llr), syn)
    r32 = make_decoder(layout, TAlg.SPA, 100, False, torch.float32)(
        torch.tensor(llr).float(), syn)
    assert bool(r64.syndromes_match.all()) and bool(r32.syndromes_match.all())
    assert torch.equal(r32.iterations, r64.iterations)
    assert torch.equal(r32.decision, r64.decision)


def test_decoder_rejects_unsupported_dtype(codes):
    with pytest.raises(ValueError, match="dtype"):
        make_decoder(compile_layout(codes["small"][1]), TAlg.NMSA, 10, False,
                     torch.float16)


# ---------------------------------------------------------------------------
# Transcendentals and the SPA-lin tables
# ---------------------------------------------------------------------------


def _grid(dtype):
    x = np.concatenate([np.linspace(-12.0, 12.0, 20001),
                        np.linspace(-1.2, 1.2, 20001),
                        [0.5, 0.9, 1.2, 1.75, 2.5, 3.5, 8.0, 0.7, 0.999,
                         -0.999, -8.0, 0.0, -0.0]])
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("fn", ["tanh_lin_approx", "atanh_lin_approx"])
def test_linapprox_equals_jax(dtype, fn):
    x = _grid(dtype)
    got = getattr(tlin, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jlin, fn)(jnp.asarray(x)))
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_guard_atanh_ratio_equals_jax(dtype):
    x = np.array([0.5, -0.5, 1.0, -1.0, 1.5, -2.0, np.nan, 0.999999, -1e-30],
                 dtype=dtype)
    got = tlin.guard_atanh_ratio(torch.from_numpy(x)).numpy()
    want = np.asarray(jlin.guard_atanh_ratio(jnp.asarray(x), x.dtype))
    np.testing.assert_array_equal(got, want)


def _ulps(got, want):
    return np.abs(got.view(np.int64) - want.view(np.int64))


def test_f64_transcendentals_within_two_ulp_of_math():
    """Pins a known difference (ROADMAP §3): torch's float64 tanh/atanh are
    not Python's ``math`` (libm) ones. They differ by up to 2 ulp on a few
    percent of the ranges the decoder reaches (JAX's XLA versions differ
    from libm by more: up to 7 and 129 ulp on the same grids). The float64
    SPA decoder's decisions and iterations still equal the oracle's and
    JAX's in test_f64_matches_oracle_and_jax."""
    x = np.concatenate([np.linspace(-20.0, 20.0, 40001),
                        np.random.default_rng(0).standard_normal(20000) * 4])
    d = _ulps(torch.tanh(torch.from_numpy(x)).numpy(),
              np.array([math.tanh(v) for v in x]))
    assert d.max() <= 2
    r = np.concatenate([np.linspace(-0.999999, 0.999999, 40001),
                        np.tanh(np.random.default_rng(1).standard_normal(20000))])
    d = _ulps(torch.atanh(torch.from_numpy(r)).numpy(),
              np.array([math.atanh(v) for v in r]))
    assert d.max() <= 2
