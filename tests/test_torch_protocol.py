"""The port's single-round library API (qkd_ldpc_v_tpu_torch/protocol.py)
against the JAX package's (qkd_ldpc_v_tpu/protocol.py), the counterpart
of tests/test_protocol.py.

On the CPU, on the same keys (made from a numpy seed) and, in rate-adaptive
rounds, Alice's punctured bits fed from JAX's own threefry draw, the port's
``qkd_ldpc`` and ``qkd_ldpc_rate_adapt`` must equal JAX's in every field
(syndromes_match, keys_match, iterations, alice_out, bob_out) for the
min-sum family in float32 and for float64, on the conftest's medium code
(512x256) and a small QC code (N=1024): fixed rate, fixed rate with privacy
maintenance, rate adaptive, rate adaptive with privacy, at QBERs where some
frames fail. The SPA pair in float32 holds PARITY level 2 (decisions and
convergence equal, iterations within 1). Shortened bits never flip, a
spec's removal set is derived as JAX derives it, and a round takes the
decoder JAX's protocol takes: the generic one, through the fused or
streamed generic kernel's plain version on the CPU, never a QC kernel.

Tests marked ``cuda`` hold a round on CUDA tensors (the generic kernels'
decode mode) to the same round composed from the plain versions on the
card, and skip without one. They import no JAX, so on a machine without
JAX they run with the conftest left out:

    python -m pytest tests/test_torch_protocol.py -m cuda --noconftest -q
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu_torch import protocol as tp
from qkd_ldpc_v_tpu_torch import rate_adapt as tra
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.convert import hmatrix_from_rows, qc_from_arrays
from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc
from qkd_ldpc_v_tpu_torch.models.qc import generate_qc_ldpc
from qkd_ldpc_v_tpu_torch.ops import fused_generic, fused_qc, generic_stream, qc_stream
from qkd_ldpc_v_tpu_torch.ops.channel import calculate_syndrome

torch.set_num_threads(2)

QBER = 0.075
CAP = 30
BATCH = 16
# (algorithm, primary, secondary, privacy maintenance, rate adaptive)
ROUNDS = {
    "fixed": ("NMSA", 0.8, 1.0, False, False),
    "fixed_privacy": ("AOMSA", 0.3, 0.6, True, False),
    "rate_adaptive": ("ANMSA", 0.88, 0.5, False, True),
    "rate_adaptive_privacy": ("OMSA", 0.3, 1.0, True, True),
}
# Adaptation point (QBER, delta, efficiency) of every rate-adaptive round.
POINT = (QBER, 0.1, 1.35)


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules, imported here so that the card tests run
    without JAX."""
    import jax
    import jax.numpy as jnp

    from qkd_ldpc_v_tpu import protocol
    from qkd_ldpc_v_tpu import rate_adapt
    from qkd_ldpc_v_tpu.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu.models.qc import generate_qc_ldpc

    return SimpleNamespace(jax=jax, jnp=jnp, protocol=protocol, ra=rate_adapt,
                           Alg=DecodingAlgorithm, generate_qc_ldpc=generate_qc_ldpc)


@pytest.fixture(scope="module")
def codes(J, medium_matrix):
    """name -> (JAX HMatrix, port HMatrix) of the same code."""
    jqc = J.generate_qc_ldpc(8, 4, 128, 3, seed=5)
    return {
        "medium": (medium_matrix, hmatrix_from_rows(
            medium_matrix.check_nodes, medium_matrix.num_bit_nodes)),
        "qc1k": (jqc.to_hmatrix(),
                 qc_from_arrays(jqc.shifts, jqc.lifting).to_hmatrix()),
    }


def _keys(n, batch, qber, seed):
    """Alice's keys and Bob's with exactly floor(n * qber) errors, from a
    numpy seed; and the accurate QBER."""
    rng = np.random.default_rng(seed)
    alice = rng.integers(0, 2, (batch, n)).astype(np.int8)
    ne = int(n * qber)
    bob = alice.copy()
    for b in range(batch):
        bob[b, rng.permutation(n)[:ne]] ^= 1
    return alice, bob, ne / n


def _specs(J, jm, tm, alg, privacy, rate_adaptive, dtype):
    """(JAX spec, port spec) of one round, each package computing its own
    adaptation parameters from the same generator seed."""
    jparams = tparams = None
    if rate_adaptive:
        jparams = J.ra.adapt_code_rate(np.random.default_rng(3), jm, *POINT)
        tparams = tra.adapt_code_rate(np.random.default_rng(3), tm, *POINT)
        assert not tparams.is_empty
    jspec = J.protocol.make_protocol_spec(jm, J.Alg[alg], CAP, False, privacy,
                                          params=jparams, dtype=dtype)
    tspec = tp.make_protocol_spec(tm, TAlg[alg], CAP, False, privacy,
                                  params=tparams, dtype=dtype)
    np.testing.assert_array_equal(tspec.keep, jspec.keep)
    return jspec, tspec


def _rounds(J, jspec, tspec, factors, seed):
    """(JAX result, port result) of one round on the same keys; Alice's
    punctured bits are JAX's draw, fed to the port."""
    n = tspec.num_key_bits
    alice, bob, q = _keys(tspec.num_frame_bits, BATCH, QBER, seed)
    if not tspec.rate_adaptive:
        want = J.protocol.qkd_ldpc(jspec, J.jnp.asarray(alice),
                                   J.jnp.asarray(bob), q, *factors)
        got = tp.qkd_ldpc(tspec, torch.as_tensor(alice), torch.as_tensor(bob),
                          q, *factors)
        return want, got
    key = J.jax.random.PRNGKey(seed)
    ka, _ = J.jax.random.split(key)
    punct = np.asarray(J.jax.random.bernoulli(
        ka, 0.5, (BATCH, len(jspec.punctured_positions)))).astype(np.int8)
    want = J.protocol.qkd_ldpc_rate_adapt(
        jspec, J.jnp.asarray(alice[:, :n]), J.jnp.asarray(bob[:, :n]), q, key,
        *factors)
    got = tp.qkd_ldpc_rate_adapt(
        tspec, torch.as_tensor(alice[:, :n]), torch.as_tensor(bob[:, :n]), q,
        None, *factors, alice_punct=torch.as_tensor(punct))
    return want, got


def _fields(res):
    return {f: np.asarray(getattr(res, f)) for f in res._fields}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("code", ["medium", "qc1k"])
@pytest.mark.parametrize("case", list(ROUNDS))
def test_round_equals_jax(J, codes, case, code, dtype):
    alg, f1, f2, privacy, rate_adaptive = ROUNDS[case]
    jm, tm = codes[code]
    jspec, tspec = _specs(J, jm, tm, alg, privacy, rate_adaptive, dtype)
    want, got = _rounds(J, jspec, tspec, (f1, f2), seed=4)
    want, got = _fields(want), _fields(got)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["alice_out"].shape == (BATCH, tspec.output_key_bits)
    # Some frames reconcile and some fail: the comparison sees both.
    assert 0 < got["keys_match"].sum() < BATCH
    for i in np.flatnonzero(got["keys_match"]):
        np.testing.assert_array_equal(got["alice_out"][i], got["bob_out"][i])


@pytest.mark.parametrize("rate_adaptive", [False, True],
                         ids=["fixed", "rate_adaptive"])
@pytest.mark.parametrize("alg", ["SPA", "SPA_APPROX"])
def test_spa_pair_round_holds_parity_level_2(J, codes, alg, rate_adaptive):
    """float32 SPA against JAX (PARITY.md level 2; XLA's tanh and row
    product are its own): convergence, key match and Alice's output equal
    on every frame, iterations within 1, and Bob's output equal on every
    frame that converges. A frame that fails within the cap may end apart:
    here SPA's fixed-rate frame 4, after 30 iterations without converging,
    differs from JAX's in one bit of 512."""
    jm, tm = codes["medium"]
    jspec, tspec = _specs(J, jm, tm, alg, False, rate_adaptive, "float32")
    want, got = _rounds(J, jspec, tspec, (1.0, 1.0), seed=5)
    want, got = _fields(want), _fields(got)
    for name in ("syndromes_match", "keys_match", "alice_out"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert np.abs(got["iterations"] - want["iterations"]).max() <= 1
    conv = got["syndromes_match"]
    assert 0 < conv.sum() < BATCH
    np.testing.assert_array_equal(got["bob_out"][conv], want["bob_out"][conv])


def test_spa_float64_round_equals_jax(J, codes):
    jm, tm = codes["medium"]
    jspec, tspec = _specs(J, jm, tm, "SPA", True, True, "float64")
    want, got = _rounds(J, jspec, tspec, (1.0, 1.0), seed=6)
    want, got = _fields(want), _fields(got)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_shortened_bits_never_flip(codes, monkeypatch):
    """Shortened positions carry LLR=+max: where a frame converged its
    decisions there are 0, and the round reconciles frames."""
    _, tm = codes["medium"]
    params = tra.adapt_code_rate(np.random.default_rng(9), tm, *POINT)
    tra.finalize_bits_to_remove(tm, params, False)
    spec = tp.make_protocol_spec(tm, TAlg.NMSA, 60, False, False,
                                 params=params, dtype="float64")
    alice, bob, q = _keys(tm.num_bit_nodes, 8, QBER, seed=10)
    n = spec.num_key_bits
    decode = tp.round_decoder(spec)
    seen = []
    monkeypatch.setattr(tp, "round_decoder", lambda s: (
        lambda *args: seen.append(decode(*args)) or seen[-1]))
    res = tp.qkd_ldpc_rate_adapt(
        spec, torch.as_tensor(alice[:, :n]), torch.as_tensor(bob[:, :n]), q,
        torch.Generator().manual_seed(11), primary=0.8)
    ok = res.keys_match
    assert ok.any()
    short = torch.as_tensor(spec.shortened_positions, dtype=torch.int64)
    assert not seen[0].decision[ok][:, short].any()


def test_spec_identity_hash_and_auto_removal(J, codes):
    """Specs hash by identity; a rate-adaptive spec derives the mandatory
    punctured+shortened removal when the caller did not finalize it, and a
    fixed-rate privacy spec without parameters derives its removals, both
    as JAX's specs do."""
    jm, tm = codes["medium"]
    jparams = J.ra.adapt_code_rate(np.random.default_rng(1), jm, 0.08, 0.2, 1.3)
    tparams = tra.adapt_code_rate(np.random.default_rng(1), tm, 0.08, 0.2, 1.3)
    assert len(tparams.bits_to_remove) == 0  # caller did not finalize
    jspec = J.protocol.make_protocol_spec(jm, J.Alg.SPA, 30, False, False,
                                          params=jparams)
    tspec = tp.make_protocol_spec(tm, TAlg.SPA, 30, False, False,
                                  params=tparams)
    assert hash(tspec) == hash(tspec)
    p, s = len(tparams.punctured_bits), len(tparams.shortened_bits)
    assert tspec.output_key_bits == tm.num_bit_nodes - p - s
    for name in ("keep", "payload_positions", "punctured_positions",
                 "shortened_positions", "bits_to_remove"):
        np.testing.assert_array_equal(getattr(tspec, name),
                                      getattr(jspec, name), err_msg=name)
    assert tspec.num_key_bits == jspec.num_key_bits

    jspec2 = J.protocol.make_protocol_spec(jm, J.Alg.SPA, 30, False, True)
    tspec2 = tp.make_protocol_spec(tm, TAlg.SPA, 30, False, True)
    assert tspec2.output_key_bits < tm.num_bit_nodes
    np.testing.assert_array_equal(tspec2.keep, jspec2.keep)


def _counts():
    return {mod.__name__.rsplit(".", 1)[1]: (mod.COUNTS.plain("decode"),
                                              mod.COUNTS.launches)
            for mod in (fused_generic, generic_stream, fused_qc, qc_stream)}


def _reset():
    for mod in (fused_generic, generic_stream, fused_qc, qc_stream):
        mod.reset_counts()


@pytest.mark.parametrize("code,dtype,kernel", [
    ("medium", "float32", "fused_generic"),
    ("qc1k", "float32", "fused_generic"),
    ("stream", "float32", "generic_stream"),
    ("medium", "float64", None),
    ("qc1k", "bfloat16", None),
])
def test_round_takes_the_generic_decoder(code, dtype, kernel):
    """float32 rounds run the fused generic kernel's wrapper inside
    ``generic_feasible`` (QC codes too, never a QC kernel) and the streamed
    generic kernel's beyond it (an N=22000 code); float64 and bfloat16 run
    the generic torch decoder. On the CPU the wrappers run their plain
    version and launch nothing."""
    if code == "stream":
        tm = generate_regular_ldpc(22000, 11000, 3, seed=5)
    elif code == "medium":
        tm = generate_regular_ldpc(512, 256, 3, seed=3)
    else:
        tm = generate_qc_ldpc(8, 4, 128, 3, seed=5).to_hmatrix()
    spec = tp.make_protocol_spec(tm, TAlg.NMSA, 8, dtype == "bfloat16", False,
                                 dtype=dtype)
    alice, bob, q = _keys(tm.num_bit_nodes, 2, 0.01, seed=1)
    _reset()
    res = tp.qkd_ldpc(spec, torch.as_tensor(alice), torch.as_tensor(bob), q,
                      0.8, 1.0, 8.0)
    assert res.keys_match.all()
    want = {name: (0, 0) for name in _counts()}
    if kernel is not None:
        want[kernel] = (1, 0)
    assert _counts() == want


def test_rate_adapt_needs_a_punctured_draw(codes):
    _, tm = codes["medium"]
    params = tra.adapt_code_rate(np.random.default_rng(3), tm, *POINT)
    spec = tp.make_protocol_spec(tm, TAlg.NMSA, CAP, False, False,
                                 params=params)
    alice, bob, q = _keys(spec.num_key_bits, 2, QBER, seed=1)
    with pytest.raises(ValueError, match="punct_generator or alice_punct"):
        tp.qkd_ldpc_rate_adapt(spec, torch.as_tensor(alice),
                               torch.as_tensor(bob), q)


# ---------------------------------------------------------------------------
# On the card: the round on CUDA tensors against the plain round composed
# from the same decoder's plain version.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the generic kernels have no CPU mode")
    return torch.device("cuda")


def _plain_round(spec, alice_frame, llr, factors):
    """The round composed by hand: Alice's syndrome, the decoder's plain
    version, the key compare and the output gather."""
    res = tp.round_decoder(spec).plain(
        llr, calculate_syndrome(spec.layout, alice_frame), *factors)
    keep = torch.as_tensor(spec.keep.astype(np.int64), device=llr.device)
    return ((res.decision == alice_frame).all(dim=1), res.syndromes_match,
            res.iterations, alice_frame[:, keep], res.decision[:, keep])


@pytest.mark.cuda
@pytest.mark.parametrize("rate_adaptive", [False, True],
                         ids=["fixed", "rate_adaptive"])
@pytest.mark.parametrize("code,kernel", [("medium", fused_generic),
                                         ("stream", generic_stream)])
@pytest.mark.parametrize("alg", ["NMSA", "AOMSA", "SPA_APPROX"])
def test_card_round_equals_plain_round(cuda_device, alg, code, kernel,
                                       rate_adaptive):
    tm = (generate_regular_ldpc(512, 256, 3, seed=3) if code == "medium"
          else generate_regular_ldpc(22000, 11000, 3, seed=5))
    qber = QBER if code == "medium" else 0.075
    params = None
    if rate_adaptive:
        params = tra.adapt_code_rate(np.random.default_rng(3), tm, qber, 0.1,
                                     1.35)
        assert not params.is_empty
    spec = tp.make_protocol_spec(tm, TAlg[alg], CAP, True, True,
                                 params=params)
    factors = {"NMSA": (0.8, 1.0), "AOMSA": (0.3, 0.6),
               "SPA_APPROX": (1.0, 1.0)}[alg] + (4.0,)
    alice, bob, q = _keys(tm.num_bit_nodes, 13, qber, seed=2)
    dev = cuda_device
    n = spec.num_key_bits
    a = torch.as_tensor(alice[:, :n], device=dev)
    b = torch.as_tensor(bob[:, :n], device=dev)
    kernel.reset_counts()
    if rate_adaptive:
        punct = torch.randint(0, 2, (13, len(spec.punctured_positions)),
                              generator=torch.Generator(device=dev).manual_seed(7),
                              dtype=torch.int8, device=dev)
        got = tp.qkd_ldpc_rate_adapt(spec, a, b, q, None, *factors,
                                     alice_punct=punct)
        alice_frame = torch.zeros((13, tm.num_bit_nodes), dtype=torch.int8,
                                  device=dev)
        llr = torch.zeros((13, tm.num_bit_nodes), dtype=torch.float32,
                          device=dev)
        lp = float(np.log((1 - q) / q))
        pos = [torch.as_tensor(p.astype(np.int64), device=dev)
               for p in (spec.payload_positions, spec.punctured_positions,
                         spec.shortened_positions)]
        alice_frame[:, pos[0]] = a
        alice_frame[:, pos[1]] = punct
        llr[:, pos[0]] = torch.where(b == 1, -lp, lp).float()
        llr[:, pos[1]] = tra.ALMOST_ZERO
        llr[:, pos[2]] = torch.finfo(torch.float32).max
    else:
        got = tp.qkd_ldpc(spec, a, b, q, *factors)
        alice_frame = a
        lp = torch.tensor(float(np.log((1 - q) / q)), dtype=torch.float32,
                          device=dev)
        llr = torch.where(b == 1, -lp, lp)
    assert kernel.COUNTS.launches == 1 and kernel.COUNTS.plain_on_cuda == 0
    want = _plain_round(spec, alice_frame, llr, factors)
    got = (got.keys_match, got.syndromes_match, got.iterations, got.alice_out,
           got.bob_out)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
