"""The Monte-Carlo (mc) mode of the port: its Philox generator
(qkd_ldpc_v_tpu_torch/ops/philox.py), its channel (ops/channel.py::
mc_channel) and its route in simulation.run_combination.

  * The Philox mirror reproduces Random123's known-answer vectors for
    Philox4x32-10, and the stream layout is (p >> 2, frame, stream, 0),
    word p & 3.
  * Cross-package: the JAX package's three mc kernels (fused QC, streamed
    QC, fused generic) run in interpret mode with their hardware PRNG
    stubbed by the hash stream of tests/test_pallas_qc.py,
    tests/test_pallas_qc_stream.py and tests/test_pallas_generic.py, one
    tile of frames (batch == tile, so tile rows are frames). The port, fed
    the mirrored stream, must equal their (conv, keys, iterations) exactly:
    for QC through ``mc_channel_from_bits`` and the plain trial, for the
    generic kernel through the JAX test's map from its flat node planes to
    external positions (``plan.bits.plane_pos``) and the plain trial.
  * The mc channel: exactly ``num_errors`` flips per frame (none at 0), fair
    Alice bits, error positions uniform (chi-squared), frames independent
    of the call that draws them, distinct seeds distinct streams.
  * Routing: a fixed-rate CPU run without a ``key_source`` on the ``qc``,
    ``qc_stream`` and ``generic`` engines runs the mc plain version and no
    trial; with a ``key_source`` it runs the trial; ``stream`` keeps its
    trial.
The card tests of the mc kernels against these plain versions are in
tests/test_torch_fused_qc.py, test_torch_qc_stream.py and
test_torch_fused_generic.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm as JAlg, MatrixFormat, RQBERRange
from qkd_ldpc_v_tpu.models.generator import generate_regular_ldpc as jgenerate_regular
from qkd_ldpc_v_tpu.models.qc import generate_qc_ldpc as jgenerate_qc
from qkd_ldpc_v_tpu.ops import pallas_generic as jpg
from qkd_ldpc_v_tpu.ops import pallas_qc as jpq
from qkd_ldpc_v_tpu.ops import pallas_qc_stream as jpqs
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.convert import config_from_dict, hmatrix_from_rows, qc_from_arrays
from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc
from qkd_ldpc_v_tpu_torch.ops import fused_generic, fused_qc, generic_stream, qc_stream
from qkd_ldpc_v_tpu_torch.ops.channel import (
    chunk_seed,
    log_ratio,
    mc_channel,
    mc_channel_from_bits,
)
from qkd_ldpc_v_tpu_torch.ops.philox import ALICE, ERRORS, philox4x32, stream_words
from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams as TParams

torch.set_num_threads(2)

CAP = 30
TILE = 8

# ---------------------------------------------------------------------------
# Philox4x32-10
# ---------------------------------------------------------------------------

ONES = 0xFFFFFFFF
# Random123's kat_vectors for philox4x32_10: (counter, key, output).
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((ONES,) * 4, (ONES, ONES), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    got = philox4x32(tuple(torch.tensor([c]) for c in counter), key)
    assert tuple(int(w) for w in got) == want


def test_stream_layout():
    """The value of (position p, frame f, stream s) is word p & 3 of the
    call on counter (p >> 2, f, s, 0) under the seed's two words."""
    seed = (0x12345678 << 32) | 0x9ABCDEF0
    words = stream_words(seed, 5, 3, 11, ERRORS, "cpu")
    assert words.shape == (3, 11)
    for f in range(3):
        for p in (0, 3, 4, 10):
            out = philox4x32(tuple(torch.tensor([c]) for c in
                                   (p >> 2, 5 + f, ERRORS, 0)),
                             (0x9ABCDEF0, 0x12345678))
            assert int(words[f, p]) == int(out[p & 3])
    assert int(words.min()) >= 0 and int(words.max()) <= ONES


# ---------------------------------------------------------------------------
# Against the JAX package's mc kernels, on their stubbed stream
# ---------------------------------------------------------------------------


def _stub_prng(module, monkeypatch):
    """The JAX tests' stand-in for the TPU's hardware PRNG: call k of a tile
    returns hash(row * 7919 ^ lane * 104729 ^ k * 97531)."""
    calls = {"n": 0}

    def fake_seed(*_seeds):
        calls["n"] = 0

    def fake_bits(shape):
        k = calls["n"]
        calls["n"] += 1
        a = jax.lax.broadcasted_iota(jnp.uint32, shape, 0) * jnp.uint32(7919)
        b = jax.lax.broadcasted_iota(jnp.uint32, shape, 1) * jnp.uint32(104729)
        x = a ^ b ^ jnp.uint32(k * 97531)
        x = (x ^ (x >> 13)) * jnp.uint32(2654435761)
        return x ^ (x >> 16)

    monkeypatch.setattr(module.pltpu, "prng_seed", fake_seed)
    monkeypatch.setattr(module.pltpu, "prng_random_bits", fake_bits)


def _np_bits(k, width):
    """Host mirror of call k of the stub over [TILE, width]."""
    a = np.arange(TILE, dtype=np.uint32)[:, None] * np.uint32(7919)
    b = np.arange(width, dtype=np.uint32)[None, :] * np.uint32(104729)
    with np.errstate(over="ignore"):
        x = (a ^ b ^ np.uint32(k * 97531)).astype(np.uint32)
        x = ((x ^ (x >> np.uint32(13))) * np.uint32(2654435761)).astype(np.uint32)
    return (x ^ (x >> np.uint32(16))).astype(np.uint32)


QC_CASES = [("NMSA", 0.8, 0.0, "flooding"), ("AOMSA", 0.3, 0.6, "layered"),
            ("NMSA", 0.8, 0.0, "layered"), ("AOMSA", 0.3, 0.6, "flooding")]


@pytest.mark.parametrize("kernel", ["fused", "streamed"])
@pytest.mark.parametrize("alg,f1,f2,schedule", QC_CASES)
def test_qc_mc_matches_jax_mc_kernel(kernel, alg, f1, f2, schedule,
                                     monkeypatch):
    """The N=1024 QC code: JAX's mc kernel draws Alice's blocks (calls 0 ..
    nb-1) and the error words (calls nb .. 2nb-1) per base column; the port's
    ``mc_channel_from_bits`` on the same words and its plain trial give the
    same statistics."""
    jqc = jgenerate_qc(8, 4, 128, 3, seed=5)
    tqc = qc_from_arrays(jqc.shifts, jqc.lifting)
    module, make = {
        "fused": (jpq, jpq.make_pallas_qc_montecarlo),
        "streamed": (jpqs, jpqs.make_pallas_qc_stream_montecarlo),
    }[kernel]
    _stub_prng(module, monkeypatch)
    z, nb, n = jqc.lifting, jqc.base_bits, jqc.num_bit_nodes
    ne = 80  # in the waterfall at cap 30: some frames fail
    qber = ne / n
    mc = make(jqc, JAlg[alg], CAP, False, batch=TILE, batch_tile=TILE,
              interpret=True, schedule=schedule)
    want = [np.asarray(x) for x in mc(3, ne, qber, f1, f2, 0.0)]

    alice_words = np.concatenate([_np_bits(c, z) for c in range(nb)], axis=1)
    error_words = np.concatenate([_np_bits(nb + c, z) for c in range(nb)],
                                 axis=1)
    alice, bob = mc_channel_from_bits(torch.tensor(alice_words.astype(np.int64)),
                                      torch.tensor(error_words.astype(np.int64)),
                                      ne)
    assert ((alice ^ bob).sum(dim=1) == ne).all()
    fused_qc.reset_counts()
    trial = fused_qc.make_fused_qc_trial(tqc, TAlg[alg], CAP, False, schedule)
    got = [x.numpy() for x in trial(alice, bob, log_ratio(qber), f1, f2, 0.0)]
    assert 0 < int(got[0].sum()) < TILE
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("alg,f1,f2", [("NMSA", 0.8, 0.0), ("AOMSA", 0.3, 0.6)])
def test_generic_mc_matches_jax_mc_kernel(alg, f1, f2, monkeypatch):
    """``generate_regular_ldpc(512, 256, 3, seed=21)``: JAX's mc kernel
    draws over its flat node planes (invalid lanes never flip). The JAX
    test's map to external positions gives keys on which JAX's trial kernel
    equals its mc kernel exactly, so the mirror is JAX's mc channel. The
    port's plain trial on those keys equals JAX's mc kernel exactly for
    NMSA. For AOMSA JAX's Pallas decode itself sits within a few iterations
    of its XLA decoder (its decision-in-LSB transport; see
    test_torch_fused_generic.py::test_plain_decode_holds_to_pallas_generic),
    so there the port equals JAX's XLA decoder on the mc channel's keys
    exactly. Both JAX kernels run the f32 transport, whose semantics the
    port follows (not the default bf16x2 rounding; ROADMAP.md section 3)."""
    from qkd_ldpc_v_tpu.models.layout import layout_for as jlayout_for
    from qkd_ldpc_v_tpu.ops.channel import calculate_syndrome as jsyndrome
    from qkd_ldpc_v_tpu.ops.decoders import get_decoder as jget_decoder

    jm = jgenerate_regular(512, 256, 3, seed=21)
    tm = hmatrix_from_rows(jm.check_nodes, jm.num_bit_nodes)
    _stub_prng(jpg, monkeypatch)
    plan = jpg.plan_for(jm)
    width = plan.bits.node_rows * 128
    n = jm.num_bit_nodes
    ne = 40
    qber = ne / n
    mc = jpg.make_pallas_generic_montecarlo(jm, JAlg[alg], CAP, False,
                                            batch=TILE, batch_tile=TILE,
                                            interpret=True, transport="f32")
    want = [np.asarray(x) for x in mc(3, ne, qber, f1, f2, 0.0)]

    idx_bits = max(1, (width - 1).bit_length())
    alice_flat = (_np_bits(0, width) & 1).astype(np.int8)
    pos = np.arange(width, dtype=np.uint32)[None, :]
    valid = np.zeros(width, bool)
    for _d, count, _blocks, noff, _eoff in plan.bits.groups:
        valid[noff * 128:noff * 128 + count] = True
    keys = ((_np_bits(1, width) >> np.uint32(idx_bits))
            << np.uint32(idx_bits)) | pos
    keys = np.where(valid[None, :], keys, np.uint32(ONES))
    flip = (keys <= np.sort(keys, axis=1)[:, ne - 1:ne]).astype(np.int8)
    plane_pos = np.asarray(plan.bits.plane_pos)
    alice = np.ascontiguousarray(alice_flat[:, plane_pos])
    bob = np.ascontiguousarray((alice_flat ^ flip)[:, plane_pos])
    assert ((alice ^ bob).sum(axis=1) == ne).all()
    jtrial = jpg.make_pallas_generic_trial(jm, JAlg[alg], CAP, False,
                                           batch_tile=TILE, interpret=True,
                                           transport="f32")
    for g, w in zip(jtrial(alice, bob, qber, f1, f2, 0.0), want):
        np.testing.assert_array_equal(np.asarray(g), w)

    trial = fused_generic.make_fused_generic_trial(tm, TAlg[alg], CAP, False)
    got = [x.numpy() for x in trial(torch.tensor(alice), torch.tensor(bob),
                                    log_ratio(qber), f1, f2, 0.0)]
    assert 0 < int(got[0].sum()) < TILE
    if TAlg[alg].is_adaptive:
        layout = jlayout_for(jm)
        lp = np.float32(log_ratio(qber))
        llr = np.where(bob == 1, -lp, lp).astype(np.float32)
        res = jget_decoder(layout, JAlg[alg], CAP, False, jit=False)(
            jnp.asarray(llr), jsyndrome(layout, jnp.asarray(alice)), f1, f2,
            0.0)
        conv = np.asarray(res.syndromes_match)
        want = [conv, conv & (np.asarray(res.decision) == alice).all(axis=1),
                np.asarray(res.iterations)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# The mc channel
# ---------------------------------------------------------------------------

SEED = chunk_seed(5, 1, 2)


@pytest.mark.parametrize("n,num_errors", [(1024, 25), (1024, 0), (288, 288),
                                          (102400, 3072)])
def test_mc_channel_flips_exactly(n, num_errors):
    frames = 2 if n > 10000 else 16
    alice, bob = mc_channel(SEED, 0, frames, n, num_errors, "cpu")
    assert alice.dtype == bob.dtype == torch.int8
    assert alice.shape == bob.shape == (frames, n)
    np.testing.assert_array_equal((alice ^ bob).sum(dim=1).numpy(),
                                  np.full(frames, num_errors))
    with pytest.raises(ValueError):
        mc_channel(SEED, 0, 1, n, n + 1, "cpu")


def test_mc_channel_statistics():
    """Alice's bits are fair (mean within 4 sigma of 0.5) and the error
    positions uniform (chi-squared over 16 equal buckets, p > 0.001)."""
    frames, n, ne = 64, 1024, 64
    alice, bob = mc_channel(SEED, 0, frames, n, ne, "cpu")
    count = frames * n
    assert abs(float(alice.double().mean()) - 0.5) < 4 * 0.5 / count ** 0.5
    positions = torch.nonzero(alice ^ bob)[:, 1].numpy()
    observed = np.bincount(positions * 16 // n, minlength=16)
    assert observed.sum() == frames * ne
    assert stats.chisquare(observed).pvalue > 0.001


def test_mc_channel_frames_do_not_depend_on_the_call():
    """Frames k .. k+m-1 of a chunk are the same whether drawn with the rest
    of the chunk or alone (frame0 = k); another chunk seed draws others."""
    whole = mc_channel(SEED, 0, 24, 1024, 30, "cpu")
    part = mc_channel(SEED, 9, 7, 1024, 30, "cpu")
    for w, p in zip(whole, part):
        assert torch.equal(w[9:16], p)
    other = mc_channel(chunk_seed(5, 1, 3), 0, 24, 1024, 30, "cpu")
    assert not torch.equal(whole[0], other[0])
    assert not torch.equal(whole[0] ^ whole[1], other[0] ^ other[1])
    alice_words = stream_words(SEED, 0, 24, 1024, ALICE, "cpu")
    assert torch.equal(whole[0], (alice_words & 1).to(torch.int8))


def test_mc_wrappers_check_inputs():
    qc = qc_from_arrays(jgenerate_qc(8, 4, 128, 3, seed=5).shifts, 128)
    mc = fused_qc.make_fused_qc_montecarlo(qc, TAlg.NMSA, CAP, False)
    with pytest.raises(ValueError, match="num_errors"):
        mc(SEED, 0, 4, 1025, 3.0, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        mc(SEED, -1, 4, 10, 3.0, device="cpu")
    with pytest.raises(ValueError, match="seed"):
        mc(-1, 0, 4, 10, 3.0, device="cpu")
    fused_qc.reset_counts()
    with pytest.raises(NotImplementedError, match="meta"):
        mc(SEED, 0, 4, 10, 3.0, device="meta")
    assert fused_qc.COUNTS.mc_launches == 0 and not fused_qc.COUNTS.plain_calls


# ---------------------------------------------------------------------------
# Routing in run_combination
# ---------------------------------------------------------------------------


def _cfg(fmt, **kw):
    base = dict(trials_number=12, simulation_seed=5,
                decoding_algorithm=JAlg.NMSA, decoding_alg_max_iterations=CAP,
                matrix_format=fmt,
                r_qber_ranges=(RQBERRange(0.99, 0.05, 0.05, 0.01),),
                batch_size=8, use_pallas=True)
    base.update(kw)
    return config_from_dict(dataclasses.asdict(Config(**base)))


def _codes():
    qc = qc_from_arrays(jgenerate_qc(8, 4, 128, 3, seed=5).shifts, 128)
    return {"qc": (qc.to_hmatrix(), MatrixFormat.QC, {}, fused_qc),
            "qc_stream": (qc.to_hmatrix(), MatrixFormat.QC,
                          {"force_engine": "qc_stream"}, qc_stream),
            "generic": (generate_regular_ldpc(512, 256, 3, seed=21),
                        MatrixFormat.ALIST, {}, fused_generic),
            # Inside the JAX package's stream gate: the N=22000 code of
            # tests/test_torch_simulation.py.
            "stream": (generate_regular_ldpc(22000, 11000, 3, seed=5),
                       MatrixFormat.ALIST, {"trials_number": 8},
                       generic_stream)}


@pytest.mark.parametrize("engine", ["qc", "qc_stream", "generic", "stream"])
@pytest.mark.parametrize("fed", [False, True], ids=["default", "key_source"])
def test_run_combination_routes_mc(engine, fed):
    matrix, fmt, kw, module = _codes()[engine]
    cfg = _cfg(fmt, **kw)
    assert tsim.select_engine(matrix, cfg) == engine
    comb = tsim.SimCombination(0.05, TParams(), tsim.ScalingFactors(0.8))
    source = tsim.default_key_source(cfg.simulation_seed, "cpu") if fed else None
    module.reset_counts()
    res = tsim.run_combination(matrix, comb, cfg, 0, "cpu", key_source=source)
    mc_expected = not fed and engine != "stream"
    assert (module.COUNTS.plain("mc") > 0) == mc_expected
    assert (module.COUNTS.plain("trial") > 0) == (not mc_expected)
    assert not any(module.counts()) and module.COUNTS.mc_launches == 0
    assert 0.0 < res.ratio_trials_success_decoding <= 1.0


def test_default_run_is_the_mc_plain_version():
    """A default CPU run's statistics are those of the mc plain version on
    each chunk's seed: the card's mc kernel equals that plain version, so a
    default run gives the same CSV on the CPU and on the card."""
    matrix, fmt, kw, _ = _codes()["qc"]
    cfg = _cfg(fmt, trials_number=8)
    comb = tsim.SimCombination(0.05, TParams(), tsim.ScalingFactors(0.8))
    res = tsim.run_combination(matrix, comb, cfg, 4, "cpu")
    n = matrix.num_bit_nodes
    ne = int(n * 0.05)
    mc = fused_qc.make_fused_qc_montecarlo(matrix.qc, TAlg.NMSA, CAP, False)
    conv, keys, iters = mc(chunk_seed(5, 4, 0), 0, 8, ne, log_ratio(ne / n),
                           0.8, 0.0, 0.0, device="cpu")
    assert res.ratio_trials_success_decoding == float(conv.double().mean())
    assert res.ratio_trials_success_ldpc == float((conv & keys).double().mean())
