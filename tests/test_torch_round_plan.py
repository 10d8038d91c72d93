"""The library rounds' plan (``protocol.round_plan``): what a round needs
that depends only on its spec and its device, built on the spec's first
round on a device and found by every later one.

In every case, rounds through a warm plan equal bit for bit the same
rounds on a fresh spec built from the same parameters, in all five
``ProtocolResult`` fields; the first round of a (spec, device) pair counts
one miss and the later ones hits; another device builds a plan of its own;
and a collected spec leaves no plan behind. The cases: fixed rate and rate
adaptive, privacy maintenance on and off, float32 (the fused generic or
streamed generic kernel's wrapper, on the CPU its plain version) and
float64 (the generic torch decoder), on the 10k alist code and on an
N=22000 code beyond ``generic_feasible`` that takes the streamed generic
decoder. The ``cuda`` cases run the same rounds on the card, then on the
CPU after it, and skip without one; they import no JAX:

    python -m pytest tests/test_torch_round_plan.py -m cuda --noconftest -q
"""

import gc
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu_torch import engines
from qkd_ldpc_v_tpu_torch import protocol as tp
from qkd_ldpc_v_tpu_torch import rate_adapt as tra
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm, MatrixFormat
from qkd_ldpc_v_tpu_torch.models.generator import generate_regular_ldpc
from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix
from qkd_ldpc_v_tpu_torch.ops.fused_generic import generic_feasible

torch.set_num_threads(2)

ALIST_10K = (Path(__file__).resolve().parents[1] / "sparse_matrices"
             / "matrices_alist" / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx")
CAP = 8
FRAMES = 4
SEEDS = (1, 2, 3)


@pytest.fixture(scope="module")
def codes():
    """name -> (code, the QBER its rate-adaptation point is set for)."""
    stream = generate_regular_ldpc(22000, 11000, 3, seed=5)
    assert not generic_feasible(stream)
    return {"alist10k": (read_matrix(ALIST_10K, MatrixFormat.ALIST), 0.03),
            "stream": (stream, 0.08)}


def _spec(code, qber, rate_adaptive, privacy, dtype):
    """A new spec; a rate-adaptive one from a new draw of the same point."""
    params = None
    if rate_adaptive:
        params = tra.adapt_code_rate(np.random.default_rng(3), code, qber,
                                     0.1, 1.3)
    return tp.make_protocol_spec(code, DecodingAlgorithm.NMSA, CAP, False,
                                 privacy, params=params, dtype=dtype)


def _blocks(n, qber, device):
    """Per seed: (Alice's N bits, Bob's, Alice's punctured draw) on
    ``device``; a round takes the leading bits it needs."""
    out = []
    for seed in SEEDS:
        gen = torch.Generator().manual_seed(seed)
        alice = torch.randint(0, 2, (FRAMES, n), generator=gen,
                              dtype=torch.int8)
        errors = (torch.rand(alice.shape, generator=gen) < qber / 3)
        punct = torch.randint(0, 2, (FRAMES, n), generator=gen,
                              dtype=torch.int8)
        out.append(tuple(x.to(device) for x in
                         (alice, alice ^ errors.to(torch.int8), punct)))
    return out


def _round(spec, block, qber):
    alice, bob, punct = block
    if not spec.rate_adaptive:
        return tp.qkd_ldpc(spec, alice, bob, qber, 0.8)
    n, p = spec.num_key_bits, len(spec.punctured_positions)
    return tp.qkd_ldpc_rate_adapt(
        spec, alice[:, :n].contiguous(), bob[:, :n].contiguous(), qber, None,
        0.8, alice_punct=punct[:, :p].contiguous())


def _assert_equal(got, want):
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _counts():
    return tp.PLAN_COUNTS.misses, tp.PLAN_COUNTS.hits


def _assert_plan(plan, spec, device):
    """The plan's tensors lie on ``device`` and hold the spec's arrays."""
    want = {"keep": spec.keep}
    if spec.rate_adaptive:
        want.update(payload=spec.payload_positions,
                    punctured=spec.punctured_positions,
                    shortened=spec.shortened_positions)
    else:
        assert plan.payload is plan.punctured is plan.shortened is None
    dtype = engines.DTYPES[spec.dtype]
    for name, array in want.items():
        t = getattr(plan, name)
        assert t.device == torch.device(device) and t.dtype == torch.int64
        if t.device.type != "meta":
            assert torch.equal(t.cpu(), torch.as_tensor(array.astype(np.int64)))
    for name in ("almost_zero", "llr_max"):
        t = getattr(plan, name)
        assert t.device == torch.device(device) and t.dtype == dtype
        assert t.shape == ()


def _assert_freed(ref, key):
    """Once the spec behind ``ref`` (``id`` ``key``) is collected, the
    cache holds no plan of it."""
    gc.collect()
    assert ref() is None
    assert [k for k in tp._PLANS._data if k[0] == key] == []


def _warm_rounds(make, blocks, qber):
    """(the spec, its rounds over ``blocks``, the plan counts they made)."""
    spec = make()
    tp.PLAN_COUNTS.reset()
    warm = [_round(spec, block, qber) for block in blocks]
    return spec, warm, _counts()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("privacy", [False, True],
                         ids=["no_privacy", "privacy"])
@pytest.mark.parametrize("rate_adaptive", [False, True],
                         ids=["fixed", "rate_adaptive"])
@pytest.mark.parametrize("code", ["alist10k", "stream"])
def test_rounds_through_a_warm_plan(codes, code, rate_adaptive, privacy,
                                    dtype):
    matrix, qber = codes[code]
    make = lambda: _spec(matrix, qber, rate_adaptive, privacy, dtype)  # noqa: E731
    blocks = _blocks(matrix.num_bit_nodes, qber, "cpu")
    spec, warm, counts = _warm_rounds(make, blocks, qber)
    assert counts == (1, len(blocks) - 1)
    for block, got in zip(blocks, warm):
        _assert_equal(got, _round(make(), block, qber))
    _assert_plan(tp.round_plan(spec, "cpu"), spec, "cpu")

    # Another device builds its own plan; the CPU's stays.
    tp.PLAN_COUNTS.reset()
    meta = tp.round_plan(spec, "meta")
    assert _counts() == (1, 0)
    _assert_plan(meta, spec, "meta")
    assert tp.round_plan(spec, "meta") is meta
    assert tp.round_plan(spec, "cpu") is not meta
    assert _counts() == (1, 2)

    ref, key = weakref.ref(spec), id(spec)
    del spec
    _assert_freed(ref, key)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the generic kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("rate_adaptive", [False, True],
                         ids=["fixed", "rate_adaptive"])
@pytest.mark.parametrize("code", ["alist10k", "stream"])
def test_card_rounds_through_a_warm_plan(cuda_device, codes, code,
                                         rate_adaptive):
    """On the card (the kernels' decode mode), then on the CPU after it:
    each device builds one plan, and the card's warm rounds equal the card
    rounds of fresh specs."""
    matrix, qber = codes[code]
    make = lambda: _spec(matrix, qber, rate_adaptive, True, "float32")  # noqa: E731
    blocks = _blocks(matrix.num_bit_nodes, qber, cuda_device)
    spec, warm, counts = _warm_rounds(make, blocks, qber)
    assert counts == (1, len(blocks) - 1)
    for block, got in zip(blocks, warm):
        _assert_equal(got, _round(make(), block, qber))
    card = tp.round_plan(spec, cuda_device)
    _assert_plan(card, spec, cuda_device)

    tp.PLAN_COUNTS.reset()
    cpu_blocks = _blocks(matrix.num_bit_nodes, qber, "cpu")
    on_cpu = [_round(spec, block, qber) for block in cpu_blocks]
    assert _counts() == (1, len(cpu_blocks) - 1)
    for block, got in zip(cpu_blocks, on_cpu):
        _assert_equal(got, _round(make(), block, qber))
    _assert_plan(tp.round_plan(spec, "cpu"), spec, "cpu")
    assert tp.round_plan(spec, cuda_device) is card

    ref, key = weakref.ref(spec), id(spec)
    del spec
    _assert_freed(ref, key)
