"""Fused QC wrappers (qkd_ldpc_v_tpu_torch/ops/fused_qc.py).

On the CPU the wrappers run their plain torch versions; those must equal
the JAX package's fused Pallas kernel in interpret mode on the same keys,
exactly (conv, keys, iterations and, in decode mode, decisions). Each mode
is checked with NMSA and OMSA across both schedules. The launch counter
stays 0 on the CPU.

Tests marked ``cuda`` compare the CUDA kernel with its plain version on the
card and skip without one. They import no JAX, so on a machine without JAX
they run with the conftest left out:

    python -m pytest tests/test_torch_fused_qc.py -m cuda --noconftest -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu_torch import kernels
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm as TAlg
from qkd_ldpc_v_tpu_torch.models.qc import generate_qc_ldpc, read_qc_matrix
from qkd_ldpc_v_tpu_torch.ops import fused_qc
from qkd_ldpc_v_tpu_torch.ops.channel import (
    inject_errors,
    log_ratio,
    qc_syndrome,
)

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
    with pytest.raises(NotImplementedError, match="SPA"):
        fused_qc.make_fused_qc_trial(qc, TAlg.SPA_APPROX, CAP, False)


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
