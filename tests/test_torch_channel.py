"""Port channel (qkd_ldpc_v_tpu_torch/ops/channel.py) against the JAX
package's channel on the same random bits.

``inject_errors`` must flip exactly the positions JAX flips when both get
the bits of ``jax.random.bits(ke, (B, N), uint32)``: the 64-bit sort keys
against JAX with x64 on (as the test conftest sets it), the 32-bit keys
against JAX inside ``jax.enable_x64(False)``. On words that are hard for
a selection by high bits (``inject_cases``: equal words, words in one bin,
the unsigned order's edges; no, one, all but one and all errors; sizes that
are not powers of two), it must flip the positions NumPy's lexsort on (hi,
position) puts first, in both key widths, and count one plain call on the
CPU and no launch; on CUDA tensors the select kernel launches inside a
registered operator that has no CPU kernel. ``log_ratio`` must give JAX's float32 bits at the QBERs
the cross-package tests use.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_v_tpu.models.layout import layout_for
from qkd_ldpc_v_tpu.models.qc import generate_qc_ldpc, generate_qc_peg
from qkd_ldpc_v_tpu.ops import channel as jch
from qkd_ldpc_v_tpu_torch.convert import qc_from_arrays
from qkd_ldpc_v_tpu_torch.ops import channel as tch

import inject_cases  # tests/inject_cases.py: pytest puts tests/ on the path

torch.set_num_threads(2)


def _jax_bits(seed, batch, n):
    ka, ke, _ = jch.trial_keys(seed, 0, 0)
    alice = np.asarray(jch.generate_keys(ka, batch, n))
    bits = np.asarray(jax.random.bits(ke, (batch, n), jnp.uint32))
    return ka, ke, alice, bits


@pytest.mark.parametrize("n,num_errors", [(1024, 30), (10240, 307), (4096, 1)])
def test_inject_errors_wide_matches_jax(n, num_errors):
    _, ke, alice, bits = _jax_bits(11, 6, n)
    assert jax.config.jax_enable_x64
    want = np.asarray(jch.inject_errors(ke, jnp.asarray(alice), num_errors))
    got = tch.inject_errors(torch.tensor(bits.astype(np.int64)),
                            torch.tensor(alice), num_errors, wide=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((got.numpy() ^ alice).sum(axis=1) == num_errors).all()


@pytest.mark.parametrize("n,num_errors", [(1024, 30), (10240, 307)])
def test_inject_errors_narrow_matches_jax_without_x64(n, num_errors):
    _, ke, alice, bits = _jax_bits(12, 6, n)
    with jax.enable_x64(False):
        assert not jax.config.jax_enable_x64
        want = np.asarray(jch.inject_errors(ke, jnp.asarray(alice), num_errors))
    got = tch.inject_errors(torch.tensor(bits.astype(np.int64)),
                            torch.tensor(alice), num_errors, wide=False)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wide_keys_keep_unsigned_order():
    """Random words at or above 2**31 must still rank above smaller ones:
    a plain signed ``bits << 32`` would put them first."""
    n = 8
    bits = np.array([[2**32 - 1, 5, 2**31, 7, 2**31 - 1, 0, 3, 2**31 + 9]],
                    dtype=np.int64)
    alice = torch.zeros((1, n), dtype=torch.int8)
    bob = tch.inject_errors(torch.tensor(bits), alice, 4, wide=True)
    order = np.argsort(bits[0].astype(np.uint64), kind="stable")
    want = np.zeros(n, np.int8)
    want[order[:4]] = 1
    np.testing.assert_array_equal(bob.numpy()[0], want)


@pytest.mark.parametrize("which", inject_cases.COUNTS)
@pytest.mark.parametrize("wide", [True, False], ids=["wide", "narrow"])
@pytest.mark.parametrize("n", inject_cases.SIZES)
@pytest.mark.parametrize("kind", inject_cases.KINDS)
def test_inject_errors_flips_the_smallest_keys(kind, n, wide, which):
    words = inject_cases.words(kind, 3, n, seed=n)
    alice = np.random.default_rng(1).integers(0, 2, (3, n), dtype=np.int8)
    num_errors = inject_cases.error_count(which, n)
    tch.INJECT_COUNTS.reset()
    bob = tch.inject_errors(torch.tensor(words), torch.tensor(alice),
                            num_errors, wide)
    assert tch.INJECT_COUNTS.plain_calls == {("cpu", "inject"): 1}
    assert tch.INJECT_COUNTS.launches == 0
    np.testing.assert_array_equal(
        bob.numpy() ^ alice,
        inject_cases.expected_flips(words, num_errors, wide))


def test_select_kernel_launches_inside_a_cuda_only_operator():
    """The select kernel's launch is a registered operator (which a profiler
    links the kernel's device time to) with a CUDA kernel and none for the
    CPU, and registering it imports no ``torch._dynamo``."""
    op = torch.ops.qkd_ldpc_v_tpu_torch.inject_select.default
    assert tch._SELECT is op
    assert str(op._schema) == (
        "qkd_ldpc_v_tpu_torch::inject_select(Tensor words, Tensor alice, "
        "int num_errors, bool narrow) -> Tensor")
    name = "qkd_ldpc_v_tpu_torch::inject_select"
    assert torch._C._dispatch_has_kernel_for_dispatch_key(name, "CUDA")
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(name, "CPU")
    code = ("import sys, qkd_ldpc_v_tpu_torch.ops.channel; "
            "print('torch._dynamo' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=Path(__file__).resolve().parents[1]).stdout
    assert out.strip() == "False"


def test_qc_syndrome_matches_calculate_syndrome():
    jqc = generate_qc_peg(20, 6, 128, 4, seed=9)
    tqc = qc_from_arrays(jqc.shifts, jqc.lifting)
    _, _, alice, _ = _jax_bits(5, 4, jqc.num_bit_nodes)
    want = np.asarray(jch.calculate_syndrome(layout_for(jqc.to_hmatrix()),
                                             jnp.asarray(alice)))
    got = tch.qc_syndrome(tqc, torch.tensor(alice))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,qber", [
    (1024, 0.02), (1024, 0.03), (1024, 0.04), (1024, 0.045), (1024, 0.075),
    (10240, 0.02), (10240, 0.03), (10240, 0.04), (10240, 0.045),
])
def test_log_ratio_matches_jax_bits(n, qber):
    acc = tch.exact_error_count(n, qber) / n
    jlog = jax.jit(lambda q: jnp.log((1.0 - q) / q))
    want = np.float32(jlog(jnp.float32(acc)))
    assert np.float32(tch.log_ratio(acc)).tobytes() == want.tobytes()


def test_exact_error_count_and_keys():
    assert tch.exact_error_count(10240, 0.03) == jch.exact_error_count(10240, 0.03)
    gen = torch.Generator().manual_seed(tch.chunk_seed(42, 0, 0))
    alice = tch.generate_keys(gen, 4, 256, "cpu")
    bits = tch.random_bits(gen, 4, 256, "cpu")
    assert alice.dtype == torch.int8 and set(alice.unique().tolist()) <= {0, 1}
    assert bits.min() >= 0 and bits.max() < 2**32
    seeds = {tch.chunk_seed(42, s, c) for s in range(3) for c in range(3)}
    assert len(seeds) == 9
    assert tch.chunk_seed(42, 1, 2) == tch.chunk_seed(42, 1, 2)
    qc = qc_from_arrays(generate_qc_ldpc(8, 4, 128, 3, seed=5).shifts, 128)
    assert qc.num_bit_nodes == 1024


@pytest.mark.parametrize("n,qber", [(1024, 0.05), (10240, 0.025), (10240, 0.032)])
def test_log_ratio_f64_matches_jax_bits(n, qber):
    """The float64 engine's channel LLR: JAX's f64 log of the f64 ratio."""
    acc = tch.exact_error_count(n, qber) / n
    want = np.float64(jax.jit(lambda q: jnp.log((1.0 - q) / q))(
        jnp.asarray(acc, jnp.float64)))
    got = tch.log_ratio(acc, torch.float64)
    assert np.float64(got).tobytes() == want.tobytes()


def _irregular_matrices():
    from qkd_ldpc_v_tpu.models.hmatrix import from_dense as jfrom_dense
    from qkd_ldpc_v_tpu_torch.models.hmatrix import from_dense as tfrom_dense

    rng = np.random.default_rng(11)
    dense = (rng.random((40, 100)) < 0.08).astype(np.int8)
    dense[np.arange(40), rng.integers(0, 100, 40)] = 1
    dense[rng.integers(0, 40, 100), np.arange(100)] = 1
    return jfrom_dense(dense), tfrom_dense(dense)


def test_layout_syndromes_match_jax():
    from qkd_ldpc_v_tpu_torch.models.layout import compile_layout

    jm, tm = _irregular_matrices()
    jl, tl = layout_for(jm), compile_layout(tm)
    _, _, alice, _ = _jax_bits(6, 5, tm.num_bit_nodes)
    want = np.asarray(jch.calculate_syndrome(jl, jnp.asarray(alice)))
    got = tch.calculate_syndrome(tl, torch.tensor(alice))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    bits_int = alice[:, jl.bit_order]
    np.testing.assert_array_equal(
        tch.syndrome_internal(tl, torch.tensor(bits_int)).numpy(),
        np.asarray(jch.syndrome_internal(jl, jnp.asarray(bits_int))))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_llr_from_bits_matches_jax(dtype):
    _, _, alice, _ = _jax_bits(7, 3, 64)
    want = np.asarray(jch.llr_from_bits(jnp.asarray(alice), 0.031, jnp.dtype(dtype)))
    got = tch.llr_from_bits(torch.tensor(alice), 0.031, getattr(torch, dtype))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
