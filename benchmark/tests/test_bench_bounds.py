"""The copied bound arithmetic against counts made by hand."""

import pytest

from benchmark.harness import bounds

N, M, E = 10240, 2841, 40960


def test_trial_bound_is_operations_at_the_10k_code():
    # 4096 frames, 10 iterations each: 13 ops x 40960 edges x 40960
    # iterations = 21,810,380,800 ops over 33.5e12/s = 0.651056 ms; bytes
    # 2 x 4096 x 10240 + 6 x 4096 = 83,910,656 B over 3.35e12/s = 0.025048 ms.
    ms, by = bounds.bound(4096, N, E, 4096 * 10, "flooding")
    assert by == "operations"
    assert ms == pytest.approx(13 * 40960 * 40960 / 33.5e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.651056, rel=1e-5)


def test_trial_bound_is_bytes_without_iterations():
    ms, by = bounds.bound(4096, N, E, 0, "flooding")
    assert by == "bytes"
    assert ms == pytest.approx((2 * 4096 * 10240 + 6 * 4096) / 3.35e12 * 1e3)


def test_frame_mode_reads_five_bytes_a_bit():
    ms, by = bounds.bound(1, 1000, 0, 0, "flooding", bytes_per_bit=5)
    assert (ms, by) == (pytest.approx((5000 + 6) / 3.35e12 * 1e3), "bytes")


def test_decode_bound_counts_llrs_syndrome_and_decisions():
    # 1024 frames: (5 x 10240 + 2841 + 5) B each = 54,046 B.
    ms, by = bounds.decode_bound(1024, N, M, E, 0, "flooding")
    assert by == "bytes"
    assert ms == pytest.approx(1024 * 54046 / 3.35e12 * 1e3)
    ms, by = bounds.decode_bound(1024, N, M, E, 1024 * 12, "layered")
    assert by == "operations"
    assert ms == pytest.approx(14 * E * 1024 * 12 / 33.5e12 * 1e3)


def test_mc_bound_takes_the_int32_lanes_where_they_bind():
    # 16384 frames, no iterations: 32 x 16384 x 10240 = 5,368,709,120
    # integer ops; alone on the INT32 lanes 0.321480 ms, in the issue
    # slots 0.160260 ms: the lanes bind.
    ms, by = bounds.mc_bound(16384, N, E, 0, "flooding")
    assert by == "operations"
    assert ms == pytest.approx(32 * 16384 * 10240 / 16.7e12 * 1e3)
    # With 10 iterations a frame the shared issue slots bind:
    # (13 x 40960 x 163840 + 5,368,709,120) / 33.5e12.
    ms, _ = bounds.mc_bound(16384, N, E, 16384 * 10, "flooding")
    want = (13 * 40960 * 163840 + 32 * 16384 * 10240) / 33.5e12 * 1e3
    assert ms == pytest.approx(want)


def test_spa_bound_takes_the_sfu_where_it_binds():
    ms, _ = bounds.spa_bound("decode", 1, N, M, E, 1000, "SPA")
    assert ms == pytest.approx(max(59 * E * 1000 / 33.5e12,
                                   4 * E * 1000 / 4.18e12) * 1e3)
