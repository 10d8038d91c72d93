"""The reference: its decoder on frames built and worked by hand, and its
keys, adaptation points and decodes against the port's plain versions
(on the CPU, where the port runs them)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import adapt, channel, compare
from benchmark.reference.alist import read_alist
from benchmark.reference.decoder import Graph, decode

HERE = Path(__file__).resolve().parents[1]
CODE10K = HERE / "configs" / "alist10k.mtrx"


def write_alist(path, rows, n):
    cols = [[j for j, r in enumerate(rows) if i in r] for i in range(n)]
    dv, dc = max(map(len, cols)), max(map(len, rows))
    lines = [f"{n} {len(rows)}", f"{dv} {dc}",
             " ".join(str(len(c)) for c in cols),
             " ".join(str(len(r)) for r in rows)]
    lines += [" ".join(str(j + 1) for j in c) + " 0" * (dv - len(c)) for c in cols]
    lines += [" ".join(str(i + 1) for i in r) + " 0" * (dc - len(r)) for r in rows]
    path.write_text("\n".join(lines) + "\n")
    return read_alist(path)


@pytest.fixture
def one_check(tmp_path):
    """A single check over three bits: Alice's key 000, syndrome 0."""
    return Graph(write_alist(tmp_path / "c.alist", [[0, 1, 2]], 3), "cpu")


def run(graph, llr, alg, primary, secondary=1.0, cap=5):
    res = decode(graph, torch.tensor([llr], dtype=torch.float32),
                 torch.zeros((1, 1), dtype=torch.int8), alg, primary,
                 secondary, cap)
    return (bool(res.converged[0]), int(res.iterations[0]),
            res.decision[0].tolist())


def test_hand_worked_check_updates(one_check):
    # LLRs 2, -1, 3: |m| minima 1 (bit 1) and 2; one negative message, so
    # the row sign is -1. NMSA 0.5 gives -0.5, +1.0, -0.5: totals 1.5, 0,
    # 2.5, decisions 0 1 0 (0 <= 0 decides 1), and the same messages again
    # every iteration: the cap, unconverged.
    assert run(one_check, [2.0, -1.0, 3.0], "NMSA", 0.5) == (False, 5, [0, 1, 0])
    # NMSA 1.0: -1, +2, -1, totals 1 1 2: converged after one iteration.
    assert run(one_check, [2.0, -1.0, 3.0], "NMSA", 1.0) == (True, 1, [0, 0, 0])
    # OMSA 0.5: max(excluded - 0.5, 0) = 0.5, 1.5, 0.5: totals 1.5 0.5 2.5.
    assert run(one_check, [2.0, -1.0, 3.0], "OMSA", 0.5) == (True, 1, [0, 0, 0])


def test_a_tie_at_the_minimum_and_a_zero_message(one_check):
    # A tie (|m| 1, 1, 3) makes min2 = min1 = 1: NMSA 1.0 sends -1, +1, -1,
    # totals 0 0 2, decisions 1 1 0: the syndrome matches, the key not.
    assert run(one_check, [1.0, -1.0, 3.0], "NMSA", 1.0) == (True, 1, [1, 1, 0])
    # A zero message counts as non-negative in the parity and takes the
    # sign -1 as its own: row sign +1, excluded 2, 0, 0, so bit 0 gets -2
    # and decides 1; the same messages recur to the cap.
    assert run(one_check, [0.0, 2.0, 3.0], "NMSA", 1.0) == (False, 5, [1, 0, 0])


def test_the_adaptive_pair_tests_the_previous_decisions(one_check):
    # AOMSA: the channel's decisions 0 1 0 leave the check unsatisfied, so
    # it takes the secondary offset 0.5: totals 1.5 0.5 2.5, decisions 000,
    # found converged at the start of the second iteration: 2.
    assert run(one_check, [2.0, -1.0, 3.0], "AOMSA", 1.0, 0.5) == (True, 2, [0, 0, 0])
    # With the offsets swapped the unsatisfied check takes 1.0: messages
    # 0, 1, 0, totals 2 0 3, the same decisions every time: the cap.
    assert run(one_check, [2.0, -1.0, 3.0], "AOMSA", 0.5, 1.0) == (False, 5, [0, 1, 0])


def test_mc_keys_equal_the_ports_mc_channel():
    from qkd_ldpc_v_tpu_torch.ops.channel import chunk_seed, mc_channel

    seed = chunk_seed(2**31 + 5, 3, 1)
    assert seed == channel.chunk_seed(2**31 + 5, 3, 1)
    alice, bob = channel.mc_keys(seed, 40, 6, 10240, 307, "cpu")
    pa, pb = mc_channel(seed, 40, 6, 10240, 307, "cpu")
    assert torch.equal(alice, pa) and torch.equal(bob, pb)
    assert ((alice ^ bob).sum(dim=1) == 307).all()


def test_generator_keys_equal_the_ports_default_draw():
    from qkd_ldpc_v_tpu_torch.ops.channel import inject_errors
    from qkd_ldpc_v_tpu_torch.simulation import default_key_source

    alice, bits = default_key_source(77, "cpu")(2, 0, 5, 1000)
    bob = inject_errors(bits, alice, 35, wide=True)
    ra, rb = channel.generator_keys(channel.chunk_seed(77, 2, 0), 5, 1000, 35, "cpu")
    assert torch.equal(ra, alice) and torch.equal(rb, bob)


def test_log_ratios_equal_the_ports():
    from qkd_ldpc_v_tpu_torch.ops.channel import llr_from_bits, log_ratio

    for q in (0.02, 358 / 10240, 0.0252):
        assert channel.sweep_log_ratio(q) == log_ratio(q, torch.float32)
        assert channel.round_log_ratio(q) == float(
            llr_from_bits(torch.zeros(1, dtype=torch.int8), q)[0])


def test_adaptation_points_equal_the_ports(tmp_path):
    from qkd_ldpc_v_tpu_torch.config import parse_config_data
    from qkd_ldpc_v_tpu_torch.simulation import prepare_sim_inputs

    from benchmark.drivers import rounds

    w = json.loads((HERE / "workloads" / "alist10k-rounds.json").read_text())
    pc = dict(w["program_config"], simulation_seed=w["config_seed"],
              matrix_format=1)
    (tmp_path / "run.json").write_text(json.dumps(pc))
    cfg = parse_config_data(tmp_path / "run.json")
    combos = prepare_sim_inputs([CODE10K], cfg)[0].combinations
    code = read_alist(CODE10K)
    pts = rounds.reference_points(code, HERE / "configs" / "alist10k.untp", w)
    assert len(pts) == len(combos) == w["specs"]
    for point, comb in zip(pts, combos):
        mp = comb.matrix_params
        assert (point.delta, point.efficiency) == (mp.delta, mp.efficiency)
        assert np.array_equal(point.punctured, mp.punctured_bits)
        assert np.array_equal(point.shortened, mp.shortened_bits)
        assert np.array_equal(point.removed, mp.bits_to_remove)


@pytest.mark.parametrize("change,faults", [
    ("none", 0), ("tainted", 1), ("short", 1), ("reversed", 1)])
def test_the_untainted_list_is_held_to_the_greedy(change, faults):
    code = read_alist(CODE10K)
    listed = adapt.read_untainted(HERE / "configs" / "alist10k.untp")
    if change == "tainted":
        first = int(listed[0])
        listed[1] = next(int(b) for b in code.rows[code.cols[first][0]]
                         if b != first)
    elif change == "short":
        listed = listed[:-1]
    elif change == "reversed":
        listed = listed[::-1]
    assert min(adapt.untainted_faults(code, listed), 1) == faults


@pytest.mark.parametrize("alg,primary,secondary", [
    ("NMSA", 0.7, 1.0), ("OMSA", 0.3, 1.0), ("ANMSA", 0.7, 0.9),
    ("AOMSA", 0.5, 1.0)])
def test_decoder_equals_the_ports_plain_decoder(alg, primary, secondary):
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm, MatrixFormat
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix
    from qkd_ldpc_v_tpu_torch.models.layout import layout_for
    from qkd_ldpc_v_tpu_torch.ops.channel import calculate_syndrome
    from qkd_ldpc_v_tpu_torch.ops.decoders import get_decoder

    matrix = read_matrix(CODE10K, MatrixFormat.ALIST)
    layout = layout_for(matrix)
    plain = get_decoder(layout, DecodingAlgorithm[alg], 40, False)
    graph = Graph(read_alist(CODE10K), "cpu")
    alice, bob = channel.mc_keys(channel.chunk_seed(9, 0, 0), 0, 24, 10240,
                                 int(10240 * 0.028), "cpu")
    llr = channel.llr(bob, channel.sweep_log_ratio(0.028), torch.float32)
    # Shortened- and punctured-like positions, as rate-adapted frames have.
    llr[:, :300] = torch.finfo(torch.float32).max
    alice[:, :300] = 0
    llr[:, 300:340] = 1e-4
    syn = calculate_syndrome(layout, alice)
    assert torch.equal(syn, graph.syndrome(alice))
    want = plain(llr, syn, primary, secondary, 0.0)
    got = decode(graph, llr, syn, alg, primary, secondary, 40)
    assert torch.equal(got.converged, want.syndromes_match)
    assert torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.decision, want.decision)
    assert got.iterations.unique().numel() > 1


def test_statistics_and_gaps():
    o = compare.Outcome(np.array([1, 1, 0, 1], bool), np.array([1, 0, 0, 1], bool),
                        np.array([3, 5, 100, 4]))
    s = compare.statistics(o)
    assert s == {"ratio_dec": 0.75, "ratio_ldpc": 0.5, "iter_mean": 4.0,
                 "iter_std": pytest.approx(np.sqrt(2 / 3)), "iter_min": 3.0,
                 "iter_max": 5.0}
    assert compare.stats_gap(dict(s, iter_mean=4.4), s) == pytest.approx(0.1)
    changed = compare.Outcome(o.converged, o.keys, np.array([3, 5, 100, 5]))
    assert compare.mismatched(changed, o) == 1
    assert adapt.expand(1.3, 1.5, 0.1) == [1.3, 1.3 + 0.1, 1.3 + 2 * 0.1]
