"""The port's distribution layer (qkd_ldpc_v_tpu_torch/parallel) on gloo
ranks on the CPU, the counterpart of tests/test_parallel.py.

One group of 4 ranks (tests/torch_parallel_worker.py, a ``FileStore``
under the test's temporary directory, a subgroup of ranks 0 and 1 for the
world-2 cases) runs every sharded case once; the tests read its results:
  * on the engines with an mc mode (``qc`` layered, ``qc_stream`` forced,
    ``generic``), a gathered run at world 2 and 4 equals the single-rank
    ``run_combination`` in every CSV column but throughput, with 23 trials
    in chunks of 10: frame-offset sharding decodes the single-rank frames;
  * reduce mode equals gathered mode: counts, min and max exactly, mean and
    std within rtol 1e-12;
  * the ``stream`` and ``xla`` engines and a rate-adaptive run (per-rank
    seeds, ``rank_chunk_seed``) equal one process fed the per-rank draws
    in rank order through ``key_source``;
  * ``psum_stats`` over 4 ranks equals JAX's over its CPU mesh;
  * the edge-sharded decoder equals JAX's and the port's unsharded decoder
    bit for bit, in float32 and float64;
  * rank 0 alone writes the checkpoint, and every rank resumes from it;
  * the NCCL check refuses two ranks on one card.
In-process: a world of one rank (no process group) equals
``run_combination`` exactly, the port's ``_run_chunks_reduced`` equals
JAX's on the same stub step, and the rule of ``rank_chunk_seed``.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from qkd_ldpc_v_tpu import simulation as jsim
from qkd_ldpc_v_tpu.config import Config as JConfig
from qkd_ldpc_v_tpu.config import DecodingAlgorithm as JAlg
from qkd_ldpc_v_tpu.models.layout import layout_for as jlayout_for
from qkd_ldpc_v_tpu.ops.decoders import make_decoder as jmake_decoder
from qkd_ldpc_v_tpu.parallel.driver import edge_sharded_decoder as jedge_decoder
from qkd_ldpc_v_tpu.parallel.driver import psum_stats as jpsum_stats
from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams as JParams
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.ops.channel import chunk_seed, rank_chunk_seed
from qkd_ldpc_v_tpu_torch.ops.decoders import check_row_edges, make_decoder
from qkd_ldpc_v_tpu_torch.parallel import driver
from tests import torch_parallel_worker as W

torch.set_num_threads(2)

GROUP_TIMEOUT_S = 120
THROUGHPUT = ("throughput_max", "throughput_min", "throughput_mean",
              "throughput_std")


def _without_throughput(fields):
    return {k: v for k, v in fields.items() if k not in THROUGHPUT}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every rank's results of the worker's ``cases`` mode, in rank order."""
    out = tmp_path_factory.mktemp("parallel")
    outcomes, _ = W.spawn("cases", f"file:{out / 'store'}", 4, out,
                          GROUP_TIMEOUT_S)
    failed = [f"rank {r}: rc={rc}\n{err[-3000:]}"
              for r, (rc, err) in enumerate(outcomes) if rc != 0]
    assert not failed, "\n".join(failed)
    results = []
    for rank in range(4):
        with open(out / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _single_rank(name, **kw):
    matrix, comb, cfg = W.run_setup(name)
    cfg = dataclasses.replace(cfg, **kw)
    return matrix, comb, cfg


@pytest.mark.parametrize("world", W.WORLDS)
@pytest.mark.parametrize("name", W.MC_RUNS)
def test_gathered_run_equals_single_rank(group, name, world):
    """Frame-offset sharding: every rank's result equals the single-rank
    run in every CSV column but throughput."""
    matrix, comb, cfg = W.run_setup(name)
    assert tsim.select_engine(matrix, cfg) == name
    want = dataclasses.asdict(
        tsim.run_combination(matrix, comb, cfg, W.SIM_NUMBER, "cpu"))
    assert 0.0 < want["ratio_trials_success_ldpc"] < 1.0
    for rank in range(world):
        got = group[rank][name, world, False]
        assert got["throughput_mean"] > 0
        assert _without_throughput(got) == _without_throughput(want), rank


@pytest.mark.parametrize("world", W.WORLDS)
@pytest.mark.parametrize("name", list(W.RUNS))
def test_reduce_mode_matches_gathered_mode(group, name, world):
    for rank in range(world):
        gathered = group[rank][name, world, False]
        reduced = group[rank][name, world, True]
        for key in ("ratio_trials_success_decoding",
                    "ratio_trials_success_ldpc", "iter_success_min",
                    "iter_success_max"):
            assert reduced[key] == gathered[key], (rank, key)
        for key in ("iter_success_mean", "iter_success_std"):
            np.testing.assert_allclose(reduced[key], gathered[key],
                                       rtol=1e-12, atol=0.0)
        assert reduced["throughput_mean"] > 0


@pytest.mark.parametrize("world", W.WORLDS)
@pytest.mark.parametrize("name", ["stream", "xla", "rate_adaptive"])
def test_per_rank_draws_equal_one_process_fed_them(group, name, world):
    """Paths that draw keys from the torch generator seed each rank's with
    ``rank_chunk_seed``: the sharded run equals one process whose
    ``key_source`` hands each chunk the ranks' draws in rank order."""
    matrix, comb, cfg = W.run_setup(name)
    local = -(-cfg.batch_size // world)
    source = W.per_rank_source(cfg.simulation_seed, world, local)
    want = dataclasses.asdict(tsim.run_combination(
        matrix, comb, cfg, W.SIM_NUMBER, "cpu", key_source=source))
    assert 0.0 < want["ratio_trials_success_decoding"]
    for rank in range(world):
        got = group[rank][name, world, False]
        assert _without_throughput(got) == _without_throughput(want), rank


def test_per_rank_draws_depend_on_the_world(group):
    """As in JAX, a run on the torch generator changes with the world
    size; the mc engines' does not."""
    xla = [group[0]["xla", world, False] for world in W.WORLDS]
    assert _without_throughput(xla[0]) != _without_throughput(xla[1])
    qc = [group[0]["qc", world, False] for world in W.WORLDS]
    assert _without_throughput(qc[0]) == _without_throughput(qc[1])


def test_psum_stats_matches_jax(group):
    """Four ranks of 16 frames each against JAX's ``psum_stats`` over its
    4-device CPU mesh on the same 64 frames."""
    syn, keys, iters = W.psum_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("data",))
    fn = shard_map(lambda s, k, i: jpsum_stats(s, k, i), mesh=mesh,
                   in_specs=(P("data"),) * 3, out_specs=(P(),) * 6,
                   check_vma=False)
    want = [float(x) for x in jax.device_get(
        fn(jnp.asarray(syn), jnp.asarray(keys), jnp.asarray(iters)))]
    sel = iters[syn].astype(np.float64)
    assert want[0] == syn.sum() and want[2] == sel.sum()
    for rank in range(4):
        got = group[rank]["psum"]
        for i in (0, 1, 2, 4, 5):  # counts, the iteration sum, min, max
            assert got[i] == want[i], (rank, i)
        np.testing.assert_allclose(got[3], want[3], rtol=1e-12, atol=0.0)
        np.testing.assert_allclose(got[3], ((sel - sel.mean()) ** 2).sum(),
                                   rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("world", W.WORLDS)
@pytest.mark.parametrize("dtype", W.EDGE_DTYPES, ids=str)
def test_edge_sharded_decoder_matches_unsharded_and_jax(group, medium_matrix,
                                                        dtype, world):
    """Decisions and iterations bit for bit: against the port's unsharded
    decoder and JAX's edge-sharded decoder over a 2-device ``model``
    mesh (NMSA, cap 30, QBER 0.03)."""
    layout, llr, syndrome = W.edge_inputs()
    plain = make_decoder(layout, DecodingAlgorithm.NMSA, 30, False, dtype)
    want = plain(torch.from_numpy(llr).to(dtype), torch.from_numpy(syndrome),
                 0.8, 1.0, 0.0)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    mesh = Mesh(np.asarray(jax.devices()[:2]), axis_names=("model",))
    jdecode = jedge_decoder(jlayout_for(medium_matrix), JAlg.NMSA, 30, mesh,
                            dtype=jdtype)
    jres = jdecode(jnp.asarray(llr, jdtype), jnp.asarray(syndrome), 0.8, 1.0,
                   0.0)
    jplain = jax.jit(jmake_decoder(jlayout_for(medium_matrix), JAlg.NMSA, 30,
                                   False, jdtype))(
        jnp.asarray(llr, jdtype), jnp.asarray(syndrome), 0.8, 1.0, 0.0)
    np.testing.assert_array_equal(np.asarray(jres.decision),
                                  np.asarray(jplain.decision))
    np.testing.assert_array_equal(want.decision.numpy(),
                                  np.asarray(jres.decision))
    np.testing.assert_array_equal(want.iterations.numpy(),
                                  np.asarray(jres.iterations))
    assert want.iterations.max() > 1
    for rank in range(world):
        decision, converged, iterations = group[rank]["edge", world, str(dtype)]
        np.testing.assert_array_equal(decision, want.decision.numpy())
        np.testing.assert_array_equal(converged,
                                      want.syndromes_match.numpy())
        np.testing.assert_array_equal(iterations, want.iterations.numpy())


def test_check_ranges_cut_at_check_boundaries():
    layout = W.edge_inputs()[0]
    for world in (1, 2, 3, 4, 7):
        ranges = driver.check_ranges(layout, world)
        assert ranges[0][0] == 0 and ranges[-1][1] == layout.num_checks
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        edges = [e1 - e0 for e0, e1 in (
            check_row_edges(layout, lo, hi) for lo, hi in ranges)]
        assert sum(edges) == layout.num_edges
        assert max(edges) - min(edges) <= 2 * max(g.degree for g in
                                                  layout.check_groups)


def test_rank_zero_alone_writes_the_checkpoint(group):
    written0, first0, again0, ticks0 = group[0]["checkpoint"]
    written1, first1, again1, ticks1 = group[1]["checkpoint"]
    assert written0 and not written1
    assert [_without_throughput(r) for r in first0] == \
        [_without_throughput(r) for r in first1]
    assert again0 == again1 == first0
    assert ticks0 == ticks1 == [2 * 23]


def test_nccl_check_refuses_two_ranks_on_one_card(group):
    assert group[0]["shared_cards"] == group[1]["shared_cards"] == [True, False]


# ---------------------------------------------------------------------------
# In one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce", [False, True], ids=["gathered", "reduced"])
@pytest.mark.parametrize("name", list(W.RUNS))
def test_world_of_one_equals_run_combination(name, reduce):
    """A mesh without a process group is a world of one rank: its
    collectives are the identity, rank 0 draws the single-rank keys, and the
    result equals ``run_combination``'s exactly (throughput off)."""
    matrix, comb, cfg = _single_rank(name, enable_throughput_measurement=False)
    mesh = driver.make_data_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.device) == (0, 1,
                                                         torch.device("cpu"))
    want = dataclasses.asdict(
        tsim.run_combination(matrix, comb, cfg, W.SIM_NUMBER, "cpu"))
    got = dataclasses.asdict(tsim.run_combination(
        matrix, comb, cfg, W.SIM_NUMBER, "cpu",
        step_factory=driver.mesh_step_factory(mesh, reduce_stats=reduce)))
    if not reduce:
        assert got == want
        return
    for key in ("iter_success_mean", "iter_success_std"):
        np.testing.assert_allclose(got.pop(key), want.pop(key), rtol=1e-12,
                                   atol=0.0)
    assert got == want


def _stub_steps():
    """Per-chunk six scalars: chunks with and without converged frames."""
    return [
        [(10.0, 9.0, 63.0, 20.5, 3.0, 12.0), (9.0, 9.0, 50.0, 8.0, 4.0, 7.0),
         (3.0, 2.0, 30.0, 2.0, 9.0, 11.0)],
        [(0.0, 0.0, 0.0, 0.0, 2147483647.0, -1.0),
         (7.0, 6.0, 21.0, 4.0, 1.0, 5.0), (0.0, 0.0, 0.0, 0.0, 2147483647.0,
                                           -1.0)],
        [(0.0, 0.0, 0.0, 0.0, 2147483647.0, -1.0)] * 3,
    ]


@pytest.mark.parametrize("chunks", _stub_steps(), ids=["all", "some", "none"])
def test_run_chunks_reduced_matches_jax(chunks, medium_matrix):
    """The port's ``_run_chunks_reduced`` and JAX's, fed the same stub step
    (23 trials in chunks of 10), give equal results."""
    jcfg = JConfig(trials_number=23, batch_size=10)
    matrix, comb, cfg = W.run_setup("generic")
    cfg = dataclasses.replace(cfg, enable_throughput_measurement=False)
    jcomb = jsim.SimCombination(comb.config_qber, JParams(),
                                jsim.ScalingFactors(0.8))

    def run(mod, m, c, cf):
        it = iter(chunks)
        ticks = []
        res = mod._run_chunks_reduced(
            m, c, cf, 1, 0.05859375, lambda *a: next(it), lambda *a: a, 10,
            23, 512, ticks.append)
        return dataclasses.asdict(res), ticks

    want, jticks = run(jsim, medium_matrix, jcomb, jcfg)
    got, tticks = run(tsim, matrix, comb, cfg)
    assert tticks == jticks == [10, 10, 3]
    assert got == want


def test_rank_chunk_seed_rule():
    """The first 64-bit word of SeedSequence([seed, sim, chunk, rank]),
    masked to 63 bits; rank 0 is ``chunk_seed``, at any seed."""
    for seed, sim_number, chunk in [(9, 1, 0), (42, 0, 7), (2**40 + 3, 5, 2)]:
        assert rank_chunk_seed(seed, sim_number, chunk, 0) == \
            chunk_seed(seed, sim_number, chunk)
        seeds = {rank_chunk_seed(seed, sim_number, chunk, r)
                 for r in range(8)}
        assert len(seeds) == 8
        for r in range(1, 8):
            word = np.random.SeedSequence(
                [seed, sim_number, chunk, r]).generate_state(1, np.uint64)[0]
            assert rank_chunk_seed(seed, sim_number, chunk, r) == \
                int(word) & ((1 << 63) - 1)
    assert rank_chunk_seed(9, 1, 0, 1) != rank_chunk_seed(9, 1, 1, 1)


def test_mesh_factory_rounds_up_and_caches():
    matrix, _, cfg = W.run_setup("generic")
    mesh = driver.DataMesh(rank=2, world_size=4, device=torch.device("cpu"))
    factory = driver.mesh_step_factory(mesh)
    assert factory.rank == 2
    step = factory(matrix, cfg, 10)
    assert factory(matrix, cfg, 10) is step
    assert factory(matrix, cfg, 12) is step  # both round up to 12
    assert factory(matrix, dataclasses.replace(cfg, simulation_seed=1),
                   10) is not step
    assert step.reduces is False and step.device == torch.device("cpu")
    with pytest.raises(ValueError, match="not divisible"):
        driver.sharded_step(matrix, cfg, 10, mesh)


def test_key_source_and_step_factory_raise_together():
    matrix, comb, cfg = W.run_setup("xla")
    with pytest.raises(ValueError, match="key_source"):
        tsim.run_combination(
            matrix, comb, cfg, 0, "cpu",
            key_source=tsim.default_key_source(9, "cpu"),
            step_factory=driver.mesh_step_factory(driver.make_data_mesh("cpu")))


def test_mesh_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            driver.make_data_mesh(device)


def test_initialize_distributed_one_process_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    driver.initialize_distributed()
    driver.initialize_distributed("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()


def test_traced_run_ignores_the_factory(capsys):
    """A traced run decodes on the host whatever the step factory, as the
    JAX package's does: the factory of a 4-rank mesh (whose step would need
    a process group) is never called."""
    matrix, comb, cfg = _single_rank(
        "xla", trials_number=4, batch_size=4, dtype="float64",
        trace_decoding_alg=True, enable_throughput_measurement=False)
    mesh = driver.DataMesh(rank=1, world_size=4, device=torch.device("cpu"))
    got = tsim.run_combination(matrix, comb, cfg, 0, "cpu",
                               step_factory=driver.mesh_step_factory(mesh))
    want = tsim.run_combination(matrix, comb, cfg, 0, "cpu")
    assert "--- iteration 1 ---" in capsys.readouterr().out
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
