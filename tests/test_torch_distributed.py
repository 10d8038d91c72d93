"""Two processes through the port's ``initialize_distributed``, the
counterpart of tests/test_distributed.py.

Two CPU ranks (tests/torch_parallel_worker.py, mode ``reduce``) join a gloo
group through a localhost TCP coordinator and run the reduce-mode
``sharded_step`` on the conftest's medium code (SPA, 16 trials of which 13
count, the ``xla`` engine, so each rank draws its 8 frames from its own
``rank_chunk_seed`` generator) and the same chunk gathered. The six
scalars each rank reports must equal the single-rank scalars (the port's
``psum_stats`` in a world of one over the same frames) and JAX's
``psum_stats`` over its CPU mesh on the same per-frame arrays, and the
gathered frames must equal one process decoding the ranks' draws. A rank
that raises makes the group fail within its timeout, not hang. The
torchrun example (examples/sharded_sweep_torch.py) on two CPU ranks writes
the single-process run's CSV rows, throughput apart.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from qkd_ldpc_v_tpu.parallel.driver import psum_stats as jpsum_stats
from qkd_ldpc_v_tpu_torch import simulation as tsim
from qkd_ldpc_v_tpu_torch.config import parse_config_data
from qkd_ldpc_v_tpu_torch.parallel import driver
from tests import torch_parallel_worker as W

torch.set_num_threads(2)

GROUP_TIMEOUT_S = 120
FAIL_TIMEOUT_S = 60
REPO = Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "examples" / "sharded_sweep_torch.py"
QC1K = (REPO / "sparse_matrices" / "matrices_qc"
        / "(N=1024,M=384,R=0.62,CW=3,Z=128,SEED=33).mtrx")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("distributed")
    outcomes, _ = W.spawn("reduce", f"tcp:127.0.0.1:{_free_port()}", 2, out,
                          GROUP_TIMEOUT_S)
    failed = [f"rank {r}: rc={rc}\n{err[-3000:]}"
              for r, (rc, err) in enumerate(outcomes) if rc != 0]
    assert not failed, "\n".join(failed)
    results = []
    for rank in range(2):
        with open(out / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _masked(frames):
    syn, keys, iters = frames
    return syn & (np.arange(len(syn)) < W.REDUCE_TAKE), keys, iters


def _assert_stats_equal(got, want):
    for i in (0, 1, 2, 4, 5):  # counts, the iteration sum, min, max
        assert got[i] == want[i], i
    np.testing.assert_allclose(got[3], want[3], rtol=1e-12, atol=0.0)


def test_ranks_joined_one_group(ranks):
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]


def test_gathered_frames_equal_one_process_decoding_the_draws(ranks):
    matrix, cfg, args = W.reduce_setup()
    source = W.per_rank_source(cfg.simulation_seed, 2, W.REDUCE_TRIALS // 2)
    want = tsim.ChunkStep(matrix, cfg, "cpu", W.REDUCE_TRIALS,
                          key_source=source)(args, 0, W.REDUCE_TAKE)
    for r in ranks:
        for got, exp in zip(r["frames"], want):
            np.testing.assert_array_equal(got, exp)
    assert 0 < want[0][:W.REDUCE_TAKE].sum() <= W.REDUCE_TAKE


def test_reduce_scalars_equal_single_rank(ranks):
    """The single-rank scalars: ``psum_stats`` in a world of one over the
    gathered frames, the surplus three masked."""
    frames = [torch.from_numpy(np.asarray(a)) for a in
              _masked(ranks[0]["frames"])]
    want = driver.psum_stats(*frames, driver.make_data_mesh("cpu"))
    assert want[0] > 0
    for r in ranks:
        _assert_stats_equal(r["stats"], want)


def test_reduce_scalars_equal_jax_psum_stats(ranks):
    syn, keys, iters = _masked(ranks[0]["frames"])
    mesh = Mesh(np.asarray(jax.devices()[:2]), axis_names=("data",))
    fn = shard_map(lambda s, k, i: jpsum_stats(s, k, i), mesh=mesh,
                   in_specs=(P("data"),) * 3, out_specs=(P(),) * 6,
                   check_vma=False)
    want = [float(x) for x in jax.device_get(
        fn(jnp.asarray(syn), jnp.asarray(keys), jnp.asarray(iters)))]
    for r in ranks:
        _assert_stats_equal(r["stats"], want)


def test_a_failing_rank_fails_the_group(tmp_path):
    """Rank 1 raises once the group is up; rank 0, inside a collective,
    must fail too (gloo reports the closed peer, or the group's timeout
    expires), and neither may hang."""
    outcomes, seconds = W.spawn("fail", f"file:{tmp_path / 'store'}", 2,
                                tmp_path, FAIL_TIMEOUT_S)
    codes = [rc for rc, _ in outcomes]
    assert None not in codes, f"a rank hung: {outcomes}"
    assert all(rc != 0 for rc in codes), outcomes
    assert "fails on purpose" in outcomes[1][1]
    assert seconds < FAIL_TIMEOUT_S


def _rows(directory):
    """The CSV's rows without the throughput columns."""
    (path,) = directory.glob("*.csv")
    header, *lines = path.read_text().splitlines()
    names = header.split(";")
    return [{k: v for k, v in zip(names, line.split(";"))
             if not k.startswith("THROUGHPUT")} for line in lines]


def test_torchrun_example_writes_the_single_process_rows(tmp_path):
    """configs/example_qc_layered.json on the 1k QC code, 48 trials in
    chunks of 20, under ``torchrun --standalone`` with two CPU ranks."""
    cfg = json.loads((REPO / "configs" / "example_qc_layered.json").read_text())
    cfg["trials_number"] = 48
    cfg["tpu"]["batch_size"] = 20
    cfg["code_rate_QBER_ranges"][0]["QBER"] = {"begin": 0.055, "end": 0.055,
                                               "step": 0.01}
    (tmp_path / "run.json").write_text(json.dumps(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(EXAMPLE), str(tmp_path / "run.json"),
         str(QC1K), str(tmp_path / "ranks"), "--device", "cpu"],
        capture_output=True, text=True, timeout=GROUP_TIMEOUT_S, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "2 ranks:" in proc.stdout
    config = parse_config_data(tmp_path / "run.json")
    results = tsim.qkd_ldpc_batch_simulation(
        tsim.prepare_sim_inputs([QC1K], config), config, "cpu")
    assert 0.0 < results[0].ratio_trials_success_ldpc < 1.0
    tsim.write_file(results, config, "00h-00m-00s", tmp_path / "single")
    assert _rows(tmp_path / "ranks") == _rows(tmp_path / "single")
