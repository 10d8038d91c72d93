"""A FER-curve sweep: whole passes over the cell's QBER points, each point
one ``simulation.run_combination`` of ``trials`` frames in chunks of
``chunk`` frames, one combination number after another (the pass's
points take the next numbers, so every combination draws its own keys).

Workload keys: ``qber`` (the points), ``trials``, ``chunk``, ``algorithm``
(NMSA, OMSA, ANMSA, AOMSA), ``primary``, ``secondary``, ``keys`` ("mc" or
"generator": how the port draws this engine's keys, which the reference
follows), ``trace_passes`` (passes in the traced window) and ``compare``
(``combinations``: how many of the window's combinations the reference
decodes again, drawn from the seed; ``limits``).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import List

import numpy as np

from benchmark.harness import trace
from benchmark.reference import compare
from benchmark.reference.alist import read_alist
from benchmark.reference.decoder import Graph

# Combination numbers of the warm-up, apart from the window's.
WARMUP_NUMBER = 1 << 30


class Recorder:
    """A chunk step that keeps each chunk's per-frame outcomes as the
    program's step returns them."""

    reduces = False

    def __init__(self, step, log: list) -> None:
        self.step = step
        self.device = step.device
        self.log = log

    def __call__(self, args, chunk_index, take):
        out = self.step(args, chunk_index, take)
        self.log.append(tuple(np.asarray(x)[:take] for x in out))
        return out


class Cell:
    kind = "sweep"

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.w = ctx.workload
        self.seed = ctx.seed
        self.number = 0
        self.seen = 0
        self.sample: List[tuple] = []
        self.pick = np.random.default_rng([ctx.seed, 1])
        self.traced_chunks: List[dict] = []
        self.trace = None

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        self._program()
        # One chunk through every point: the kernel library, the tables on
        # the card and the channel's shapes.
        warm = dataclasses.replace(self.cfg, trials_number=self.w["chunk"])
        for i, comb in enumerate(self.combos):
            self.sim.run_combination(self.matrix, comb, warm,
                                     WARMUP_NUMBER + i, self.device,
                                     step_factory=self._factory([]))
        self.ctx.synchronize()

    def _program(self) -> None:
        from qkd_ldpc_v_tpu_torch import simulation as sim
        from qkd_ldpc_v_tpu_torch.config import (Config, DecodingAlgorithm,
                                                 MatrixFormat)
        from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix
        from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams

        w, c = self.w, self.ctx.config
        self.sim = sim
        self.torch = self.ctx.torch
        self.device = self.ctx.device
        self.matrix = read_matrix(self.ctx.path(c["matrix"]), MatrixFormat.ALIST)
        self.cfg = Config(
            trials_number=w["trials"], simulation_seed=self.seed,
            decoding_algorithm=DecodingAlgorithm[w["algorithm"]],
            decoding_alg_max_iterations=c["max_iterations"],
            matrix_format=MatrixFormat.ALIST, batch_size=w["chunk"],
            dtype=c["dtype"], use_pallas=True, schedule=c["schedule"])
        factors = sim.ScalingFactors(primary=w["primary"],
                                     secondary=w["secondary"])
        self.combos = [sim.SimCombination(q, HMatrixParams(), factors)
                       for q in w["qber"]]

    def _factory(self, log):
        """The ``step_factory`` that ``run_combination`` gets: the port's
        own chunk step, recorded."""
        def factory(matrix, cfg, batch):
            return Recorder(self.sim.ChunkStep(matrix, cfg, self.device,
                                               batch), log)
        return factory

    def _chunks(self, log):
        return [{"frames": len(iters),
                 "iterations": int(iters.astype(np.int64).sum())}
                for _, _, iters in log]

    def _outcome(self, log):
        return compare.Outcome(*(np.concatenate([x[i] for x in log])
                                 for i in range(3)))

    # -- the window -----------------------------------------------------
    def _combination(self, point: int, chunks: list) -> None:
        log: list = []
        number = self.number
        self.number += 1
        with self.torch.profiler.record_function("bench.combination"):
            result = self.sim.run_combination(
                self.matrix, self.combos[point], self.cfg, number, self.device,
                step_factory=self._factory(log))
        chunks.extend(self._chunks(log))
        self._keep((point, number, result, self._outcome(log)))

    def _keep(self, entry) -> None:
        """Reservoir sample of the combinations, drawn from the seed."""
        k = self.w["compare"]["combinations"]
        if len(self.sample) < k:
            self.sample.append(entry)
        else:
            j = int(self.pick.integers(0, self.seen + 1))
            if j < k:
                self.sample[j] = entry
        self.seen += 1

    def _passes(self, stop, chunks) -> int:
        frames = 0
        while True:
            for point in range(len(self.combos)):
                self._combination(point, chunks)
                frames += self.w["trials"]
            if stop():
                return frames

    def run_window(self, seconds: float) -> dict:
        chunks: list = []
        t0 = time.perf_counter()
        frames = self._passes(lambda: self._stop(t0, seconds), chunks)
        elapsed = time.perf_counter() - t0
        self.attempted = frames
        return {"frames_per_s": frames / elapsed}

    def _stop(self, t0: float, seconds: float) -> bool:
        return time.perf_counter() - t0 >= seconds

    def run_traced(self) -> None:
        left = [self.w["trace_passes"]]

        def stop():
            left[0] -= 1
            return left[0] <= 0

        with trace.traced() as holder:
            with self.torch.profiler.record_function(trace.WINDOW):
                self._passes(stop, self.traced_chunks)
                self.ctx.synchronize()
        self.trace = holder[0]

    def release(self) -> None:
        del self.matrix, self.combos, self.sim
        gc.collect()
        self.ctx.empty_cache()

    # -- correctness ----------------------------------------------------
    def compare(self) -> dict:
        w, c = self.w, self.ctx.config
        graph = Graph(read_alist(self.ctx.path(c["matrix"])), self.device)
        frames = wrong = 0
        gap = 0.0
        for point, number, result, got in self.sample:
            want = compare.sweep_combination(
                graph, w["keys"], self.seed, number, w["qber"][point],
                w["trials"], w["chunk"], w["algorithm"], w["primary"],
                w["secondary"], c["max_iterations"])
            frames += len(want.iterations)
            wrong += compare.mismatched(got, want)
            gap = max(gap, compare.stats_gap(program_stats(result),
                                             compare.statistics(want)))
        return {"frame_mismatch": wrong / max(frames, 1), "stats_gap": gap}

    # -- per-layer readings ---------------------------------------------
    def layer(self) -> dict:
        c = self.ctx.config
        return {"kind": self.kind, "trace": self.trace,
                "chunks": self.traced_chunks, "n": c["num_bit_nodes"],
                "m": c["num_check_nodes"], "edges": c["edges"],
                "schedule": c["schedule"]}


def program_stats(result) -> dict:
    """A ``SimResult``'s statistics under the reference's names."""
    return {"ratio_dec": result.ratio_trials_success_decoding,
            "ratio_ldpc": result.ratio_trials_success_ldpc,
            "iter_mean": result.iter_success_mean,
            "iter_std": result.iter_success_std,
            "iter_min": result.iter_success_min,
            "iter_max": result.iter_success_max}
