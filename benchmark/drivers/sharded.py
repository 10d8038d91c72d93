"""A FER-curve sweep split over ranks, one rank per card: the passes of
``sweep.py``, with every chunk of ``chunk`` frames split evenly over
the ranks by ``parallel.mesh_step_factory(mesh, reduce_stats=True)``, so
each rank decodes its share through the one-card kernels and the chunk's
six statistics are reduced on the devices (NCCL on cards, gloo on the
CPU). ``run.py`` starts the ranks; every rank runs the same passes in
step, rank 0 decides when the window ends, and only rank 0 reports.

The reference decodes every frame of the sampled combinations again,
each rank its own share of every chunk (the frames the mc mode gives the
rank), and rank 0 compares the combined statistics with the program's:
in reduced mode no per-frame outcome leaves the ranks, so ``stats_gap`` is
the cell's number. Per-layer readings come from every rank's trace
(busy time averaged over the cards, kernel time summed) and from the
step's own ``times`` (the collective's seconds of each chunk). The
window's rate is reported as ``frames_per_s.sharded``.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from benchmark.drivers import sweep
from benchmark.harness import trace
from benchmark.reference import compare
from benchmark.reference.alist import read_alist
from benchmark.reference.decoder import Graph


class ReducedRecorder:
    """A reducing chunk step that keeps each chunk's reduced statistics."""

    reduces = True

    def __init__(self, step, log: list) -> None:
        self.step = step
        self.device = step.device
        self.log = log

    def __call__(self, args, chunk_index, take):
        out = self.step(args, chunk_index, take)
        self.log.append((take, out))
        return out


class MultiTrace:
    """The ranks' traces read as one: busy and traced seconds averaged over
    the cards, device time summed; the breakdown is rank 0's."""

    def __init__(self, traces: List[trace.Trace]) -> None:
        self.traces = traces
        self.window_s = float(np.mean([t.window_s for t in traces]))

    def busy_s(self) -> float:
        return float(np.mean([t.busy_s() for t in self.traces]))

    def kernel_seconds(self, pattern):
        parts = [t.kernel_seconds(pattern) for t in self.traces]
        return sum(p[0] for p in parts), sum(p[1] for p in parts)

    def device_seconds_except(self, pattern) -> float:
        return sum(t.device_seconds_except(pattern) for t in self.traces)

    def device_ops(self, top: int = 10):
        return self.traces[0].device_ops(top)

    def idle_gaps(self, top: int = 10):
        return self.traces[0].idle_gaps(top)


class Cell(sweep.Cell):
    def _program(self) -> None:
        from qkd_ldpc_v_tpu_torch.parallel import (initialize_distributed,
                                                   make_data_mesh,
                                                   mesh_step_factory)

        ctx = self.ctx
        on_cards = ctx.device.startswith("cuda")
        initialize_distributed(ctx.address, ctx.world, ctx.rank,
                               backend="nccl" if on_cards else "gloo")
        self.mesh = make_data_mesh(f"cuda:{ctx.rank}" if on_cards else "cpu")
        self.mesh_factory = mesh_step_factory(self.mesh, reduce_stats=True)
        import torch.distributed as dist

        self.dist = dist
        super()._program()
        self.device = self.mesh.device

    def _factory(self, log):
        def factory(matrix, cfg, batch):
            return ReducedRecorder(self.mesh_factory(matrix, cfg, batch), log)
        return factory

    def _chunks(self, log):
        cap = self.ctx.config["max_iterations"]
        out = []
        for take, (n_dec, _, it_sum, _, _, _) in log:
            # Frames that never converge run to the cap.
            out.append({"frames": take,
                        "iterations": int(round(it_sum + (take - n_dec) * cap))})
        return out

    def _outcome(self, log):
        return None

    def _agree(self, flag: bool) -> bool:
        """Rank 0's answer, on every rank."""
        t = self.torch.tensor([1 if flag else 0], device=self.device)
        self.dist.broadcast(t, src=0)
        return bool(t.item())

    def run_window(self, seconds: float) -> dict:
        times = self._times()
        before = len(times)
        out = super().run_window(seconds)
        # Each rank's mean collective seconds a chunk over the window,
        # averaged over the ranks.
        mean = float(np.mean([c for _, c in times[before:]]))
        t = self.torch.tensor([mean], dtype=self.torch.float64,
                              device=self.device)
        self.dist.all_reduce(t)
        self.collective_ms = float(t.item()) / self.ctx.world * 1e3
        # Its own end-to-end metric, so that the host's noise across four
        # processes sets no bound of the one-card sweeps.
        return {"frames_per_s.sharded": out["frames_per_s"]}

    def _stop(self, t0: float, seconds: float) -> bool:
        return self._agree(time.perf_counter() - t0 >= seconds)

    def _times(self):
        return self.mesh_factory(self.matrix, self.cfg, self.w["chunk"]).times

    def run_traced(self) -> None:
        super().run_traced()
        gathered = [None] * self.ctx.world
        mine = self.trace
        mine.host = mine.host if self.ctx.rank == 0 else []
        self.dist.all_gather_object(gathered, mine)
        self.trace = MultiTrace(gathered)

    def compare(self) -> dict:
        """Rank r decodes frames ``r * local ..`` of every chunk of each
        sampled combination; rank 0 gathers the outcomes."""
        w, c = self.w, self.ctx.config
        world, rank = self.ctx.world, self.ctx.rank
        graph = Graph(read_alist(self.ctx.path(c["matrix"])), self.device)
        local = w["chunk"] // world
        gap = 0.0
        for point, number, result, _ in self.sample:
            mine = compare.sweep_combination(
                graph, w["keys"], self.seed, number, w["qber"][point],
                w["trials"], w["chunk"], w["algorithm"], w["primary"],
                w["secondary"], c["max_iterations"],
                frames=(rank * local, local))
            parts = [None] * world
            self.dist.all_gather_object(parts, tuple(mine))
            if rank == 0:
                want = compare.Outcome(*(np.concatenate([p[i] for p in parts])
                                         for i in range(3)))
                gap = max(gap, compare.stats_gap(sweep.program_stats(result),
                                                 compare.statistics(want)))
        return {"stats_gap": gap}

    def layer(self) -> dict:
        out = super().layer()
        out["collective_ms"] = self.collective_ms
        return out

    def fullest(self, peak: int) -> int:
        """The peak of the fullest card."""
        t = self.torch.tensor([peak], dtype=self.torch.int64,
                              device=self.device)
        self.dist.all_reduce(t, op=self.dist.ReduceOp.MAX)
        return int(t.item())

    def close(self) -> None:
        if self.dist.is_initialized():
            self.dist.destroy_process_group()
