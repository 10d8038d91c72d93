"""A FER-curve sweep of a QC code: ``drivers/sweep.py``'s passes, chunks,
sample and readings, with the code read in the QC format
(``reference/qc.py``) and decoded in the configuration's ``schedule``;
the reference decodes the sampled combination again in the layered
schedule (``reference/layered.py``).

Workload keys: ``sweep.py``'s; ``keys`` is "mc" (the QC kernels draw the
keys themselves).
"""

from __future__ import annotations

from benchmark.drivers import sweep
from benchmark.reference import compare, layered
from benchmark.reference.qc import read_qc


class Cell(sweep.Cell):

    def _program(self) -> None:
        from qkd_ldpc_v_tpu_torch import simulation as sim
        from qkd_ldpc_v_tpu_torch.config import (Config, DecodingAlgorithm,
                                                 MatrixFormat)
        from qkd_ldpc_v_tpu_torch.models.hmatrix import read_matrix
        from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams

        w, c = self.w, self.ctx.config
        if w["keys"] != "mc" or c["schedule"] != "layered":
            raise ValueError("a QC sweep draws mc keys and decodes layered, "
                             "as its reference does")
        self.sim = sim
        self.torch = self.ctx.torch
        self.device = self.ctx.device
        self.matrix = read_matrix(self.ctx.path(c["matrix"]), MatrixFormat.QC)
        self.cfg = Config(
            trials_number=w["trials"], simulation_seed=self.seed,
            decoding_algorithm=DecodingAlgorithm[w["algorithm"]],
            decoding_alg_max_iterations=c["max_iterations"],
            matrix_format=MatrixFormat.QC, batch_size=w["chunk"],
            dtype=c["dtype"], use_pallas=True, schedule=c["schedule"])
        factors = sim.ScalingFactors(primary=w["primary"],
                                     secondary=w["secondary"])
        self.combos = [sim.SimCombination(q, HMatrixParams(), factors)
                       for q in w["qber"]]

    def compare(self) -> dict:
        w, c = self.w, self.ctx.config
        layers = layered.Layers(read_qc(self.ctx.path(c["matrix"])),
                                self.device)
        frames = wrong = 0
        gap = 0.0
        for point, number, result, got in self.sample:
            want = layered.sweep_combination(
                layers, self.seed, number, w["qber"][point], w["trials"],
                w["chunk"], w["algorithm"], w["primary"], w["secondary"],
                c["max_iterations"])
            frames += len(want.iterations)
            wrong += compare.mismatched(got, want)
            gap = max(gap, compare.stats_gap(sweep.program_stats(result),
                                             compare.statistics(want)))
        return {"frame_mismatch": wrong / max(frames, 1), "stats_gap": gap}
