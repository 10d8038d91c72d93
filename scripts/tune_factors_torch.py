"""Tune the min-sum scaling factors on the PyTorch/CUDA port.

The port's counterpart of scripts/tune_factors.py: the same grids (NMSA
alpha, OMSA beta, ANMSA alpha x nu, AOMSA beta x sigma), simulation seed
31, cap 100 and one chunk of all trials per point, on the QC headline code
(or an alist code) at its working QBER, through
``simulation.run_combination`` on the card: the fused QC kernel's mc mode
on the headline code. Prints a markdown table of FER / mean converged
iterations per point and, on stderr, each algorithm's best point by (FER,
mean iterations).

Usage: python scripts/tune_factors_torch.py [--trials 8192] [--qber 0.03]
       [--alg NMSA,OMSA,ANMSA,AOMSA] [--matrix ALIST] [--device cuda|cpu]

``--device cuda`` (the default) raises without a CUDA device; ``--device
cpu`` runs the kernels' plain torch versions (use a small ``--trials``).
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

from qkd_ldpc_v_tpu_torch.config import Config, DecodingAlgorithm, RQBERRange
from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix, read_sparse_matrix_alist
from qkd_ldpc_v_tpu_torch.models.qc import generate_qc_peg
from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams
from qkd_ldpc_v_tpu_torch.simulation import (
    ScalingFactors, SimCombination, SimResult, run_combination)

SEED = 31
CAP = 100
GRIDS: Dict[str, List[Tuple[float, float]]] = {
    "NMSA": [(a, 1.0) for a in (0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8,
                                0.85, 0.9)],
    "OMSA": [(b, 1.0) for b in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.8, 1.0)],
    "ANMSA": [(a, nu) for a in (0.6, 0.7, 0.8, 0.9)
              for nu in (0.2, 0.4, 0.6, 0.8)],
    "AOMSA": [(b, s) for b in (0.3, 0.5, 0.7) for s in (0.5, 1.0, 1.5)],
}
TABLE_HEAD = ("| alg | primary | secondary | FER | mean iters |",
              "|---|---|---|---|---|")


@dataclass(frozen=True)
class TuneRow:
    """One point of the sweep and its result."""

    alg: str
    primary: float
    secondary: float
    result: SimResult
    seconds: float

    @property
    def fer(self) -> float:
        return 1 - self.result.ratio_trials_success_ldpc

    def line(self) -> str:
        return (f"| {self.alg} | {self.primary} | {self.secondary} | "
                f"{self.fer:.5f} | {self.result.iter_success_mean:.1f} |")


def headline_code() -> HMatrix:
    return generate_qc_peg(base_bits=20, base_checks=6, lifting=512,
                           column_weight=4, seed=9).to_hmatrix()


def algorithm(name: str) -> DecodingAlgorithm:
    return DecodingAlgorithm[name if name != "SPA-LIN" else "SPA_APPROX"]


def tune_rows(matrix: HMatrix, algs: Sequence[str], trials: int, qber: float,
              device, key_source=None) -> Iterator[TuneRow]:
    """Run each algorithm's grid through ``run_combination`` on ``device``
    (sim number = the point's index in its grid, as the JAX script), one
    point per ``next``. ``key_source`` feeds the keys of every chunk."""
    for name in algs:
        cfg = Config(
            trials_number=trials,
            simulation_seed=SEED,
            decoding_algorithm=algorithm(name),
            decoding_alg_max_iterations=CAP,
            r_qber_ranges=(RQBERRange(0.99, qber, qber, 0.01),),
            batch_size=trials,
            use_pallas=True,
        )
        for i, (prim, sec) in enumerate(GRIDS[name]):
            comb = SimCombination(qber, HMatrixParams(),
                                  ScalingFactors(prim, sec))
            t0 = time.perf_counter()
            res = run_combination(matrix, comb, cfg, i, device,
                                  key_source=key_source)
            yield TuneRow(name, prim, sec, res, time.perf_counter() - t0)


def best(rows: Sequence[TuneRow]) -> Dict[str, TuneRow]:
    """Each algorithm's first point with the least (FER, mean iterations)."""
    out: Dict[str, TuneRow] = {}
    for row in rows:
        key = (row.fer, row.result.iter_success_mean)
        have = out.get(row.alg)
        if have is None or key < (have.fer, have.result.iter_success_mean):
            out[row.alg] = row
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--trials", type=int, default=8192)
    p.add_argument("--qber", type=float, default=0.03)
    p.add_argument("--alg", default="NMSA,OMSA,ANMSA,AOMSA")
    p.add_argument("--matrix", default=None,
                   help="alist matrix path (default: the QC headline code)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (use "
                           "--device cpu for the plain torch path)")
    matrix = (read_sparse_matrix_alist(args.matrix) if args.matrix
              else headline_code())
    rows = []
    for row in tune_rows(matrix, args.alg.split(","), args.trials, args.qber,
                         args.device):
        rows.append(row)
        print(f"{row.alg} {row.primary}/{row.secondary}: FER={row.fer:.5f} "
              f"iters={row.result.iter_success_mean:.1f} ({row.seconds:.1f}s)",
              file=sys.stderr, flush=True)
    for name, row in best(rows).items():
        print(f"# best {name}: primary={row.primary} secondary={row.secondary} "
              f"FER={row.fer:.5f}", file=sys.stderr, flush=True)
    print("\n".join([*TABLE_HEAD, *(row.line() for row in rows)]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
