"""FER-vs-QBER points through the JAX package, on the CPU.

Decides a disagreement between the port's campaign on the card
(scripts/fer_campaign_torch.py, chip_smoke.py phase 6) and a committed JAX
table (docs/FER_CURVES*.md): it runs the JAX package's ``run_combination``
at (matrix, alpha, QBER) points with the campaign's Config (NMSA,
simulation seed 99, cap 100, sim number 0) and prints FER, the mean and
standard deviation of the converged frames' iterations and their count;
with ``--out`` it also writes the rows as the campaign's table, under the
code name ``--name``, followed by the command and each point's printed
line.

Usage: JAX_PLATFORMS=cpu python scripts/fer_point_jax.py MATRIX
       [--format alist|qc] [--alpha 0.8] --qber Q [Q ...] [--trials 256]
       [--batch 128] [--pallas] [--name NAME --out PATH]

Without ``--pallas`` it runs the JAX package's XLA engine (float32).
"""

from __future__ import annotations

import argparse
import shlex
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("matrix", type=Path)
    p.add_argument("--format", choices=("alist", "qc"), default="alist")
    p.add_argument("--alpha", type=float, default=0.8)
    p.add_argument("--qber", type=float, nargs="+", required=True)
    p.add_argument("--trials", type=int, default=256)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--pallas", action="store_true")
    p.add_argument("--name", default=None)
    p.add_argument("--out", type=Path, default=None)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    if args.out is not None and args.name is None:
        p.error("--out needs --name")

    from qkd_ldpc_v_tpu.config import (
        Config, DecodingAlgorithm, MatrixFormat, RQBERRange)
    from qkd_ldpc_v_tpu.models.hmatrix import read_matrix
    from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams
    from qkd_ldpc_v_tpu.simulation import (
        ScalingFactors, SimCombination, pallas_engine, run_combination)

    fmt = MatrixFormat.ALIST if args.format == "alist" else MatrixFormat.QC
    matrix = read_matrix(args.matrix, fmt)
    rows, log = [], []
    for q in args.qber:
        cfg = Config(
            trials_number=args.trials,
            simulation_seed=99,
            decoding_algorithm=DecodingAlgorithm.NMSA,
            decoding_alg_max_iterations=100,
            r_qber_ranges=(RQBERRange(0.99, q, q, 0.01),),
            batch_size=args.batch,
            use_pallas=args.pallas,
        )
        comb = SimCombination(q, HMatrixParams(), ScalingFactors(args.alpha))
        t0 = time.perf_counter()
        res = run_combination(matrix, comb, cfg, sim_number=0)
        fer = 1 - res.ratio_trials_success_ldpc
        converged = round(res.ratio_trials_success_decoding * args.trials)
        engine = pallas_engine(matrix, cfg)
        log.append(f"{args.matrix.name} engine={engine} alpha={args.alpha} "
                   f"q={q} trials={args.trials}: FER={fer:.5f} mean "
                   f"iterations {res.iter_success_mean:.3f} std "
                   f"{res.iter_success_std:.3f} over {converged} converged "
                   f"frames ({time.perf_counter() - t0:.1f} s)")
        print(log[-1], flush=True)
        rows.append(f"| {args.name} | {args.alpha} | {q} | {fer:.5f} | "
                    f"{res.iter_success_mean:.1f} |")
    if args.out is not None:
        args.out.write_text("\n".join([
            "# FER vs QBER — NMSA, 100-iteration cap, exact-count channel",
            "",
            f"{args.trials} trials per point, the JAX package's {engine} "
            "engine (float32) on the CPU,",
            f"on {args.matrix.name}. Generated by scripts/fer_point_jax.py.",
            "",
            "| code | alpha | QBER | FER | mean iters |",
            "|---|---|---|---|---|",
            *rows,
            "",
            "Made by `JAX_PLATFORMS=cpu python "
            + shlex.join(["scripts/fer_point_jax.py", *argv]) + "`. Each "
            "point: FER, the mean and standard deviation of the converged "
            "frames' iterations, their count, and the point's seconds on "
            "the CPU that ran it:",
            "",
            *(f"- {line}" for line in log)]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
