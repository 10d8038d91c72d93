"""FER-vs-QBER campaign on the PyTorch/CUDA port (qkd_ldpc_v_tpu_torch).

The port's counterpart of scripts/fer_campaign.py: the same suites, codes,
scaling factors, QBER grids and Config (NMSA, simulation seed 99, cap 100,
one ``RQBERRange(0.99, q, q, 0.01)`` per point, ``use_pallas``, the
flooding schedule), run through ``simulation.run_combination`` on the
card, and the same markdown table. By default each fixed-rate point draws
its keys in the kernels' mc modes (the fused generic kernel on the 1k
codes, the fused QC kernel on the 10k QC codes, the streamed QC kernel on
the N=102400 QC codes); the N=102400 alist code runs the streamed generic
kernel's trial mode on torch keys.

Usage: python scripts/fer_campaign_torch.py [--suite 10k|1k|100k]
       [--trials 4096] [--out PATH] [--device cuda|cpu]

The tables go to docs/FER_CURVES_H100.md, docs/FER_CURVES_H100_1K.md and
docs/FER_CURVES_H100_100K.md by default, with the card's name and power
limit (``nvidia-smi``) in their header. ``--device cuda`` (the default)
raises without a CUDA device; ``--device cpu`` runs the kernels' plain
torch versions (use a small ``--trials`` there). The JAX script's rows on
the reference's own alist codes, which it reads from the reference's mount
where that exists, are left out: those matrices are not in the repository.

Chunk sizes: all trials of a point in one chunk on the 1k and 10k codes,
1024 frames on the N=102400 QC codes (as the JAX script), and 4096 on the
N=102400 alist code, where the JAX script's 64 is its TPU stream engine's
batch cap.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

from qkd_ldpc_v_tpu_torch.config import (
    Config, DecodingAlgorithm, MatrixFormat, RQBERRange)
from qkd_ldpc_v_tpu_torch.models.hmatrix import (
    HMatrix, read_matrix, read_sparse_matrix_alist)
from qkd_ldpc_v_tpu_torch.models.qc import generate_qc_peg
from qkd_ldpc_v_tpu_torch.rate_adapt import HMatrixParams
from qkd_ldpc_v_tpu_torch.simulation import (
    ScalingFactors, SimCombination, SimResult, run_combination)

ROOT = Path(__file__).resolve().parent.parent
SEED = 99
CAP = 100
QC_100K_BATCH = 1024
ALIST_100K_BATCH = 4096
OUTPUTS = {"10k": "docs/FER_CURVES_H100.md",
           "1k": "docs/FER_CURVES_H100_1K.md",
           "100k": "docs/FER_CURVES_H100_100K.md"}
# The JAX package's tables of the same suites; a later table's rows replace
# an earlier one's. docs/FER_CURVES_100K.md's alist 100k rows were not
# decoded on the committed matrix as the JAX package decodes it in float32
# (that table was made where the reference's own N=102400 alist matrix was
# mounted, which the JAX script then prefers, through its bf16x2 stream
# transport); docs/FER_CURVES_100K_ALIST_JAX_CPU.md holds the JAX package's
# XLA engine on the committed matrix (scripts/fer_point_jax.py).
JAX_TABLES = {"10k": ("docs/FER_CURVES.md",), "1k": ("docs/FER_CURVES_1K.md",),
              "100k": ("docs/FER_CURVES_100K.md",
                       "docs/FER_CURVES_100K_ALIST_JAX_CPU.md")}
TABLE_HEAD = ("| code | alpha | QBER | FER | mean iters |", "|---|---|---|---|---|")


@dataclass(frozen=True)
class Code:
    """One code of a suite: its table name, matrix, NMSA alpha, QBER grid
    and chunk size (0: all trials of a point in one chunk)."""

    name: str
    matrix: HMatrix
    alpha: float
    qbers: Tuple[float, ...]
    batch: int


@dataclass(frozen=True)
class Row:
    """One point of the campaign and its result."""

    name: str
    alpha: float
    qber: float
    result: SimResult
    seconds: float

    @property
    def fer(self) -> float:
        return 1 - self.result.ratio_trials_success_ldpc


def suite_codes(suite: str, root: Path = ROOT) -> List[Code]:
    """The codes of ``suite`` ("10k", "1k" or "100k") that are in the
    repository, as the JAX script builds them."""
    mid = (0.02, 0.025, 0.03, 0.035, 0.04)
    if suite == "10k":
        return [
            Code("QC-PEG R=0.70 Z=512 CW=4 (headline)",
                 generate_qc_peg(20, 6, 512, 4, seed=9).to_hmatrix(),
                 0.65, mid, 0),
            Code("QC-PEG R=0.725 Z=256 CW=4",
                 generate_qc_peg(40, 11, 256, 4, seed=9).to_hmatrix(),
                 0.70, mid, 0),
        ]
    alist = root / "sparse_matrices" / "matrices_alist"
    if suite == "1k":
        low = (0.01, 0.015, 0.02, 0.025, 0.03)
        return [
            Code("alist 1k R=0.72 CW=4 (committed)",
                 read_sparse_matrix_alist(
                     alist / "(N=1024,M=283,R=0.72,CW=4,SEED=6).mtrx"),
                 0.60, low, 0),
            Code("alist 1k R=0.62 CW=3 (committed)",
                 read_sparse_matrix_alist(
                     alist / "(N=1024,M=384,R=0.62,CW=3,SEED=62).mtrx"),
                 0.70, (0.02, 0.03, 0.04, 0.05, 0.06), 0),
        ]
    if suite != "100k":
        raise ValueError(f"unknown suite {suite!r}")
    qc_dir = root / "sparse_matrices" / "matrices_qc"

    def qc(name):
        return read_matrix(qc_dir / name, MatrixFormat.QC)

    return [
        Code("QC 100k R=0.70 Z=2048 CW=3 (streamed QC)",
             qc("(N=102400,M=30720,R=0.70,CW=3,Z=2048,SEED=56).mtrx"),
             0.80, mid, QC_100K_BATCH),
        Code("QC 100k R=0.84 Z=2048 CW=3 (streamed QC)",
             qc("(N=102400,M=16384,R=0.84,CW=3,Z=2048,SEED=57).mtrx"),
             0.80, (0.005, 0.01, 0.0125, 0.015, 0.02), QC_100K_BATCH),
        Code("QC 100k R=0.50 Z=2048 CW=3 (streamed QC)",
             qc("(N=102400,M=51200,R=0.50,CW=3,Z=2048,SEED=58).mtrx"),
             0.80, (0.06, 0.07, 0.08, 0.09, 0.10), QC_100K_BATCH),
        Code("alist 100k R=0.69 CW=3 (streaming)",
             read_sparse_matrix_alist(
                 alist / "(N=102400,M=31744,R=0.69,CW=3,SEED=67).mtrx"),
             0.80, mid, ALIST_100K_BATCH),
    ]


def point_config(qber: float, trials: int, batch: int) -> Config:
    """The JAX script's Config of one point."""
    return Config(
        trials_number=trials,
        simulation_seed=SEED,
        decoding_algorithm=DecodingAlgorithm.NMSA,
        decoding_alg_max_iterations=CAP,
        r_qber_ranges=(RQBERRange(0.99, qber, qber, 0.01),),
        batch_size=batch,
        use_pallas=True,
    )


def campaign_rows(codes: Sequence[Code], trials: int, device,
                  key_source=None) -> Iterator[Row]:
    """Run every (code, QBER) point through ``run_combination`` on
    ``device`` (sim number 0, as the JAX script), one point per ``next``.
    ``key_source`` feeds the keys of every chunk (see ``run_combination``);
    without it the engines draw their own."""
    for code in codes:
        for q in code.qbers:
            comb = SimCombination(q, HMatrixParams(), ScalingFactors(code.alpha))
            t0 = time.perf_counter()
            res = run_combination(code.matrix, comb,
                                  point_config(q, trials, code.batch), 0,
                                  device, key_source=key_source)
            yield Row(code.name, code.alpha, q, res, time.perf_counter() - t0)


def format_row(name: str, alpha: float, qber: float, fer: float,
               iters: float) -> str:
    """One table line, as the JAX script writes it."""
    return f"| {name} | {alpha} | {qber} | {fer:.5f} | {iters:.1f} |"


def device_line(device) -> str:
    """What ran the decode: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them, or the CPU."""
    if torch.device(device).type != "cuda":
        return "the CPU (the kernels' plain torch versions)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "one " + out.stdout.strip().splitlines()[0]


def table(rows: Sequence[Row], trials: int, where: str) -> str:
    lines = [
        "# FER vs QBER — NMSA, 100-iteration cap, exact-count channel",
        "",
        "(Flooding schedule, the reference's semantics.)",
        "",
        f"{trials} trials per point, f32 decode through the PyTorch/CUDA port",
        f"(qkd_ldpc_v_tpu_torch) on {where}.",
        "Generated by scripts/fer_campaign_torch.py; the JAX package's table",
        "of the same suite is its counterpart.",
        "",
        *TABLE_HEAD,
    ]
    lines += [format_row(r.name, r.alpha, r.qber, r.fer,
                         r.result.iter_success_mean) for r in rows]
    return "\n".join(lines) + "\n"


def read_table(path: Path) -> Dict[Tuple[str, float], Tuple[float, float, float]]:
    """A campaign table's rows: {(code, QBER): (alpha, FER, mean iters)}."""
    out = {}
    for line in Path(path).read_text().splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) != 5 or not line.startswith("| ") or cells[0] == "code":
            continue
        name, alpha, qber, fer, iters = cells
        out[name, float(qber)] = (float(alpha), float(fer), float(iters))
    return out


def jax_rows(suite: str, root: Path = ROOT):
    """The JAX package's rows of ``suite``: ``read_table`` over its tables
    in ``JAX_TABLES`` order."""
    rows = {}
    for rel in JAX_TABLES[suite]:
        rows.update(read_table(root / rel))
    return rows


def fer_margin(p: float, q: float, trials: int) -> float:
    """The largest |p - q| two FERs of ``trials`` frames each may differ by:
    4 standard errors of the difference at the pooled rate, plus 2 frames,
    plus half a unit of the tables' fifth decimal."""
    pooled = (p + q) / 2
    return (4 * math.sqrt(2 * pooled * (1 - pooled) / trials) + 2 / trials
            + 0.5e-5)


def iters_margin(std: float, converged: int, other_converged: int) -> float:
    """The largest difference of two mean iteration counts over
    ``converged`` and ``other_converged`` frames: 5 standard errors of the
    difference, both samples taken with the standard deviation ``std``,
    plus half a unit of the tables' first decimal."""
    return 5 * std * math.sqrt(1 / converged + 1 / other_converged) + 0.05


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--suite", choices=("10k", "1k", "100k"), default="10k")
    p.add_argument("--trials", type=int, default=4096)
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (use "
                           "--device cpu for the plain torch path)")
    out = args.out or ROOT / OUTPUTS[args.suite]
    where = device_line(args.device)
    rows = []
    for row in campaign_rows(suite_codes(args.suite),
                             args.trials, args.device):
        rows.append(row)
        print(f"{row.name} q={row.qber}: FER={row.fer:.5f} "
              f"iters={row.result.iter_success_mean:.1f} "
              f"({args.trials / row.seconds:,.0f} frames/s, {row.seconds:.2f} s"
              f" on {where})", file=sys.stderr, flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(table(rows, args.trials, where))
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
