#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's main-path kernel chunks of two checkouts on
one card, in turns (A, B, B, A).

    python3 scripts/ab_torch_kernel_chunks.py DIR_A DIR_B [CELL ...]

Each DIR is the root of a checkout that holds ``qkd_ldpc_v_tpu_torch/``
(for example the parent commit unpacked with ``git archive`` into a
git-ignored directory, and the working tree). Every turn is a fresh
process that imports the package from its DIR, builds that checkout's
kernels there at first use, and times, after one untimed launch, the mean
of three launches of each cell's trial chunk as ``chip_smoke.py`` phases 3,
3c and 3d run it (the same keys: ``default_key_source`` seed 42, sim 0,
chunk 0):

  * headline: the fused QC kernel, the headline QC code, QBER 0.03, NMSA
    alpha 0.65, layered, 16384 frames;
  * qc100k: the streamed QC kernel, the N=102400 flagship, QBER 0.03, NMSA
    alpha 0.8, layered, 4096 frames;
  * alist100k: the streamed generic kernel, the N=102400 alist code, QBER
    0.03, NMSA alpha 0.8, flooding, 4096 frames;
  * alist100k_spa: the same with SPA (as ``chip_smoke.py`` phase 3g runs
    it), timed only when named.

Without CELL arguments it times the three NMSA cells. It prints the
card's name and power limit, one line per turn and cell, and each cell's
mean per checkout. The cells' outputs must agree across the
checkouts. It needs one CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELLS = ("headline", "qc100k", "alist100k")
ALL_CELLS = CELLS + ("alist100k_spa",)


def worker(checkout: Path, names: list[str]) -> None:
    sys.path.insert(0, str(checkout))
    import torch

    import qkd_ldpc_v_tpu_torch
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.models.qc import read_qc_matrix
    from qkd_ldpc_v_tpu_torch.ops import fused_qc, generic_stream, qc_stream
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        exact_error_count, inject_errors, log_ratio)
    from qkd_ldpc_v_tpu_torch.simulation import default_key_source

    assert Path(qkd_ldpc_v_tpu_torch.__file__).resolve().is_relative_to(
        checkout.resolve()), qkd_ldpc_v_tpu_torch.__file__
    dev = torch.device("cuda")
    assets = ROOT / "sparse_matrices"
    nmsa = DecodingAlgorithm.NMSA
    alist100k = read_sparse_matrix_alist(
        assets / "matrices_alist"
        / "(N=102400,M=31744,R=0.69,CW=3,SEED=67).mtrx")
    cells = {
        "headline": (read_qc_matrix(
            assets / "matrices_qc"
            / "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx"), 16384, 0.65,
            lambda code: fused_qc.make_fused_qc_trial(code, nmsa, 100, False,
                                                      "layered")),
        "qc100k": (read_qc_matrix(
            assets / "matrices_qc"
            / "(N=102400,M=30720,R=0.70,CW=3,Z=2048,SEED=56).mtrx"), 4096,
            0.8, lambda code: qc_stream.make_qc_stream_trial(
                code, nmsa, 100, False, "layered")),
        "alist100k": (alist100k, 4096, 0.8,
                      lambda code: generic_stream.make_generic_stream_trial(
                          code, nmsa, 100, False)),
        "alist100k_spa": (alist100k, 4096, 1.0,
                          lambda code: generic_stream.make_generic_stream_trial(
                              code, DecodingAlgorithm.SPA, 100, False)),
    }
    out = {}
    for name in names:
        code, frames, alpha, make = cells[name]
        n = code.num_bit_nodes
        ne = exact_error_count(n, 0.03)
        alice, bits = default_key_source(42, dev)(0, 0, frames, n)
        bob = inject_errors(bits, alice, ne, wide=True)
        del bits
        trial = make(code)
        args = (alice, bob, log_ratio(ne / n), alpha, 1.0, 0.0)
        trial(*args)  # first launch (and build), untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            res = trial(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 3
        out[name] = {"ms": ms, "iterations": int(res[2].sum().item()),
                     "converged": int(res[0].sum().item())}
        del alice, bob
    print(json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        worker(Path(sys.argv[2]), sys.argv[3:])
        return 0
    cells = tuple(sys.argv[3:]) or CELLS
    if len(sys.argv) < 3 or not set(cells) <= set(ALL_CELLS):
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dirs = {"A": Path(sys.argv[1]), "B": Path(sys.argv[2])}
    times = {"A": {c: [] for c in cells}, "B": {c: [] for c in cells}}
    seen = {}
    for turn, which in enumerate("ABBA"):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", str(dirs[which]), *cells],
            capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        for cell in cells:
            times[which][cell].append(res[cell]["ms"])
            stats = (res[cell]["iterations"], res[cell]["converged"])
            if seen.setdefault(cell, stats) != stats:
                print(f"{cell}: outputs differ between checkouts",
                      file=sys.stderr)
                return 1
            print(f"turn {turn} {which} ({dirs[which]}): {cell} "
                  f"{res[cell]['ms']:.2f} ms", flush=True)
    for cell in cells:
        means = {w: sum(t[cell]) / len(t[cell]) for w, t in times.items()}
        print(f"{cell}: A {means['A']:.2f} ms, B {means['B']:.2f} ms, "
              f"B/A {means['B'] / means['A']:.4f} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
