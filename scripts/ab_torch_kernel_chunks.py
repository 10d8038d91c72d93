#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's main-path kernel chunks of two checkouts on
one card, in turns (A, B, B, A).

    python3 scripts/ab_torch_kernel_chunks.py DIR_A DIR_B [CELL ...]

Each DIR is the root of a checkout that holds ``qkd_ldpc_v_tpu_torch/``
(for example the parent commit unpacked with ``git archive`` into a
git-ignored directory, and the working tree). Every turn is a fresh
process that imports the package from its DIR, builds that checkout's
kernels there at first use, and times, after one untimed launch, the mean
of three launches of each cell's chunk as ``chip_smoke.py`` phases 3, 3c,
3d and 3g run it (the same keys: ``default_key_source`` seed 42, sim 0,
chunk 0; mc chunks: the chunk seed of simulation seed 42, sim 0, chunk 0):

  * headline: the fused QC kernel's trial mode, the headline QC code, QBER
    0.03, NMSA alpha 0.65, layered, 16384 frames;
  * timed only when named, the fused QC kernel's other chunks on the
    headline code (phases 3, 3e and 3g): headline_flooding, its trial mode
    flooding; headline_mc and headline_mc_flooding, its mc mode, layered
    and flooding; headline_frame, its frame mode on 4096 rate-adapted
    frames of the f_EC 1.52 point (QBER 0.034, delta 0.1, untainted
    puncturing from the committed pool), NMSA alpha 0.7, flooding; and
    headline_spa_mc, its mc mode with SPA (flooding);
  * qc100k, qc100k_flooding: the streamed QC kernel's trial mode, the
    N=102400 flagship, QBER 0.03, NMSA alpha 0.8, layered or flooding, 4096
    frames;
  * qc100k_mc, qc100k_mc_flooding: its mc mode (keys drawn in the kernel),
    the same code, QBER, algorithm and frames;
  * alist100k: the streamed generic kernel, the N=102400 alist code, QBER
    0.03, NMSA alpha 0.8, flooding, 4096 frames;
  * timed only when named: alist100k_spa, the same with SPA (as phase 3g
    runs it); qc100k_spa_mc, the streamed QC mc mode with SPA on the
    flagship (phase 3g's chunk); qc100k_decode, the streamed QC decode mode
    on the flagship's channel LLRs and Alice's syndrome, NMSA alpha 0.8,
    flooding;
  * timed only when named, the fused generic kernel on the 10k alist code
    (phases 2b, 3b, 3e and 3g): alist10k and alist10k_mc, its trial and mc
    modes at QBER 0.025, NMSA alpha 0.70, 16384 frames (cell 4);
    alist10k_frame, its frame mode on 4096 rate-adapted frames of the
    point QBER 0.0252, delta 0.1, f_EC 1.5 (untainted puncturing from the
    committed pool), AOMSA beta 0.5, sigma 1.0 (cell 9); alist10k_spa_lin_mc,
    its mc mode with SPA-lin at QBER 0.025, 16384 frames (phase 3g); and
    alist10k_decode, its decode mode on 512 frames' channel LLRs and
    Alice's syndrome at QBER 0.025, NMSA alpha 0.70 (phase 2b's timed
    case).

Without CELL arguments it times the six NMSA cells. It prints the
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
CELLS = ("headline", "qc100k", "qc100k_flooding", "qc100k_mc",
         "qc100k_mc_flooding", "alist100k")
ALL_CELLS = CELLS + ("alist100k_spa", "qc100k_spa_mc", "qc100k_decode",
                     "headline_flooding", "headline_mc",
                     "headline_mc_flooding", "headline_frame",
                     "headline_spa_mc", "alist10k", "alist10k_mc",
                     "alist10k_frame", "alist10k_spa_lin_mc",
                     "alist10k_decode")


def worker(checkout: Path, names: list[str]) -> None:
    sys.path.insert(0, str(checkout))
    import torch

    import numpy as np

    import qkd_ldpc_v_tpu_torch
    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu_torch.models.qc import read_qc_matrix
    from qkd_ldpc_v_tpu_torch.models.layout import layout_for
    from qkd_ldpc_v_tpu_torch.ops import (
        fused_generic, fused_qc, generic_stream, qc_stream)
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        build_frames, calculate_syndrome, exact_error_count, inject_errors,
        log_ratio, qc_syndrome)
    from qkd_ldpc_v_tpu_torch.rate_adapt import (
        adapt_code_rate, get_punctured_bits_untainted)
    from qkd_ldpc_v_tpu_torch.simulation import (
        chunk_seed, default_key_source, make_frame_plan)

    assert Path(qkd_ldpc_v_tpu_torch.__file__).resolve().is_relative_to(
        checkout.resolve()), qkd_ldpc_v_tpu_torch.__file__
    dev = torch.device("cuda")
    assets = ROOT / "sparse_matrices"
    nmsa, spa = DecodingAlgorithm.NMSA, DecodingAlgorithm.SPA
    aomsa, spa_lin = DecodingAlgorithm.AOMSA, DecodingAlgorithm.SPA_APPROX
    alist10k_path = (assets / "matrices_alist"
                     / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx")
    alist10k = read_sparse_matrix_alist(alist10k_path)
    alist100k = read_sparse_matrix_alist(
        assets / "matrices_alist"
        / "(N=102400,M=31744,R=0.69,CW=3,SEED=67).mtrx")
    flagship = read_qc_matrix(
        assets / "matrices_qc"
        / "(N=102400,M=30720,R=0.70,CW=3,Z=2048,SEED=56).mtrx")

    headline_path = (assets / "matrices_qc"
                     / "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx")
    headline = read_qc_matrix(headline_path)

    def stream(make, alg, schedule):
        return lambda code: make(code, alg, 100, False, schedule)

    def generic(make, alg):
        return lambda code: make(code, alg, 100, False)

    def frame_chunk(code, frames, qber, point):
        """(alice_frame, llr) of 4096 rate-adapted frames of ``point`` (as
        chip_smoke.py's build_chunk makes them), with the committed
        untainted pool of the code's asset."""
        matrix, path = ((alist10k, alist10k_path) if code is alist10k
                        else (code.to_hmatrix(), headline_path))
        matrix.punctured_bits_untainted = get_punctured_bits_untainted(
            path, np.random.default_rng(0), matrix)
        params = adapt_code_rate(np.random.default_rng(1), matrix, *point,
                                 use_untainted=True)
        n = code.num_bit_nodes
        ne = exact_error_count(n, qber)
        alice, bits, punct = default_key_source(42, dev)(
            0, 0, frames, n, punctured=True)
        bob = inject_errors(bits, alice, ne, wide=True)
        pos_class, gather = make_frame_plan(n, params)
        return build_frames(
            alice, bob, punct, torch.tensor(pos_class == 0, device=dev),
            torch.tensor(pos_class == 1, device=dev),
            torch.tensor(gather.astype(np.int64), device=dev),
            log_ratio(ne / n), torch.float32)

    # name: (code, frames, alpha, mode, make[, qber, frame point])
    cells = {
        "headline": (headline, 16384, 0.65, "trial", stream(
            fused_qc.make_fused_qc_trial, nmsa, "layered")),
        "headline_flooding": (headline, 16384, 0.65, "trial", stream(
            fused_qc.make_fused_qc_trial, nmsa, "flooding")),
        "headline_mc": (headline, 16384, 0.65, "mc", stream(
            fused_qc.make_fused_qc_montecarlo, nmsa, "layered")),
        "headline_mc_flooding": (headline, 16384, 0.65, "mc", stream(
            fused_qc.make_fused_qc_montecarlo, nmsa, "flooding")),
        "headline_frame": (headline, 4096, 0.7, "frame", stream(
            fused_qc.make_fused_qc_frame_trial, nmsa, "flooding")),
        "headline_spa_mc": (headline, 16384, 1.0, "mc", stream(
            fused_qc.make_fused_qc_montecarlo, spa, "flooding")),
        "qc100k": (flagship, 4096, 0.8, "trial", stream(
            qc_stream.make_qc_stream_trial, nmsa, "layered")),
        "qc100k_flooding": (flagship, 4096, 0.8, "trial", stream(
            qc_stream.make_qc_stream_trial, nmsa, "flooding")),
        "qc100k_mc": (flagship, 4096, 0.8, "mc", stream(
            qc_stream.make_qc_stream_montecarlo, nmsa, "layered")),
        "qc100k_mc_flooding": (flagship, 4096, 0.8, "mc", stream(
            qc_stream.make_qc_stream_montecarlo, nmsa, "flooding")),
        "qc100k_spa_mc": (flagship, 4096, 1.0, "mc", stream(
            qc_stream.make_qc_stream_montecarlo, spa, "flooding")),
        "qc100k_decode": (flagship, 4096, 0.8, "decode", stream(
            qc_stream.make_qc_stream_decoder, nmsa, "flooding")),
        "alist100k": (alist100k, 4096, 0.8, "trial",
                      lambda code: generic_stream.make_generic_stream_trial(
                          code, nmsa, 100, False)),
        "alist100k_spa": (alist100k, 4096, 1.0, "trial",
                          lambda code: generic_stream.make_generic_stream_trial(
                              code, spa, 100, False)),
        "alist10k": (alist10k, 16384, 0.7, "trial", generic(
            fused_generic.make_fused_generic_trial, nmsa), 0.025),
        "alist10k_mc": (alist10k, 16384, 0.7, "mc", generic(
            fused_generic.make_fused_generic_montecarlo, nmsa), 0.025),
        "alist10k_frame": (alist10k, 4096, 0.5, "frame", generic(
            fused_generic.make_fused_generic_frame_trial, aomsa), 0.0252,
            (0.0252, 0.1, 1.5)),
        "alist10k_spa_lin_mc": (alist10k, 16384, 1.0, "mc", generic(
            fused_generic.make_fused_generic_montecarlo, spa_lin), 0.025),
        "alist10k_decode": (alist10k, 512, 0.7, "decode", generic(
            fused_generic.make_fused_generic_decoder, nmsa), 0.025),
    }
    out = {}
    for name in names:
        code, frames, alpha, mode, make, *rest = cells[name]
        qber = rest[0] if rest else 0.03
        point = rest[1] if len(rest) > 1 else (0.034, 0.1, 1.52)
        n = code.num_bit_nodes
        ne = exact_error_count(n, qber)
        lp = log_ratio(ne / n)
        fn = make(code)
        if mode == "mc":
            args = (chunk_seed(42, 0, 0), 0, frames, ne, lp, alpha, 1.0, 0.0)
            keys = ()
        elif mode == "frame":
            keys = frame_chunk(code, frames, point[0], point)
            args = (*keys, alpha, 1.0, 0.0)
        else:
            alice, bits = default_key_source(42, dev)(0, 0, frames, n)
            bob = inject_errors(bits, alice, ne, wide=True)
            del bits
            if mode == "trial":
                args = (alice, bob, lp, alpha, 1.0, 0.0)
            else:
                lpt = torch.tensor(lp, dtype=torch.float32, device=dev)
                syndrome = (calculate_syndrome(layout_for(code), alice)
                            if code is alist10k else qc_syndrome(code, alice))
                args = (torch.where(bob == 1, -lpt, lpt), syndrome, alpha,
                        1.0, 0.0)
            keys = (alice, bob)
        kwargs = {"device": dev} if mode == "mc" else {}
        fn(*args, **kwargs)  # first launch (and build), untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            res = fn(*args, **kwargs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 3
        conv = res[1] if mode == "decode" else res[0]
        iters = res[2]
        out[name] = {"ms": ms, "iterations": int(iters.sum().item()),
                     "converged": int(conv.sum().item())}
        if mode == "decode":
            out[name]["decisions"] = int(res[0].to(torch.int64).sum().item())
        del args, keys, res
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
            stats = (res[cell]["iterations"], res[cell]["converged"],
                     res[cell].get("decisions"))
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
