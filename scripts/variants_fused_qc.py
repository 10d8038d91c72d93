#!/usr/bin/env python3
"""Time compiled variants of the fused QC kernel on one card, to split its
time.

    python3 scripts/variants_fused_qc.py [VARIANT ...]

Each variant is this checkout's package copied to
``build/variants/<name>`` with one textual edit to ``csrc/fused_qc.cu``
(most break exactness on purpose: they only split the time), built there at
first use and timed in its own process, in turns with the unchanged kernel
(base, variant, variant, base): the headline QC code, 16384 frames of chunk
0 of simulation seed 42 at QBER 0.03, NMSA alpha 0.65, the mc mode,
layered and flooding, at iteration cap 0 (the staging alone), cap 2 (two
sweeps of every frame more: none converges within two at this QBER) and
the main path's cap of 100; after one untimed launch, the mean of three.
A variant that breaks exactness changes how frames converge, so its cap-100
time is not comparable; its cap-0 and cap-2 times are.

Variants (default: all):
  * no_row_barrier: the layered schedule without its barrier between
    block-rows;
  * one_block_per_sm: 100000 more bytes of shared memory per block, so
    that one block fits an SM where two did;
  * run16: every check of at most 16 edges in the 16-slot register run;
  * no_selection: the error selection left out (no errors);
  * no_philox: a multiplicative hash in place of the Philox draw;
  * no_syndrome: the syndrome gather left out (one bit of Alice's per row).

It prints the card's name and power limit, one line per turn and each
variant's means beside the base's. It needs one CUDA device.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNEL = Path("qkd_ldpc_v_tpu_torch") / "csrc" / "fused_qc.cu"
CELLS = ("layered:0", "layered:2", "layered:100", "flooding:0",
         "flooding:2", "flooding:100")

# name: (text in csrc/fused_qc.cu, its replacement)
VARIANTS = {
    "no_row_barrier": ("        if (r < mb - 1) __syncthreads();\n", ""),
    "one_block_per_sm": (
        "      shared_bytes(p.mb, p.nb, p.z, p.num_be, p.max_deg, flags, "
        "p.mode);\n  int err = configure(kernel, smem);",
        "      shared_bytes(p.mb, p.nb, p.z, p.num_be, p.max_deg, flags, "
        "p.mode) + 100000;\n  int err = configure(kernel, smem);"),
    "run16": ("  if (deg <= 6) return f(Run<6>{});\n"
              "  if (deg <= 8) return f(Run<8>{});\n"
              "  if (deg <= 10) return f(Run<10>{});\n"
              "  if (deg <= 12) return f(Run<12>{});\n"
              "  if (deg <= 14) return f(Run<14>{});\n", ""),
    "no_selection": ("  if (d.num_errors > 0)\n    kth = kth_smallest_scan(",
                     "  if (d.num_errors < 0)\n    kth = kth_smallest_scan("),
    "no_philox": (
        "      const uint4 a = mc_counter_words(d.key, q, frame, "
        "kStreamAlice);\n      const uint4 e = mc_counter_words(d.key, q, "
        "frame, kStreamErrors);",
        "      const uint4 a = make_uint4(q * 2654435761u ^ frame, q * 40503u"
        " + frame, q ^ 0x9e3779b9u, q * 7u);\n      const uint4 e = "
        "make_uint4(q * 2246822519u + frame, q * 3266489917u ^ frame, q * "
        "668265263u, q * 374761393u + frame);"),
    "no_syndrome": (
        "        for (int e = fr.row_ptr[r]; e < fr.row_ptr[r + 1]; ++e)\n"
        "          bit ^= packed_bit(fr.alice, edge_bit(fr.ea[e], z, Z));",
        "        bit = packed_bit(fr.alice, z + r);"),
}


def worker(checkout: Path) -> None:
    sys.path.insert(0, str(checkout))
    import torch

    from qkd_ldpc_v_tpu_torch.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu_torch.models.qc import read_qc_matrix
    from qkd_ldpc_v_tpu_torch.ops import fused_qc
    from qkd_ldpc_v_tpu_torch.ops.channel import (
        chunk_seed, exact_error_count, log_ratio)

    code = read_qc_matrix(ROOT / "sparse_matrices" / "matrices_qc"
                          / "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx")
    n = code.num_bit_nodes
    ne = exact_error_count(n, 0.03)
    dev = torch.device("cuda")
    out = {}
    for cell in CELLS:
        schedule, cap = cell.split(":")
        mc = fused_qc.make_fused_qc_montecarlo(
            code, DecodingAlgorithm.NMSA, int(cap), False, schedule)

        def run():
            return mc(chunk_seed(42, 0, 0), 0, 16384, ne, log_ratio(ne / n),
                      0.65, 1.0, 0.0, device=dev)

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        out[cell] = (time.perf_counter() - t0) * 1e3 / 3
    print(json.dumps(out), flush=True)


def variant_tree(name: str) -> Path:
    """build/variants/<name>: the package with the variant's edit."""
    tree = ROOT / "build" / "variants" / name
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / "qkd_ldpc_v_tpu_torch",
                    tree / "qkd_ldpc_v_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = tree / KERNEL
    text = src.read_text()
    old, new = VARIANTS[name]
    if old not in text:
        raise SystemExit(f"{name}: its edit no longer applies to {KERNEL}")
    src.write_text(text.replace(old, new))
    return tree


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(Path(sys.argv[2]))
        return 0
    names = sys.argv[1:] or list(VARIANTS)
    if not set(names) <= set(VARIANTS):
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for name in names:
        trees = {"base": ROOT, name: variant_tree(name)}
        times = {which: {c: [] for c in CELLS} for which in trees}
        for which in ("base", name, name, "base"):
            proc = subprocess.run(
                [sys.executable, __file__, "--worker", str(trees[which])],
                capture_output=True, text=True, timeout=1200)
            if proc.returncode != 0:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            for cell in CELLS:
                times[which][cell].append(res[cell])
            print(f"{which}: " + ", ".join(
                f"{c} {res[c]:.3f} ms" for c in CELLS), flush=True)
        for cell in CELLS:
            base = sum(times["base"][cell]) / 2
            var = sum(times[name][cell]) / 2
            print(f"{name} {cell}: base {base:.3f} ms, variant {var:.3f} ms, "
                  f"variant/base {var / base:.4f} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
