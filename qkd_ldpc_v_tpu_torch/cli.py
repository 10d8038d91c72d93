"""Command-line entry point: batch-process config files into CSV results.

Counterpart of ``qkd_ldpc_v_tpu/cli.py`` (reference contract:
src/main.cpp:6-203): every ``*.json`` in the config directory is one run,
the matrix directory is chosen by the config's ``matrix_format``, and each
run writes one self-describing CSV into the results directory.

``--device`` picks where trials run: ``cuda`` (the default) launches the
hand-written kernels and raises when no CUDA device is present; ``cpu``
runs their plain torch versions. There is no profile option and no
checkpoint/resume yet.

    python -m qkd_ldpc_v_tpu_torch --configs D --matrices D --results D \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

import torch

from qkd_ldpc_v_tpu_torch.config import format_config_info, parse_config_data
from qkd_ldpc_v_tpu_torch.simulation import (
    prepare_sim_inputs,
    qkd_ldpc_batch_simulation,
    write_file,
)
from qkd_ldpc_v_tpu_torch.utils import (
    format_duration,
    get_file_paths_in_directory,
)

CONFIG_HELP = """\
CONFIG FILE REFERENCE (JSON; one file = one simulation run)
===========================================================

The schema is the one of qkd_ldpc_v_tpu (python -m qkd_ldpc_v_tpu
--help-config prints it in full). This package runs the part of it that is
ported so far:

  matrix_format                 0 uncompressed (matrices_uncompressed),
                                1 alist (matrices_alist), 2 format 1
                                (matrices_1), 3 format 2 (matrices_2),
                                4 quasi-cyclic base-graph shifts
                                (matrices_qc).
  decoding_algorithm            0 SPA, 1 SPA-lin-approx, 2 NMSA, 3 OMSA,
                                4 ANMSA, 5 AOMSA. Every engine runs all
                                six, in its kernels on the card; the SPA
                                pair floods (tpu.schedule = layered warns
                                and floods with it).
  enable_privacy_maintenance    bool. Greedily delete one key bit per check
                                node after reconciliation (shortens the
                                output key that throughput counts).
  enable_code_rate_adaptation   bool. Puncture/shorten to hit
                                R = 1 - f_EC*h(QBER) per Elkouss et al.
                                Frames are built in torch; the fused
                                kernels decode them in their frame mode,
                                the streamed kernels and the generic torch
                                decoder in their decode mode.
  code_rate_adaptation_parameters.enable_untainted_puncturing   bool. Select
                                punctured bits by the untainted greedy
                                (cached in a .untp file next to the matrix).
  code_rate_adaptation_parameters.use_adaptation_parameters_ranges  bool.
    true  -> code_rate_adaptation_parameters_ranges:
             [{code_rate, delta:{begin,end,step},
               efficiency:{begin,end,step}}] crossed with the QBER range.
    false -> code_rate_QBER_adaptation_parameters_maps:
             [{code_rate, QBER, delta, efficiency}] explicit points.
  trace_*                       false.
  tpu.use_pallas                true: the hand-written kernels (CUDA) or
                                their plain torch versions (CPU) — the
                                fused QC kernel for QC codes it holds, the
                                streamed QC kernel for larger QC codes (the
                                N=102400 suite; simulation.qc_kernel
                                chooses), the fused generic kernel for the
                                other codes inside its gate, the streamed
                                generic kernel for larger ones (the 100k
                                alist code); false: the generic torch
                                decoder.
  tpu.batch_size                frames per device batch (0 = all trials).
  tpu.schedule                  flooding | layered (layered: QC codes with
                                a min-sum algorithm; elsewhere, the SPA
                                pair included, it warns and floods).
  tpu.dtype                     float32 (all engines) | float64 | bfloat16
                                (the generic torch decoder).
  tpu.force_engine              "" | qc | qc_stream | generic | stream |
                                xla (qc_stream: the streamed QC kernel for
                                any QC code; stream: the streamed generic
                                kernel for any code inside the JAX
                                package's stream gate).

Anything else not listed raises NotImplementedError naming the port step
that brings it. Results: one CSV
per config, semicolon-separated with comma decimal marks, byte-compatible
with qkd_ldpc_v_tpu's.
"""


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qkd-ldpc-torch",
        description=(
            "Monte-Carlo simulator of LDPC information reconciliation for "
            "QKD on PyTorch and CUDA."
        ),
    )
    p.add_argument("--configs", type=Path, default=Path("configs"),
                   help="directory of *.json run configs (default: ./configs)")
    p.add_argument("--matrices", type=Path, default=Path("sparse_matrices"),
                   help="root directory of matrix assets; the per-format "
                        "subdirectory is chosen by each config "
                        "(default: ./sparse_matrices)")
    p.add_argument("--results", type=Path, default=Path("results"),
                   help="output directory for CSV results (default: ./results)")
    p.add_argument("--matrix-ext", default=".mtrx",
                   help="matrix file extension filter (default: .mtrx)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: the hand-written kernels (raises without a "
                        "CUDA device); cpu: their plain torch versions")
    p.add_argument("--help-config", action="store_true",
                   help="print the config-file reference and exit")
    p.add_argument("--quiet", action="store_true", help="suppress progress output")
    return p


def _progress_printer(quiet: bool):
    state = {"done": 0, "last": -1.0, "t0": time.monotonic()}

    def cb(inc: int, total: int) -> None:
        if quiet:
            return
        now = time.monotonic()
        state["done"] += inc
        if now - state["last"] >= 0.5 or state["done"] >= total:
            state["last"] = now
            pct = 100.0 * state["done"] / total
            elapsed = now - state["t0"]
            eta = elapsed * (total - state["done"]) / max(state["done"], 1)
            print(
                f"\rPROGRESS [{state['done']}/{total}] {pct:5.1f}% "
                f"elapsed {elapsed:5.0f}s eta {eta:5.0f}s",
                end="", flush=True,
            )
            if state["done"] >= total:
                print()

    return cb


def _color(code: str, text: str) -> str:
    if not sys.stdout.isatty():
        return text
    return f"\033[{code}m{text}\033[0m"


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.help_config:
        print(CONFIG_HELP)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available (use --device cpu "
            "for the plain torch path)"
        )
    device = torch.device(args.device)

    logging.basicConfig(level=logging.WARNING, format="%(message)s")
    try:
        config_paths = get_file_paths_in_directory(args.configs, ".json")
        if not config_paths:
            print(f"No *.json configs found in {args.configs}", file=sys.stderr)
            return 1
        for i, config_path in enumerate(config_paths):
            cfg = parse_config_data(config_path)
            print(_color("96", format_config_info(cfg, config_path.name, i + 1)))
            matrix_dir = args.matrices / cfg.matrix_format.directory_name
            matrix_paths = get_file_paths_in_directory(matrix_dir, args.matrix_ext)
            if not matrix_paths:
                raise FileNotFoundError(
                    f"No *{args.matrix_ext} matrices found in {matrix_dir}"
                )
            sim_inputs = prepare_sim_inputs(matrix_paths, cfg)

            start = time.monotonic()
            results = qkd_ldpc_batch_simulation(
                sim_inputs, cfg, device, progress=_progress_printer(args.quiet),
            )
            duration = format_duration(time.monotonic() - start)
            result_path = write_file(results, cfg, duration, args.results)
            print(_color("92", f"The results are written to the file: {result_path}")
                  + "\n")
    except Exception as e:  # noqa: BLE001 — the reference's catch-all
        print(_color("91", f"ERROR: {type(e).__name__}: {e}"), file=sys.stderr)
        return 1
    print(_color("92", "Simulations successfully completed!"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
