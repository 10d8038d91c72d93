"""Command-line entry point: batch-process config files into CSV results.

Counterpart of ``qkd_ldpc_v_tpu/cli.py`` (reference contract:
src/main.cpp:6-203): every ``*.json`` in the config directory is one run,
the matrix directory is chosen by the config's ``matrix_format``, and each
run writes one self-describing CSV into the results directory.

``--device`` picks where trials run: ``cuda`` (the default) launches the
hand-written kernels and raises when no CUDA device is present; ``cpu``
runs their plain torch versions. Each config's finished combinations are
checkpointed to ``RESULTS/.{stem}.checkpoint.json``; a rerun of the same
campaign resumes after them, and the checkpoint is deleted once the CSV
has landed. ``--profile DIR`` records the whole run with
``torch.profiler`` (the CPU, and the CUDA device's kernels and copies on
``--device cuda``) into the Chrome trace ``DIR/trace.json``; on the card it
raises where the trace holds no kernel. The trace also holds the program's
stage spans (``user_annotation`` events named ``sim.*``, ``channel.*``,
``kernel.*`` and, in a sharded run, ``parallel.*``; ``utils.span``) on the
clock of the kernels.

    python -m qkd_ldpc_v_tpu_torch --configs D --matrices D --results D \\
        [--device cuda|cpu] [--profile DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
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
  trace_qkd_ldpc                bool. Dump protocol-level tensors.
  trace_decoding_algorithm      bool. Dump per-iteration decoder tensors.
  trace_decoding_algorithm_llr  bool. Track the max-|LLR| watermark.
                                Any trace flag decodes every trial on the
                                host through the float64 oracle, on the
                                keys and frames of the float64 run.
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

tpu.phase1_iterations is read and has no effect: no engine of this package
re-decodes stragglers. Results: one CSV per config, semicolon-separated
with comma decimal marks, byte-compatible with qkd_ldpc_v_tpu's.
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
    p.add_argument("--profile", type=Path, default=None, metavar="DIR",
                   help="record the whole run with torch.profiler into the "
                        "Chrome trace DIR/trace.json (view in Perfetto or "
                        "chrome://tracing); besides the kernels and copies "
                        "it holds the program's stage spans (sim.*, "
                        "channel.*, kernel.*), which PERF.md section 3 "
                        "lists")
    return p


def _progress_printer(quiet: bool):
    # `base` counts trials credited within 2s of startup (checkpoint
    # restores); they are excluded from the ETA rate so a resumed campaign
    # doesn't report a near-zero ETA.
    state = {"done": 0, "base": 0, "last": -1.0, "t0": time.monotonic()}

    def cb(inc: int, total: int) -> None:
        if quiet:
            return
        now = time.monotonic()
        state["done"] += inc
        if now - state["t0"] < 2.0:
            state["base"] = state["done"]
        if now - state["last"] >= 0.5 or state["done"] >= total:
            state["last"] = now
            pct = 100.0 * state["done"] / total
            elapsed = now - state["t0"]
            run_done = max(state["done"] - state["base"], 1)
            eta = elapsed * (total - state["done"]) / run_done
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


def _kernel_events(trace: Path) -> int:
    """The device kernels a Chrome trace records."""
    events = json.loads(trace.read_text()).get("traceEvents", [])
    return sum(1 for e in events if str(e.get("cat", "")).lower() == "kernel")


@contextlib.contextmanager
def _profiled(directory, device: torch.device):
    """``torch.profiler`` around the body, its Chrome trace written to
    ``directory/trace.json`` (also when the body raises). On a CUDA device
    it traces the device too, and raises where the profiler cannot trace it
    or the trace holds no kernel: it never records nothing silently."""
    if directory is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("--profile: this torch build cannot trace the "
                               "CUDA device (no CUPTI)")
        activities.append(ProfilerActivity.CUDA)
    directory.mkdir(parents=True, exist_ok=True)
    trace = directory / "trace.json"
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(trace))
    if device.type == "cuda" and _kernel_events(trace) == 0:
        raise RuntimeError(f"--profile: {trace} records no device kernel")
    print(f"The profile trace is written to the file: {trace}")


def _run_config(args, device: torch.device, i: int, config_path: Path) -> None:
    """One config: its sweep, checkpointed per combination, into one CSV."""
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
    args.results.mkdir(parents=True, exist_ok=True)
    checkpoint = args.results / f".{config_path.stem}.checkpoint.json"
    results = qkd_ldpc_batch_simulation(
        sim_inputs, cfg, device, progress=_progress_printer(args.quiet),
        checkpoint_path=checkpoint,
    )
    duration = format_duration(time.monotonic() - start)
    result_path = write_file(results, cfg, duration, args.results)
    # Only drop the checkpoint once the CSV has safely landed.
    checkpoint.unlink(missing_ok=True)
    print(_color("92", f"The results are written to the file: {result_path}")
          + "\n")


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
        with _profiled(args.profile, device):
            for i, config_path in enumerate(config_paths):
                _run_config(args, device, i, config_path)
    except Exception as e:  # noqa: BLE001 — the reference's catch-all
        print(_color("91", f"ERROR: {type(e).__name__}: {e}"), file=sys.stderr)
        return 1
    print(_color("92", "Simulations successfully completed!"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
