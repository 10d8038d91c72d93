"""Monte-Carlo sweep (fixed rate and rate-adaptive): sweep combinations,
batched trials through the engine cascade, statistics, and the CSV writer.

Counterpart of ``qkd_ldpc_v_tpu/simulation.py``. The combination sweep
(code-rate adaptation, untainted puncturing and privacy maintenance
included), the rate-based lookups, ``make_frame_plan``, ``SimResult``,
``process_trials_results``, ``result_filename`` and ``write_file`` are
copies of the JAX package's NumPy code (importing that package imports
JAX); the CSV is byte-identical for identical statistics.

Engines and kernels (``engines.py``): ``select_engine`` names the engine
of a (matrix, config) as the JAX package's ``pallas_engine`` does, from the
same gates, whose verdicts are kept per matrix; ``tpu.force_engine`` pins
one. ``qc`` and ``qc_stream`` run a QC kernel (``qc_kernel``: the fused QC
kernel where it holds the code, else the streamed QC kernel), ``generic``
the fused generic kernel, ``stream`` the streamed generic kernel and
``xla`` (``use_pallas = false`` or dtype float64/bfloat16) the generic
torch decoder, all six algorithms.
The kernels' trials launch their CUDA kernels for tensors on a CUDA device
and run their plain torch versions for tensors on the CPU; the ``xla``
engine runs on the requested device. Every engine runs all six
algorithms. ``tpu.schedule = layered`` is honoured by the QC engines with
a min-sum algorithm; elsewhere, the SPA pair on a QC engine included, it
warns and floods, as in the JAX package.

Traced runs (any ``trace_*`` flag) decode every trial on the host through
the float64 oracle with console dumps (``tracing.traced_decode``), on the
frames the ``xla`` engine's float64 run would decode: the same keys and the
same ``build_frames``. A traced run therefore equals the untraced float64
run; against an engine that draws its keys in the kernel (the mc modes)
its channel realizations differ, as the JAX package's do.

Rate-adaptive runs build each chunk's frames and LLRs in torch
(``channel.build_frames``) and decode them as the JAX sweep does
(``frame_engine_trial``): the fused kernels run their frame mode, which
forms Alice's syndrome and compares keys in the kernel; the streamed
kernels and the ``xla`` engine take Alice's syndrome in torch, run their
decode mode and compare keys over the whole frame.

``qkd_ldpc_batch_simulation`` with a ``checkpoint_path`` saves each
finished combination and resumes a matching campaign mid-sweep
(``save_checkpoint``, ``load_checkpoint``, ``_campaign_fingerprint``).

Each chunk is one call of a chunk step: ``ChunkStep`` in one process, or a
``step_factory``'s step, such as ``parallel.mesh_step_factory``'s, which
splits every chunk over the ranks of a ``torch.distributed`` group and
gathers the per-frame outcomes or reduces them on the device to six
statistics (``_run_chunks_reduced``).

Random numbers: each decode chunk has its seed,
``channel.chunk_seed(seed, sim_number, chunk_index)``. Fixed-rate runs on
the ``qc``, ``qc_stream`` and ``generic`` engines draw their keys in the
kernel, as the JAX sweep's mc kernels do on the TPU: one call per chunk of
the engine's mc mode (``make_fused_qc_montecarlo``,
``make_qc_stream_montecarlo``, ``make_fused_generic_montecarlo``), whose
Philox stream (``ops/philox.py``) gives the same keys on the CPU, where its
plain version runs, as on the card. Everywhere else (the ``stream`` and
``xla`` engines, rate-adaptive runs, and any run given a ``key_source``) one
``torch.Generator`` per chunk, seeded by the chunk seed (on rank r of a
sharded run by ``channel.rank_chunk_seed``), draws Alice's keys,
then the error-position bits and, in rate-adaptive runs, Alice's punctured
bits, and the engine's trial decodes them. ``key_source`` replaces that
generator, e.g. with the JAX package's threefry streams in the
cross-package tests.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qkd_ldpc_v_tpu_torch.config import (
    Config,
    DecodingAlgorithm,
    RAdaptationParametersRange,
    RQBERAdaptationParametersMap,
    RQBERRange,
    RScalingFactorMap,
    ScalingFactorRange,
)
from qkd_ldpc_v_tpu_torch.engines import (  # noqa: F401
    DTYPES as _DTYPES,
    _make_trial,
    frame_engine_trial,
    montecarlo_trial,
    qc_kernel,
    select_engine,
)
from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix, read_matrix
from qkd_ldpc_v_tpu_torch.ops.channel import (
    build_frames,
    chunk_seed,
    exact_error_count,
    generate_keys,
    inject_errors,
    log_ratio,
    random_bits,
    rank_chunk_seed,
)
from qkd_ldpc_v_tpu_torch.oracle import calculate_syndrome as oracle_syndrome
from qkd_ldpc_v_tpu_torch.privacy import bits_positions_to_remove
from qkd_ldpc_v_tpu_torch.rate_adapt import (
    HMatrixParams,
    adapt_code_rate,
    finalize_bits_to_remove,
    get_punctured_bits_untainted,
)
from qkd_ldpc_v_tpu_torch.tracing import traced_decode
from qkd_ldpc_v_tpu_torch.utils import span

# (sim_number, chunk_index, batch, num_bits) -> (alice int8 [B,N],
# rand_bits [B,N] uniform 32-bit values), as tensors or arrays; with the
# keyword punctured=True also Alice's punctured draw (int8 [B,N] fair bits)
# as a third element.
KeySource = Callable[..., Tuple[object, ...]]


class SimulationError(RuntimeError):
    """Raised on unrecoverable sweep-construction or trial errors."""


# ---------------------------------------------------------------------------
# Rate-based lookups (reference: src/simulation.cpp:182-368). Convention: the
# first entry (ascending code_rate sort) whose code_rate >= matrix rate wins.
# ---------------------------------------------------------------------------


def rate_based_qber_range(
    code_rate: float, ranges: Sequence[RQBERRange]
) -> Tuple[float, ...]:
    """(reference: src/simulation.cpp:182-214)"""
    for r in ranges:
        if code_rate <= r.code_rate:
            return r.qber_values()
    raise SimulationError(
        "An error occurred while generating a QBER range based on code "
        f"rate(R). Matrix code rate, R = {code_rate}."
    )


def rate_based_adapt_parameters_ranges(
    code_rate: float, ranges: Sequence[RAdaptationParametersRange]
) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Returns (delta values, efficiency values)
    (reference: src/simulation.cpp:220-282)."""
    for r in ranges:
        if code_rate <= r.code_rate:
            return r.delta_values(), r.efficiency_values()
    raise SimulationError(
        "An error occurred while generating a delta range based on code "
        f"rate(R). Matrix code rate, R = {code_rate}."
    )


def rate_based_qber_adapt_parameters_maps(
    code_rate: float, maps: Sequence[RQBERAdaptationParametersMap]
):
    """All map entries sharing the first code_rate >= matrix rate
    (reference: src/simulation.cpp:287-321)."""
    out = []
    target = None
    for m in maps:
        if target is None:
            if code_rate <= m.code_rate:
                target = m.code_rate
                out.append(m.params)
        elif m.code_rate == target:
            out.append(m.params)
        else:
            break
    if not out:
        raise SimulationError(
            "An error occurred while generating a QBER - delta - "
            "efficiency(f_EC) maps based on code rate(R). Matrix code rate, "
            f"R = {code_rate}."
        )
    return out


def rate_based_scaling_factor_value(
    code_rate: float, maps: Sequence[RScalingFactorMap]
) -> float:
    """(reference: src/simulation.cpp:348-368)"""
    for m in maps:
        if code_rate <= m.code_rate:
            return m.scaling_factor
    raise SimulationError(
        "An error occurred while searching scaling factor value based on "
        f"code rate(R). Matrix code rate, R = {code_rate}."
    )


def scaling_factor_range_values(rng: ScalingFactorRange) -> Tuple[float, ...]:
    """(reference: src/simulation.cpp:325-343)"""
    return rng.values()


# ---------------------------------------------------------------------------
# Sweep combinations
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScalingFactors:
    """(reference: src/qkd_ldpc_algorithm.hpp scaling factors pair)"""

    primary: float = 0.0
    secondary: float = 0.0


@dataclass
class SimCombination:
    """One sweep point (reference: ``sim_combination``, src/simulation.hpp:27-33)."""

    config_qber: float
    matrix_params: HMatrixParams
    scaling_factors: ScalingFactors


@dataclass
class SimInput:
    """All sweep points for one matrix (reference: ``sim_input``,
    src/simulation.hpp:22-26)."""

    matrix: HMatrix
    matrix_path: Path
    combinations: List[SimCombination] = field(default_factory=list)


def _scaling_values(params, code_rate: float) -> Tuple[float, ...]:
    if params.use_range:
        return scaling_factor_range_values(params.range)
    return (rate_based_scaling_factor_value(code_rate, params.maps),)


def prepare_sim_inputs(matrix_paths: Sequence, cfg: Config) -> List[SimInput]:
    """Build the full (matrix x QBER x adaptation x scaling-factor) sweep
    (reference: src/simulation.cpp:371-537). One NumPy generator seeded
    with the simulation seed serves every matrix: the untainted greedy
    (where no ``.untp`` cache exists) and the random puncture and shorten
    positions draw from it in sweep order."""
    rng = np.random.default_rng(cfg.simulation_seed)
    sim_inputs: List[SimInput] = []
    for matrix_path in matrix_paths:
        matrix = read_matrix(matrix_path, cfg.matrix_format)
        code_rate = matrix.code_rate
        qber_mat_params: List[Tuple[float, HMatrixParams]] = []

        if cfg.enable_code_rate_adaptation:
            if cfg.enable_untainted_puncturing:
                matrix.punctured_bits_untainted = get_punctured_bits_untainted(
                    matrix_path, rng, matrix
                )
            if cfg.use_adaptation_parameters_ranges:
                deltas, effs = rate_based_adapt_parameters_ranges(
                    code_rate, cfg.r_adapt_params_ranges
                )
                qber_values = rate_based_qber_range(code_rate, cfg.r_qber_ranges)
                points = [
                    (q, d, e) for q in qber_values for d in deltas for e in effs
                ]
            else:
                maps = rate_based_qber_adapt_parameters_maps(
                    code_rate, cfg.r_qber_adapt_params_maps
                )
                points = [(p.qber, p.delta, p.efficiency) for p in maps]
            for qber, delta, efficiency in points:
                mat_params = adapt_code_rate(
                    rng, matrix, qber, delta, efficiency,
                    use_untainted=cfg.enable_untainted_puncturing,
                )
                if mat_params.is_empty:
                    continue  # skipped: unachievable (reference :414, :440)
                finalize_bits_to_remove(
                    matrix, mat_params, cfg.enable_privacy_maintenance
                )
                qber_mat_params.append((qber, mat_params))
        else:
            mat_params = HMatrixParams()
            if cfg.enable_privacy_maintenance:
                mat_params.bits_to_remove = bits_positions_to_remove(matrix)
            for qber in rate_based_qber_range(code_rate, cfg.r_qber_ranges):
                qber_mat_params.append((qber, mat_params))

        # Scaling-factor cross (reference :469-520)
        alg = cfg.decoding_algorithm
        if alg in (DecodingAlgorithm.NMSA, DecodingAlgorithm.OMSA):
            scaling = [ScalingFactors(primary=p)
                       for p in _scaling_values(cfg.primary, code_rate)]
        elif alg.is_adaptive:
            scaling = [
                ScalingFactors(primary=p, secondary=s)
                for p in _scaling_values(cfg.primary, code_rate)
                for s in _scaling_values(cfg.secondary, code_rate)
            ]
        else:
            scaling = [ScalingFactors()]

        combinations = [
            SimCombination(q, mp, sf) for (q, mp) in qber_mat_params for sf in scaling
        ]
        sim_inputs.append(
            SimInput(matrix=matrix, matrix_path=Path(matrix_path),
                     combinations=combinations)
        )
    return sim_inputs


# ---------------------------------------------------------------------------
# Statistics and results
# ---------------------------------------------------------------------------


@dataclass
class SimResult:
    """Per-combination statistics (reference: ``sim_result``,
    src/simulation.hpp:43-68)."""

    sim_number: int = 0
    matrix_filename: str = ""
    is_regular: bool = True
    num_bit_nodes: int = 0
    num_check_nodes: int = 0
    config_qber: float = 0.0
    accurate_qber: float = 0.0
    delta: float = 0.0
    efficiency: float = 0.0
    punctured_fraction: float = 0.0
    shortened_fraction: float = 0.0
    adapted_code_rate: float = 0.0
    scaling_factors: ScalingFactors = field(default_factory=ScalingFactors)
    iter_success_max: int = 0
    iter_success_min: int = 0
    iter_success_mean: float = 0.0
    iter_success_std: float = 0.0
    ratio_trials_success_decoding: float = 0.0
    ratio_trials_success_ldpc: float = 0.0
    throughput_max: int = 0
    throughput_min: int = 0
    throughput_mean: int = 0
    throughput_std: int = 0


def process_trials_results(
    cfg: Config,
    syndromes_match: np.ndarray,
    keys_match: np.ndarray,
    iterations: np.ndarray,
    runtimes_us: Optional[np.ndarray],
    out_key_length: int,
    result: SimResult,
) -> None:
    """Aggregate one combination's per-trial outcomes into ``result``
    (reference: src/simulation.cpp:580-690: iteration stats over
    syndrome-successful trials only, population std-dev, throughput in
    bits/s from out-key length over per-trial runtime plus optional RTT)."""
    trials = len(syndromes_match)
    ok = syndromes_match.astype(bool)
    n_dec = int(ok.sum())
    n_ldpc = int((ok & keys_match.astype(bool)).sum())

    if n_dec > 0:
        it_ok = iterations[ok].astype(np.float64)
        result.iter_success_max = int(it_ok.max())
        result.iter_success_min = int(it_ok.min())
        result.iter_success_mean = float(it_ok.mean())
        result.iter_success_std = float(it_ok.std())  # population (ref :622)
    else:
        result.iter_success_max = 0
        result.iter_success_min = 0
        result.iter_success_mean = 0.0
        result.iter_success_std = 0.0

    if cfg.enable_throughput_measurement and runtimes_us is not None:
        rtt_us = cfg.rtt_ms * 1000.0 if cfg.consider_rtt else 0.0
        tp = out_key_length * 1e6 / (runtimes_us.astype(np.float64) + rtt_us)
        result.throughput_max = int(tp.max())
        result.throughput_min = int(tp.min())
        result.throughput_mean = int(tp.mean())
        result.throughput_std = int(tp.std())

    result.ratio_trials_success_decoding = n_dec / trials
    result.ratio_trials_success_ldpc = n_ldpc / trials


# ---------------------------------------------------------------------------
# Batched trial execution
# ---------------------------------------------------------------------------


def default_key_source(seed: int, device, rank: int = 0) -> KeySource:
    """Keys from one torch generator per chunk (see ``chunk_seed``; rank
    ``rank`` of a sharded run seeds it with ``rank_chunk_seed``): Alice's
    key bits first, then the error-position bits and, with
    ``punctured=True``, Alice's punctured bits (a fair draw over all N
    positions). Fixed-rate runs draw exactly the first two."""
    device = torch.device(device)

    def source(sim_number, chunk_index, batch, num_bits, punctured=False):
        gen = torch.Generator(device=device)
        gen.manual_seed(rank_chunk_seed(seed, sim_number, chunk_index, rank))
        alice = generate_keys(gen, batch, num_bits, device)
        bits = random_bits(gen, batch, num_bits, device)
        if not punctured:
            return alice, bits
        return alice, bits, generate_keys(gen, batch, num_bits, device)

    return source


# Frame-position classes of the rate-adaptive extension
# (reference: src/qkd_ldpc_algorithm.cpp:1148-1174).
_CLASS_PAYLOAD = 0
_CLASS_PUNCTURED = 1
_CLASS_SHORTENED = 2


def make_frame_plan(num_bits: int, params: HMatrixParams) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side encoding of one combination's frame extension.

    Returns ``(pos_class [N] int8, payload_gather [N] int32)`` where
    ``payload_gather[i]`` is the payload-key ordinal feeding frame position i
    (0 for non-payload positions).
    """
    pos_class = np.zeros(num_bits, dtype=np.int8)
    pos_class[params.punctured_bits] = _CLASS_PUNCTURED
    pos_class[params.shortened_bits] = _CLASS_SHORTENED
    payload_mask = pos_class == _CLASS_PAYLOAD
    payload_gather = np.zeros(num_bits, dtype=np.int32)
    payload_gather[payload_mask] = np.arange(
        int(payload_mask.sum()), dtype=np.int32
    )
    return pos_class, payload_gather


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.tensor(np.asarray(x), device=device).to(dtype).contiguous()


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_trials_traced(matrix: HMatrix, comb: SimCombination, cfg: Config,
                       frames: Callable, batch: int):
    """Host-side trial loop through the f64 oracle with console tracing
    (the reference emits its traces from inside the per-trial decoders,
    src/qkd_ldpc_algorithm.cpp:88-99, :1094-1116). ``frames(chunk_index)``
    gives a chunk's ``(alice_frame [B,N] int8, llr [B,N] float64)``, the
    frames the untraced float64 run decodes; a short last chunk keeps its
    first frames. Returns per-trial (syndromes_match, keys_match,
    iterations)."""
    trials = cfg.trials_number
    alice_parts, llr_parts = [], []
    done = 0
    chunk_index = 0
    while done < trials:
        take = min(batch, trials - done)
        alice, llr = frames(chunk_index)
        alice_parts.append(alice[:take].cpu().numpy())
        llr_parts.append(llr[:take].cpu().numpy())
        done += take
        chunk_index += 1
    alice_frames = np.concatenate(alice_parts)
    llr_frames = np.concatenate(llr_parts)

    syn = np.zeros(trials, dtype=bool)
    keys = np.zeros(trials, dtype=bool)
    iters = np.zeros(trials, dtype=np.int32)
    for t in range(trials):
        syndrome = oracle_syndrome(matrix.check_nodes, alice_frames[t])
        decision, ok, it, _ = traced_decode(
            matrix,
            llr_frames[t],
            syndrome,
            cfg,
            comb.scaling_factors.primary,
            comb.scaling_factors.secondary,
        )
        syn[t] = ok
        keys[t] = bool(np.array_equal(decision, alice_frames[t]))
        iters[t] = it
        if cfg.trace_qkd_ldpc:
            print(f"Trial {t}: iterations={it} syndromes_match={ok} "
                  f"keys_match={keys[t]}")
    return syn, keys, iters


@dataclass(frozen=True)
class ChunkArgs:
    """One combination's inputs to a chunk step, the counterpart of the JAX
    step's scalar arguments: the combination's number, the exact error
    count, the channel-LLR magnitude in the run's dtype, the scaling
    factors and the clamp (primary, secondary, threshold) and, in
    rate-adaptive runs, the frame plan as tensors on the step's device
    (is_payload [N] bool, is_punctured [N] bool, payload_gather [N] int64;
    ``make_frame_plan``)."""

    sim_number: int
    num_errors: int
    log_p: float
    scalars: Tuple[float, float, float]
    plan: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


class ChunkStep:
    """One rank's decode of every chunk: ``frames`` frames of it, from the
    chunk's frame ``frame0`` on, through the engine ``select_engine`` picks.

    ``step(args, chunk_index, take)`` returns the per-frame
    ``(syndromes_match, keys_match, iterations)`` of those frames as NumPy
    arrays (``take``, the chunk's frames that count, is for steps that
    reduce on the device; this one returns all ``frames``); ``decode`` the
    same as tensors on ``device``.

    How a chunk's keys are drawn:
      * a fixed-rate run on an engine with an mc mode (``montecarlo_trial``)
        and no ``key_source`` makes one call of it with the chunk's own seed
        (``chunk_seed``) and first frame ``frame0``: the keys are a function
        of the frame's index in the chunk, so ranks that split a chunk by
        frame offset decode the frames of the single-rank run;
      * every other run (the ``stream`` and ``xla`` engines, rate-adaptive
        runs) draws ``frames`` frames of keys from ``key_source``, or from a
        generator seeded by ``rank_chunk_seed(seed, sim_number,
        chunk_index, rank)``, which is ``chunk_seed`` at rank 0. A short
        last chunk keeps its first ``take`` frames in the caller.

    ``traced=True`` builds no engine: the traced path only asks for the
    chunk's frames (``chunk_frames``) in float64.
    """

    reduces = False

    def __init__(self, matrix: HMatrix, cfg: Config, device, frames: int,
                 frame0: int = 0, rank: int = 0,
                 key_source: Optional[KeySource] = None,
                 traced: bool = False) -> None:
        self.device = torch.device(device)
        self.frames = frames
        self.frame0 = frame0
        self.seed = cfg.simulation_seed
        self.n_bits = matrix.num_bit_nodes
        self.rate_adaptive = cfg.enable_code_rate_adaptation
        self.dtype = torch.float64 if traced else _DTYPES[cfg.dtype]
        self.source = key_source or default_key_source(cfg.simulation_seed,
                                                       self.device, rank)
        self.mc = None
        self.trial = None
        engine = select_engine(matrix, cfg)
        if traced:
            return
        if not self.rate_adaptive and key_source is None:
            self.mc = montecarlo_trial(engine, matrix, cfg)
        if self.rate_adaptive:
            self.trial = frame_engine_trial(engine, matrix, cfg)
        elif self.mc is None:
            self.trial = _make_trial(engine, matrix, cfg)

    def chunk_keys(self, args: ChunkArgs, chunk_index: int):
        """(alice, bob, Alice's punctured draw or None) of one chunk."""
        with span("sim.keys"):
            with span("channel.keys"):
                keys = self.source(
                    args.sim_number, chunk_index, self.frames, self.n_bits,
                    **({"punctured": True} if self.rate_adaptive else {}))
                alice = _as_tensor(keys[0], torch.int8, self.device)
                punct = (_as_tensor(keys[2], torch.int8, self.device)
                         if self.rate_adaptive else None)
            with span("channel.inject"):
                bob = inject_errors(
                    _as_tensor(keys[1], torch.int64, self.device), alice,
                    args.num_errors, wide=True)
        return alice, bob, punct

    def chunk_frames(self, args: ChunkArgs, chunk_index: int):
        """(alice_frame, llr in the step's dtype) of one chunk."""
        with span("sim.frames"):
            alice, bob, punct = self.chunk_keys(args, chunk_index)
            if self.rate_adaptive:
                return build_frames(alice, bob, punct, *args.plan,
                                    args.log_p, self.dtype)
            lp = torch.tensor(args.log_p, dtype=self.dtype,
                              device=self.device)
            return alice, torch.where(bob == 1, -lp, lp)

    def decode(self, args: ChunkArgs, chunk_index: int):
        if self.mc is not None:
            with span("sim.decode"):
                return self.mc(
                    chunk_seed(self.seed, args.sim_number, chunk_index),
                    self.frame0, self.frames, args.num_errors, args.log_p,
                    *args.scalars, device=self.device)
        if self.rate_adaptive:
            frames = self.chunk_frames(args, chunk_index)
            with span("sim.decode"):
                return self.trial(*frames, *args.scalars)
        alice, bob, _ = self.chunk_keys(args, chunk_index)
        with span("sim.decode"):
            return self.trial(alice, bob, args.log_p, *args.scalars)

    def __call__(self, args: ChunkArgs, chunk_index: int, take: int):
        conv, keys, iters = self.decode(args, chunk_index)
        with span("sim.fetch"):
            return (conv.cpu().numpy(), keys.cpu().numpy(),
                    iters.cpu().numpy())


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _new_result(matrix: HMatrix, comb: SimCombination, sim_number: int,
                accurate_qber: float) -> SimResult:
    return SimResult(
        sim_number=sim_number,
        matrix_filename=Path(matrix.source_path).name if matrix.source_path else "",
        is_regular=matrix.is_regular,
        num_bit_nodes=matrix.num_bit_nodes,
        num_check_nodes=matrix.num_check_nodes,
        config_qber=comb.config_qber,
        accurate_qber=accurate_qber,
        delta=comb.matrix_params.delta,
        efficiency=comb.matrix_params.efficiency,
        punctured_fraction=comb.matrix_params.punctured_fraction,
        shortened_fraction=comb.matrix_params.shortened_fraction,
        adapted_code_rate=comb.matrix_params.adapted_code_rate,
        scaling_factors=comb.scaling_factors,
    )


def run_combination(
    matrix: HMatrix,
    comb: SimCombination,
    cfg: Config,
    sim_number: int,
    device,
    progress: Optional[Callable[[int], None]] = None,
    key_source: Optional[KeySource] = None,
    step_factory: Optional[Callable[[HMatrix, Config, int], Callable]] = None,
) -> SimResult:
    """Execute all trials of one combination as device batches of
    ``tpu.batch_size`` frames (all trials when 0).

    Each chunk is one call of a chunk step (``ChunkStep``): one call of the
    engine's mc mode with the chunk's seed (the keys and exactly
    ``floor(N * QBER)`` errors drawn in the kernel, with 32-bit sort keys,
    as the JAX mc kernels), or a full batch of keys from ``key_source`` (or
    the default generator) with exactly ``floor(N * QBER)`` errors injected
    by 64-bit sort keys and the engine's trial (see ``select_engine``). A
    short last chunk keeps its first ``take`` frames. A rate-adaptive run
    builds the chunk's frames from those keys and Alice's punctured draw
    (``channel.build_frames``, the combination's ``make_frame_plan``) and
    decodes them through ``frame_engine_trial``. A traced run (any
    ``trace_*`` flag) builds the
    same keys and frames in float64 on ``device`` and decodes them on the
    host through the oracle, with tracing (``_run_trials_traced``); its
    per-trial runtime is the whole loop's wall time over the trials. With
    throughput measurement on, chunk 0 of an untraced run is run once
    untimed first, so the kernel build and first-call costs stay out of the
    timings; each chunk's timed region starts after a device synchronize
    and ends when its results are on the host.

    ``step_factory(matrix, cfg, batch)`` replaces the chunk step, e.g.
    ``parallel.mesh_step_factory``'s, which splits each chunk over ranks;
    its step runs on ``device``. A step with ``reduces = True`` returns the
    six reduced statistics per chunk, which ``_run_chunks_reduced``
    combines. Traced runs ignore it, as the JAX package's do. A
    ``key_source`` feeds one process's chunks and cannot be combined with
    it.

    The call is the span ``sim.combination``; inside it, building the step
    is ``sim.step``, each call of the step ``sim.chunk`` and the statistics
    ``sim.stats`` (``utils.span``).
    """
    with span("sim.combination"):
        return _combination(matrix, comb, cfg, sim_number, device, progress,
                            key_source, step_factory)


def _combination(matrix, comb, cfg, sim_number, device, progress,
                 key_source, step_factory) -> SimResult:
    """The body of ``run_combination``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available")
    if key_source is not None and step_factory is not None:
        raise ValueError("a key_source feeds the chunks of one process; it "
                         "cannot be combined with a step_factory")
    n_bits = matrix.num_bit_nodes
    num_errors = exact_error_count(n_bits, comb.config_qber)
    if num_errors == 0:
        raise SimulationError(f"Key size '{n_bits}' is too small for QBER.")
    accurate_qber = num_errors / n_bits

    trials = cfg.trials_number
    batch = cfg.batch_size if cfg.batch_size > 0 else trials
    batch = min(batch, trials)
    traced = (cfg.trace_qkd_ldpc or cfg.trace_decoding_alg
              or cfg.trace_decoding_alg_llr)
    dtype = torch.float64 if traced else _DTYPES[cfg.dtype]
    plan = None
    if cfg.enable_code_rate_adaptation:
        pos_class, payload_gather = make_frame_plan(n_bits, comb.matrix_params)
        plan = (
            torch.as_tensor(pos_class == _CLASS_PAYLOAD, device=device),
            torch.as_tensor(pos_class == _CLASS_PUNCTURED, device=device),
            torch.as_tensor(payload_gather.astype(np.int64), device=device),
        )
    args = ChunkArgs(
        sim_number, num_errors, log_ratio(accurate_qber, dtype),
        (comb.scaling_factors.primary, comb.scaling_factors.secondary,
         cfg.msg_llr_threshold),
        plan)
    if cfg.enable_code_rate_adaptation or cfg.enable_privacy_maintenance:
        out_key_length = n_bits - len(comb.matrix_params.bits_to_remove)
    else:
        out_key_length = n_bits

    if traced:
        with span("sim.step"):
            chunks = ChunkStep(matrix, cfg, device, batch,
                               key_source=key_source, traced=True)
        t0 = time.perf_counter()
        syn_all, keys_all, iters_all = _run_trials_traced(
            matrix, comb, cfg, lambda c: chunks.chunk_frames(args, c), batch)
        elapsed_us = (time.perf_counter() - t0) * 1e6
        runtimes = np.full(trials, elapsed_us / trials)
        if progress is not None:
            progress(trials)
    else:
        with span("sim.step"):
            if step_factory is None:
                step = ChunkStep(matrix, cfg, device, batch,
                                 key_source=key_source)
            else:
                step = step_factory(matrix, cfg, batch)
        if step_factory is not None:
            step_device = getattr(step, "device", device)
            if not _same_device(step_device, device):
                raise ValueError(f"the step runs on {step_device}, the "
                                 f"combination on {device}")
        timed = cfg.enable_throughput_measurement
        if timed:
            with span("sim.chunk"):
                step(args, 0, batch)
        if getattr(step, "reduces", False):
            return _run_chunks_reduced(
                matrix, comb, cfg, sim_number, accurate_qber, step,
                lambda chunk_index, take: (args, chunk_index, take),
                batch, trials, out_key_length, progress)
        syn_parts: List[np.ndarray] = []
        key_parts: List[np.ndarray] = []
        iter_parts: List[np.ndarray] = []
        runtime_parts: List[np.ndarray] = []
        done = 0
        chunk_index = 0
        while done < trials:
            take = min(batch, trials - done)
            if timed:
                _synchronize(device)
                t0 = time.perf_counter()
            with span("sim.chunk"):
                syn, keys, iters = step(args, chunk_index, take)
            if timed:
                # Per-trial runtime = batch wall time / batch size, as in
                # the JAX package: the batch is the unit of device work.
                elapsed_us = (time.perf_counter() - t0) * 1e6
                runtime_parts.append(np.full(take, elapsed_us / batch))
            syn_parts.append(syn[:take])
            key_parts.append(keys[:take])
            iter_parts.append(iters[:take])
            done += take
            chunk_index += 1
            if progress is not None:
                progress(take)
        syn_all = np.concatenate(syn_parts)
        keys_all = np.concatenate(key_parts)
        iters_all = np.concatenate(iter_parts)
        runtimes = np.concatenate(runtime_parts) if timed else None

    with span("sim.stats"):
        result = _new_result(matrix, comb, sim_number, accurate_qber)
        process_trials_results(
            cfg, syn_all, keys_all, iters_all,
            runtimes if cfg.enable_throughput_measurement else None,
            out_key_length, result,
        )
    return result


def _run_chunks_reduced(
    matrix: HMatrix,
    comb: SimCombination,
    cfg: Config,
    sim_number: int,
    accurate_qber: float,
    step: Callable,
    step_args: Callable,
    batch: int,
    trials: int,
    out_key_length: int,
    progress,
) -> SimResult:
    """Chunk loop for steps that reduce on the device (the JAX package's
    ``_run_chunks_reduced``, the same contract): ``step(*step_args(
    chunk_index, take))`` returns a chunk's six statistics (``n_dec,
    n_ldpc, it_sum, it_m2, it_min, it_max``; ``parallel.psum_stats``), and
    the reference's statistics (iteration stats over syndrome-successful
    trials, population std-dev, src/simulation.cpp:580-690) are rebuilt
    from them. Variance combines the chunks' M2 sums (deviations about each
    chunk's mean) with Chan's pairwise update in float64 on the host.
    Throughput, where measured, is per chunk, weighted by its trials. Each
    call of the step is the span ``sim.chunk``, each combine ``sim.stats``."""
    timed = cfg.enable_throughput_measurement
    n_dec = 0.0
    n_ldpc = 0.0
    it_sum = 0.0
    it_m2 = 0.0
    it_min: Optional[float] = None
    it_max: Optional[float] = None
    tp_chunks: List[Tuple[int, float]] = []  # (trials in chunk, us/trial)
    done = 0
    chunk_index = 0
    while done < trials:
        take = min(batch, trials - done)
        if timed:
            t0 = time.perf_counter()
        with span("sim.chunk"):
            d, l, s, m2, mn, mx = step(*step_args(chunk_index, take))
        if timed:
            tp_chunks.append((take, (time.perf_counter() - t0) * 1e6 / batch))
        with span("sim.stats"):
            d = float(d)
            if d > 0:
                # Chan's parallel-variance combination of (n, sum, M2)
                # pairs.
                delta = float(s) / d - (it_sum / n_dec if n_dec > 0 else 0.0)
                it_m2 += float(m2) + (
                    delta * delta * n_dec * d / (n_dec + d)
                    if n_dec > 0 else 0.0
                )
            n_dec += d
            n_ldpc += float(l)
            it_sum += float(s)
            if d > 0:
                it_min = float(mn) if it_min is None else min(it_min, float(mn))
                it_max = float(mx) if it_max is None else max(it_max, float(mx))
        done += take
        chunk_index += 1
        if progress is not None:
            progress(take)

    with span("sim.stats"):
        result = _new_result(matrix, comb, sim_number, accurate_qber)
        if n_dec > 0:
            mean = it_sum / n_dec
            var = max(it_m2 / n_dec, 0.0)
            result.iter_success_mean = mean
            result.iter_success_std = var**0.5
            result.iter_success_min = int(it_min)
            result.iter_success_max = int(it_max)
    if timed and tp_chunks:
        rtt_us = cfg.rtt_ms * 1000.0 if cfg.consider_rtt else 0.0
        tps = np.array(
            [out_key_length * 1e6 / (rt + rtt_us) for _, rt in tp_chunks]
        )
        w = np.array([t for t, _ in tp_chunks], dtype=np.float64)
        mean = float((tps * w).sum() / w.sum())
        var = max(float((tps * tps * w).sum() / w.sum() - mean * mean), 0.0)
        result.throughput_mean = int(mean)
        result.throughput_std = int(var**0.5)
        result.throughput_min = int(tps.min())
        result.throughput_max = int(tps.max())
    result.ratio_trials_success_decoding = n_dec / trials
    result.ratio_trials_success_ldpc = n_ldpc / trials
    return result


def _campaign_fingerprint(sim_inputs: Sequence[SimInput], cfg: Config) -> str:
    """Stable id of a sweep campaign for checkpoint/resume: config fields
    that affect results plus the matrix file list. The JAX package's tuple
    plus ``tpu.force_engine``: here the engine decides whether a chunk's
    keys come from the kernel's Philox stream or from the torch generator,
    so a resumed checkpoint must not mix engines."""
    parts = [
        repr(
            (
                cfg.trials_number,
                cfg.simulation_seed,
                int(cfg.decoding_algorithm),
                cfg.decoding_alg_max_iterations,
                cfg.enable_privacy_maintenance,
                cfg.enable_code_rate_adaptation,
                cfg.enable_untainted_puncturing,
                cfg.enable_msg_llr_threshold,
                cfg.msg_llr_threshold,
                cfg.dtype,
                # batch_size, use_pallas and the engine change trial
                # realizations (chunk seeds, the mc kernels' in-kernel
                # draw against torch keys).
                cfg.batch_size,
                cfg.use_pallas,
                cfg.schedule,
                cfg.force_engine,
            )
        )
    ]
    for s in sim_inputs:
        parts.append(str(s.matrix_path))
        for c in s.combinations:
            mp = c.matrix_params
            parts.append(
                repr(
                    (
                        c.config_qber,
                        c.scaling_factors.primary,
                        c.scaling_factors.secondary,
                        mp.delta,
                        mp.efficiency,
                        mp.punctured_bits.tobytes(),
                        mp.shortened_bits.tobytes(),
                        mp.bits_to_remove.tobytes(),
                    )
                )
            )
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]


def _json_value(value):
    """A ``SimResult`` field as a Python scalar (NumPy scalars do not
    serialise); floats round-trip through JSON exactly."""
    if isinstance(value, dict):
        return {k: _json_value(v) for k, v in value.items()}
    if isinstance(value, np.generic):
        return value.item()
    return value


def save_checkpoint(path, fingerprint: str, results: Sequence[SimResult]) -> None:
    """JSON checkpoint of the completed combinations, replaced atomically.
    The reference writes results only at campaign end and loses everything
    on a crash (reference: src/main.cpp:185); this checkpoints each finished
    combination and resumes mid-sweep."""
    payload = {
        "fingerprint": fingerprint,
        "results": [_json_value(dataclasses.asdict(r)) for r in results],
    }
    tmp = Path(str(path) + ".tmp")
    tmp.write_text(json.dumps(payload))
    tmp.replace(path)


def load_checkpoint(path, fingerprint: str) -> List[SimResult]:
    """Load a matching checkpoint's completed results ([] when absent or
    from a different campaign)."""
    path = Path(path)
    if not path.exists():
        return []
    try:
        payload = json.loads(path.read_text())
    except (OSError, ValueError):
        return []
    if payload.get("fingerprint") != fingerprint:
        return []
    out = []
    for d in payload.get("results", []):
        sf = d.pop("scaling_factors", {})
        out.append(SimResult(**d, scaling_factors=ScalingFactors(**sf)))
    return out


def qkd_ldpc_batch_simulation(
    sim_inputs: Sequence[SimInput],
    cfg: Config,
    device,
    progress: Optional[Callable[[int, int], None]] = None,
    key_source: Optional[KeySource] = None,
    checkpoint_path=None,
    step_factory: Optional[Callable[[HMatrix, Config, int], Callable]] = None,
) -> List[SimResult]:
    """Run the full sweep (reference: src/simulation.cpp:693-768).

    ``progress(trials_done_increment, trials_total)`` ticks per chunk. When
    ``checkpoint_path`` is given, each finished combination is checkpointed
    and a matching prior checkpoint resumes the sweep mid-way, its trials
    credited to ``progress`` first. The checkpoint stays on disk; the caller
    removes it once the results have landed (``cli.py`` deletes it after
    ``write_file``).

    ``step_factory`` goes to every ``run_combination`` (e.g.
    ``parallel.mesh_step_factory(mesh)``: each rank calls this function and
    returns the same results, throughput apart). Every rank reads the
    checkpoint; only the factory's rank 0 (its ``rank`` attribute, 0 where
    it has none) writes it, where the JAX package has every process write
    the same file.
    """
    sim_total = sum(len(s.combinations) for s in sim_inputs)
    trials_total = sim_total * cfg.trials_number

    fingerprint = ""
    results: List[SimResult] = []
    if checkpoint_path is not None:
        fingerprint = _campaign_fingerprint(sim_inputs, cfg)
        results = load_checkpoint(checkpoint_path, fingerprint)
        if results and progress:
            progress(len(results) * cfg.trials_number, trials_total)

    writes_checkpoint = getattr(step_factory, "rank", 0) == 0
    sim_number = 0
    cb = (lambda inc: progress(inc, trials_total)) if progress else None
    for sim_in in sim_inputs:
        for comb in sim_in.combinations:
            if sim_number < len(results):
                sim_number += 1  # already completed in a prior run
                continue
            res = run_combination(
                sim_in.matrix, comb, cfg, sim_number, device,
                progress=cb, key_source=key_source, step_factory=step_factory,
            )
            res.matrix_filename = sim_in.matrix_path.name
            results.append(res)
            sim_number += 1
            if checkpoint_path is not None and writes_checkpoint:
                save_checkpoint(checkpoint_path, fingerprint, results)
    return results


# ---------------------------------------------------------------------------
# CSV results writer
# ---------------------------------------------------------------------------


def _num(value: float, prec: int) -> str:
    """Fixed-precision number with comma decimal separator (the reference
    writes with a custom ru-style locale, src/simulation.cpp:10-23)."""
    return f"{value:.{prec}f}".replace(".", ",")


def _gen(value: float) -> str:
    """General formatting ({:L} in the reference) with comma separator."""
    s = repr(float(value)) if not float(value).is_integer() else str(int(value))
    return s.replace(".", ",")


def result_filename(cfg: Config, sim_duration: str) -> str:
    """Self-describing base filename (reference: src/simulation.cpp:81-91)."""
    alg_names = {
        DecodingAlgorithm.SPA: "SPA",
        DecodingAlgorithm.SPA_APPROX: "SPA-LIN-APPROX",
        DecodingAlgorithm.NMSA: "NMSA",
        DecodingAlgorithm.OMSA: "OMSA",
        DecodingAlgorithm.ANMSA: "ANMSA",
        DecodingAlgorithm.AOMSA: "AOMSA",
    }
    if cfg.enable_code_rate_adaptation:
        punct = "untainted" if cfg.enable_untainted_puncturing else "random"
        rate_adapt = f"ON[punct={punct}]"
    else:
        rate_adapt = "OFF"
    rtt_part = ""
    if cfg.enable_throughput_measurement and cfg.consider_rtt:
        rtt_part = f",RTT={cfg.rtt_ms:.3f}ms"
    return (
        "ldpc("
        f"trial_num={cfg.trials_number},"
        f"dec_alg={alg_names[cfg.decoding_algorithm]},"
        f"max_dec_alg_iters={cfg.decoding_alg_max_iterations},"
        f"priv_maint={'ON' if cfg.enable_privacy_maintenance else 'OFF'},"
        f"rate_adapt={rate_adapt}"
        f"{rtt_part},"
        f"seed={cfg.simulation_seed},"
        f"sim_duration={sim_duration}"
        ")"
    )


def write_file(
    results: Sequence[SimResult],
    cfg: Config,
    sim_duration: str,
    directory,
) -> Path:
    """Write the per-combination CSV (reference: src/simulation.cpp:4-176):
    same filename scheme with collision ``_k`` suffix, semicolon-separated
    columns, comma decimal separator, FER rounded to trial granularity.
    With throughput measurement on, a sidecar ``.THROUGHPUT_NOTE.txt``
    records that per-trial runtime is chunk wall time over chunk size."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)

    base = result_filename(cfg, sim_duration)
    path = directory / f"{base}.csv"
    count = 1
    while path.exists():
        path = directory / f"{base}_{count}.csv"
        count += 1

    scaling_header = {
        DecodingAlgorithm.NMSA: ";ALPHA",
        DecodingAlgorithm.OMSA: ";BETA",
        DecodingAlgorithm.ANMSA: ";ALPHA;NU",
        DecodingAlgorithm.AOMSA: ";BETA;SIGMA",
    }.get(cfg.decoding_algorithm, "")

    header = (
        "#;MATRIX_FILENAME;TYPE;R;M;N;CONFIG_QBER;ACCURATE_QBER;"
        "ITER_SUCCESS_MEAN;ITER_SUCCESS_STD;ITER_SUCCESS_MIN;"
        "ITER_SUCCESS_MAX;RATIO_SUCCESS_DEC;RATIO_SUCCESS_LDPC;FER"
    )
    if cfg.enable_code_rate_adaptation:
        header += ";DELTA;EFFICIENCY;PUNCT_FRACTION;SHORT_FRACTION;R_ADAPTED"
    if cfg.enable_throughput_measurement:
        header += ";THROUGHPUT_MEAN;THROUGHPUT_STD;THROUGHPUT_MIN;THROUGHPUT_MAX"
    header += scaling_header

    lines = [header]
    for r in results:
        fer = 1.0 - r.ratio_trials_success_ldpc
        fer = round(fer * cfg.trials_number) / cfg.trials_number
        code_rate = 1.0 - r.num_check_nodes / r.num_bit_nodes
        line = ";".join(
            [
                str(r.sim_number),
                r.matrix_filename,
                "regular" if r.is_regular else "irregular",
                _num(code_rate, 3),
                str(r.num_check_nodes),
                str(r.num_bit_nodes),
                _num(r.config_qber, 4),
                _num(r.accurate_qber, 4),
                _num(r.iter_success_mean, 2),
                _num(r.iter_success_std, 2),
                str(r.iter_success_min),
                str(r.iter_success_max),
                _gen(r.ratio_trials_success_decoding),
                _gen(r.ratio_trials_success_ldpc),
                _gen(fer),
            ]
        )
        if cfg.enable_code_rate_adaptation:
            line += ";" + ";".join(
                [
                    _num(r.delta, 3),
                    _num(r.efficiency, 3),
                    _num(r.punctured_fraction, 3),
                    _num(r.shortened_fraction, 3),
                    _num(r.adapted_code_rate, 3),
                ]
            )
        if cfg.enable_throughput_measurement:
            line += ";" + ";".join(
                [
                    str(r.throughput_mean),
                    str(r.throughput_std),
                    str(r.throughput_min),
                    str(r.throughput_max),
                ]
            )
        if cfg.decoding_algorithm.uses_scaling_factors:
            line += ";" + _num(r.scaling_factors.primary, 3)
        if cfg.decoding_algorithm.is_adaptive:
            line += ";" + _num(r.scaling_factors.secondary, 3)
        lines.append(line)

    path.write_text("\n".join(lines) + "\n")
    if cfg.enable_throughput_measurement:
        path.with_suffix(".THROUGHPUT_NOTE.txt").write_text(
            "THROUGHPUT_* columns in the sibling CSV are computed from "
            "device-batch wall times (per-trial runtime = chunk wall time / "
            "chunk size), not per-trial timers as in the reference "
            "implementation; MIN/MAX/STD therefore reflect chunk-level "
            "variation. Means are directly comparable. See PARITY.md §3.\n"
        )
    return path
