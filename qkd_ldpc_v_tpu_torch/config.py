"""Configuration schema and JSON parser.

A copy of ``qkd_ldpc_v_tpu/config.py``: the same JSON schema, the same
validation and the same ``Config`` dataclass, including the optional
``tpu`` object (``batch_size``, ``dtype``, ``use_pallas``, ``schedule``,
...), so one config file drives both packages. It is copied rather than
imported because importing ``qkd_ldpc_v_tpu`` imports JAX.

Mirrors the reference JSON schema and validation semantics
(reference: src/config.cpp:89-403, src/config.hpp:103-196) but replaces the
reference's global mutable ``CFG`` with an immutable, hashable dataclass.

Every config key, range rule, and error condition of the current reference
schema is supported; the legacy schema found in 29 of the reference's
``configs_all`` files is intentionally unsupported (same as the reference
parser).
"""

from __future__ import annotations

import enum
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence, Tuple

EPSILON = 1e-6  # step/range sanity slack (reference: src/config.hpp:199)


class DecodingAlgorithm(enum.IntEnum):
    """LDPC decoding algorithms (reference: src/config.hpp:201)."""

    SPA = 0
    SPA_APPROX = 1
    NMSA = 2
    OMSA = 3
    ANMSA = 4
    AOMSA = 5

    @property
    def display_name(self) -> str:
        return {
            DecodingAlgorithm.SPA: "SPA",
            DecodingAlgorithm.SPA_APPROX: "SPA(lin approx)",
            DecodingAlgorithm.NMSA: "NMSA",
            DecodingAlgorithm.OMSA: "OMSA",
            DecodingAlgorithm.ANMSA: "ANMSA",
            DecodingAlgorithm.AOMSA: "AOMSA",
        }[self]

    @property
    def uses_scaling_factors(self) -> bool:
        return self >= DecodingAlgorithm.NMSA

    @property
    def is_adaptive(self) -> bool:
        return self in (DecodingAlgorithm.ANMSA, DecodingAlgorithm.AOMSA)


class MatrixFormat(enum.IntEnum):
    """Sparse-matrix file formats (reference: src/config.hpp:202)."""

    UNCOMPRESSED = 0
    ALIST = 1
    SPARSE_1 = 2  # MacKay/PEG: N / M / max-row-weight header, 1-based rows
    SPARSE_2 = 3  # "N M" header, 0-based rows then columns
    QC = 4  # quasi-cyclic base-graph shifts (TPU extension; models/qc.py)

    @property
    def display_name(self) -> str:
        return {
            MatrixFormat.UNCOMPRESSED: "Sparse (uncompressed)",
            MatrixFormat.ALIST: "Sparse (alist)",
            MatrixFormat.SPARSE_1: "Sparse (1)",
            MatrixFormat.SPARSE_2: "Sparse (2)",
            MatrixFormat.QC: "Quasi-cyclic (TPU extension)",
        }[self]

    @property
    def directory_name(self) -> str:
        """Matrix directory conventions (reference: src/main.cpp:7-11)."""
        return {
            MatrixFormat.UNCOMPRESSED: "matrices_uncompressed",
            MatrixFormat.ALIST: "matrices_alist",
            MatrixFormat.SPARSE_1: "matrices_1",
            MatrixFormat.SPARSE_2: "matrices_2",
            MatrixFormat.QC: "matrices_qc",
        }[self]


class ConfigError(ValueError):
    """Raised on invalid configuration content."""


@dataclass(frozen=True)
class ScalingFactorRange:
    """begin/end/step sweep; begin==end means a single value
    (reference: src/config.hpp:15-20)."""

    begin: float
    end: float
    step: float

    def values(self) -> Tuple[float, ...]:
        return _range_values(self.begin, self.end, self.step)


@dataclass(frozen=True)
class RScalingFactorMap:
    """code_rate -> scaling factor entry (reference: src/config.hpp:23-27)."""

    code_rate: float
    scaling_factor: float


@dataclass(frozen=True)
class ScalingFactorParams:
    """Range-or-map choice for one scaling factor
    (reference: src/config.hpp:30-47 primary/secondary blocks)."""

    use_range: bool = False
    range: Optional[ScalingFactorRange] = None
    maps: Tuple[RScalingFactorMap, ...] = ()


@dataclass(frozen=True)
class RQBERRange:
    """code_rate -> QBER sweep range (reference: src/config.hpp:58-64)."""

    code_rate: float
    qber_begin: float
    qber_end: float
    qber_step: float

    def qber_values(self) -> Tuple[float, ...]:
        return _range_values(self.qber_begin, self.qber_end, self.qber_step)


@dataclass(frozen=True)
class RAdaptationParametersRange:
    """code_rate -> (delta range, efficiency range)
    (reference: src/config.hpp:70-79)."""

    code_rate: float
    delta_begin: float
    delta_end: float
    delta_step: float
    efficiency_begin: float
    efficiency_end: float
    efficiency_step: float

    def delta_values(self) -> Tuple[float, ...]:
        return _range_values(self.delta_begin, self.delta_end, self.delta_step)

    def efficiency_values(self) -> Tuple[float, ...]:
        return _range_values(
            self.efficiency_begin, self.efficiency_end, self.efficiency_step
        )


@dataclass(frozen=True)
class QBERAdaptationParameters:
    """One (QBER, delta, efficiency) triple (reference: src/config.hpp:89-94)."""

    qber: float
    delta: float
    efficiency: float


@dataclass(frozen=True)
class RQBERAdaptationParametersMap:
    """code_rate -> (QBER, delta, efficiency) (reference: src/config.hpp:97-101)."""

    code_rate: float
    params: QBERAdaptationParameters


@dataclass(frozen=True)
class Config:
    """Immutable run configuration (reference: src/config.hpp:103-196).

    ``threads_number`` is kept for schema compatibility; on TPU the analogue
    is the frame-batch size / device mesh, see ``batch_size`` extensions.
    """

    threads_number: int = 1
    trials_number: int = 1
    simulation_seed: int = 0
    enable_privacy_maintenance: bool = False
    enable_throughput_measurement: bool = False
    consider_rtt: bool = False
    rtt_ms: float = 0.0
    decoding_algorithm: DecodingAlgorithm = DecodingAlgorithm.SPA
    primary: ScalingFactorParams = field(default_factory=ScalingFactorParams)
    secondary: ScalingFactorParams = field(default_factory=ScalingFactorParams)
    decoding_alg_max_iterations: int = 100
    matrix_format: MatrixFormat = MatrixFormat.UNCOMPRESSED
    trace_qkd_ldpc: bool = False
    trace_decoding_alg: bool = False
    trace_decoding_alg_llr: bool = False
    enable_msg_llr_threshold: bool = False
    msg_llr_threshold: float = 0.0
    r_qber_ranges: Tuple[RQBERRange, ...] = ()
    enable_code_rate_adaptation: bool = False
    enable_untainted_puncturing: bool = False
    use_adaptation_parameters_ranges: bool = False
    r_adapt_params_ranges: Tuple[RAdaptationParametersRange, ...] = ()
    r_qber_adapt_params_maps: Tuple[RQBERAdaptationParametersMap, ...] = ()

    # --- TPU-native extensions (absent from the reference schema; optional
    # keys "tpu": {...} in the JSON, defaulted so every reference config
    # parses unchanged) ---
    batch_size: int = 0  # 0 => decode all trials of a combination at once
    # Decoder message dtype: float32 | float64 | bfloat16. float64 is the
    # reference-exact parity mode; bfloat16 halves message bandwidth (SPA in
    # bf16 requires enable_msg_llr_threshold: bf16 tanh saturates at
    # |LLR| ~ 9 and atanh(1) = inf — see tests/test_decoders.py).
    dtype: str = "float32"
    use_pallas: bool = False  # opt into fused Pallas kernels where available
    # Message-passing schedule: "flooding" is the reference's (parity
    # contract); "layered" (serial-C) is a performance mode — the fused QC
    # kernel processes block-rows in sequence, updating bit totals within
    # the sweep, converging in ~half the iterations at equal-or-better FER
    # (min-sum family; the adaptive pair's factor uses *current* decisions.
    # SPA and the other engines warn and flood).
    schedule: str = "flooding"
    # Two-phase straggler re-decode: phase 1 runs the whole batch to this
    # iteration cap; unconverged frames are re-decoded from scratch in a
    # small batch at the full cap. Bit-identical to a single full-cap decode
    # (BP from the same init is deterministic), but the big batch stops
    # dragging at the cap for a few stragglers. -1 = auto (cap // 2 when the
    # cap is >= 64, else disabled), 0 = disabled, >0 = explicit phase-1 cap.
    # Applies to the XLA engines; under use_pallas only the streaming
    # engine honors it (explicit > 0 only — its per-group early exit runs
    # to the slowest frame of each group, which phase 1 clips). Measured
    # at the N=102400 working point it is break-even-to-slower (re-decode
    # restarts from scratch; BASELINE.md) — prefer 0 there.
    phase1_iterations: int = -1
    # Engine override for A/B measurement: "" (default) keeps the
    # feasibility-gated cascade (simulation.pallas_engine: qc -> qc_stream
    # -> generic -> stream -> xla); naming an engine forces it, and raises
    # if that engine cannot serve the matrix (no silent fallback).
    force_engine: str = ""


def _range_values(begin: float, end: float, step: float) -> Tuple[float, ...]:
    """Expand begin/end/step into values, inclusive of `end`.

    Matches the reference expansion rule `round((end-begin)/step)+1` steps
    (reference: src/simulation.cpp:198, 332).
    """
    if begin == end:
        return (begin,)
    steps = int(round((end - begin) / step)) + 1
    return tuple(begin + i * step for i in range(steps))


def _parse_scaling_factor_range(node: dict) -> ScalingFactorRange:
    """(reference: src/config.cpp:3-19)"""
    begin = float(node["begin"])
    end = float(node["end"])
    step = float(node["step"])
    if begin <= 0.0 or end <= 0.0 or step <= 0.0:
        raise ConfigError("Scaling factor range begin, end, step must be > 0!")
    if begin > end:
        raise ConfigError("Scaling factor range begin cannot be larger than end!")
    if begin != end and step - EPSILON > end - begin:
        raise ConfigError("Scaling factor range step is too large!")
    return ScalingFactorRange(begin, end, step)


def _parse_scaling_factor_maps(
    nodes: Sequence[dict], key: str
) -> Tuple[RScalingFactorMap, ...]:
    """(reference: src/config.cpp:21-50)"""
    maps = []
    for m in nodes:
        code_rate = float(m["code_rate"])
        scaling_factor = float(m[key])
        if code_rate <= 0.0 or code_rate >= 1.0:
            raise ConfigError("Code rate(R) must be: 0 < R < 1!")
        if scaling_factor <= 0.0:
            raise ConfigError("Scaling factor must be > 0!")
        maps.append(RScalingFactorMap(code_rate, scaling_factor))
    if not maps:
        raise ConfigError("Array with code rate(R) and scaling factor maps is empty!")
    maps.sort(key=lambda m: m.code_rate)
    return tuple(maps)


def _parse_scaling_factor_params(
    node: dict, use_key: str, range_key: str, maps_key: str, factor_key: str
) -> ScalingFactorParams:
    use_range = bool(node[use_key])
    if use_range:
        return ScalingFactorParams(
            use_range=True, range=_parse_scaling_factor_range(node[range_key])
        )
    return ScalingFactorParams(
        use_range=False, maps=_parse_scaling_factor_maps(node[maps_key], factor_key)
    )


def parse_config_data(config_path) -> Config:
    """Parse and validate one JSON config file.

    Semantics mirror the reference parser (src/config.cpp:89-403): same keys,
    same range validation, same sort-by-code_rate normalization, same
    ANMSA/AOMSA primary/secondary map-consistency enforcement.
    """
    config_path = Path(config_path)
    if not config_path.exists():
        raise ConfigError(f"Configuration file not found: {config_path}")
    if config_path.suffix != ".json":
        raise ConfigError(
            f"Configuration file must have a .json extension: {config_path}"
        )
    text = config_path.read_text()
    if not text.strip():
        raise ConfigError(f"Configuration file is empty: {config_path}")
    config = json.loads(text)
    if not config:
        raise ConfigError(f"Configuration file is empty: {config_path}")

    threads_number = int(config["threads_number"])
    if threads_number < 1:
        raise ConfigError("Number of threads must be >= 1!")

    trials_number = int(config["trials_number"])
    if trials_number < 1:
        raise ConfigError("Number of trials must be >= 1!")

    if bool(config["use_config_simulation_seed"]):
        simulation_seed = int(config["simulation_seed"])
    else:
        simulation_seed = int(time.time())

    enable_privacy_maintenance = bool(config["enable_privacy_maintenance"])
    enable_throughput_measurement = bool(config["enable_throughput_measurement"])
    consider_rtt = False
    rtt_ms = 0.0
    if enable_throughput_measurement:
        tm = config["throughput_measurement_parameters"]
        consider_rtt = bool(tm["consider_RTT"])
        if consider_rtt:
            rtt_ms = float(tm["RTT"])
            if rtt_ms < 0.0:
                raise ConfigError("Round-Trip Time (RTT) must be >= 0!")

    algorithm_idx = int(config["decoding_algorithm"])
    if algorithm_idx > DecodingAlgorithm.AOMSA:
        raise ConfigError(
            "Only six options are available: \n0 - SPA;\n1 - SPA (with linear "
            "approximation of tanh and atanh);\n2 - NMSA;\n3 - OMSA;\n4 - ANMSA;"
            "\n5 - AOMSA."
        )
    algorithm = DecodingAlgorithm(algorithm_idx)

    primary = ScalingFactorParams()
    secondary = ScalingFactorParams()
    if algorithm == DecodingAlgorithm.NMSA:
        primary = _parse_scaling_factor_params(
            config["min_sum_normalized_parameters"],
            "use_alpha_range", "alpha_range", "code_rate_alpha_maps", "alpha",
        )
    elif algorithm == DecodingAlgorithm.OMSA:
        primary = _parse_scaling_factor_params(
            config["min_sum_offset_parameters"],
            "use_beta_range", "beta_range", "code_rate_beta_maps", "beta",
        )
    elif algorithm == DecodingAlgorithm.ANMSA:
        node = config["adaptive_min_sum_normalized_parameters"]
        primary = _parse_scaling_factor_params(
            node, "use_alpha_range", "alpha_range", "code_rate_alpha_maps", "alpha"
        )
        secondary = _parse_scaling_factor_params(
            node, "use_nu_range", "nu_range", "code_rate_nu_maps", "nu"
        )
    elif algorithm == DecodingAlgorithm.AOMSA:
        node = config["adaptive_min_sum_offset_parameters"]
        primary = _parse_scaling_factor_params(
            node, "use_beta_range", "beta_range", "code_rate_beta_maps", "beta"
        )
        secondary = _parse_scaling_factor_params(
            node, "use_sigma_range", "sigma_range", "code_rate_sigma_maps", "sigma"
        )

    # ANMSA/AOMSA: when both factors come from maps, their code_rate sets must
    # align entry-for-entry (reference: src/config.cpp:196-235).
    if algorithm.is_adaptive and not (primary.use_range or secondary.use_range):
        names = {
            DecodingAlgorithm.ANMSA: ("ANMSA", "alpha", "nu"),
            DecodingAlgorithm.AOMSA: ("AOMSA", "beta", "sigma"),
        }[algorithm]
        if len(primary.maps) != len(secondary.maps):
            raise ConfigError(
                f"{names[0]}: The sizes of code_rate_{names[1]}_maps and "
                f"code_rate_{names[2]}_maps vectors must match! "
                f"({len(primary.maps)} vs {len(secondary.maps)})"
            )
        for pm, sm in zip(primary.maps, secondary.maps):
            if abs(pm.code_rate - sm.code_rate) > EPSILON:
                raise ConfigError(
                    f"{names[0]}: Mismatch of code_rate in {names[1]} and "
                    f"{names[2]} maps: {pm.code_rate:.3f} vs {sm.code_rate:.3f}\n"
                    f"All code_rate values, from code_rate_{names[1]}_maps must "
                    f"also be in code_rate_{names[2]}_maps!"
                )

    max_iterations = int(config["decoding_algorithm_max_iterations"])
    if max_iterations < 1:
        raise ConfigError(
            "Minimum number of decoding algorithm iterations must be >= 1!"
        )

    matrix_format_idx = int(config["matrix_format"])
    if matrix_format_idx > MatrixFormat.QC:
        raise ConfigError(
            "Only five options are available: \n0 - uncompressed;\n1 - sparse "
            "alist;\n2 - sparse_1;\n3 - sparse_2;\n4 - quasi-cyclic (TPU "
            "extension)."
        )
    matrix_format = MatrixFormat(matrix_format_idx)

    trace_qkd_ldpc = bool(config["trace_qkd_ldpc"])
    trace_decoding_alg = bool(config["trace_decoding_algorithm"])
    trace_decoding_alg_llr = bool(config["trace_decoding_algorithm_llr"])
    enable_threshold = bool(config["enable_decoding_algorithm_msg_llr_threshold"])
    msg_llr_threshold = 0.0
    if enable_threshold:
        msg_llr_threshold = float(config["decoding_algorithm_msg_llr_threshold"])
        if msg_llr_threshold <= 0.0:
            raise ConfigError("Sum-product message LLR threshold must be > 0!")

    r_qber_ranges = []
    for r in config["code_rate_QBER_ranges"]:
        q = r["QBER"]
        r_qber_ranges.append(
            RQBERRange(
                code_rate=float(r["code_rate"]),
                qber_begin=float(q["begin"]),
                qber_end=float(q["end"]),
                qber_step=float(q["step"]),
            )
        )
    if not r_qber_ranges:
        raise ConfigError("Array with code rate(R) and QBER ranges is empty!")
    for r in r_qber_ranges:
        if r.code_rate <= 0.0 or r.code_rate >= 1.0:
            raise ConfigError("Code rate(R) must be: 0 < R < 1!")
        if (
            r.qber_begin <= 0.0
            or r.qber_begin >= 1.0
            or r.qber_end <= 0.0
            or r.qber_end >= 1.0
            or r.qber_begin > r.qber_end
        ):
            raise ConfigError(
                "Invalid QBER begin or end parameters. QBER must be: "
                "0 < QBER < 1, and begin cannot be larger than end!"
            )
        if r.qber_step <= 0.0:
            raise ConfigError("QBER step must be > 0!")
        if r.qber_begin != r.qber_end:
            if r.qber_step - EPSILON > r.qber_end - r.qber_begin:
                raise ConfigError("QBER step is too large.")
    r_qber_ranges.sort(key=lambda r: r.code_rate)

    enable_code_rate_adaptation = bool(config["enable_code_rate_adaptation"])
    enable_untainted_puncturing = False
    use_adaptation_parameters_ranges = False
    r_adapt_params_ranges = []
    r_qber_adapt_params_maps = []
    if enable_code_rate_adaptation:
        ra = config["code_rate_adaptation_parameters"]
        enable_untainted_puncturing = bool(ra["enable_untainted_puncturing"])
        use_adaptation_parameters_ranges = bool(ra["use_adaptation_parameters_ranges"])
        if use_adaptation_parameters_ranges:
            for r in ra["code_rate_adaptation_parameters_ranges"]:
                d = r["delta"]
                e = r["efficiency"]
                r_adapt_params_ranges.append(
                    RAdaptationParametersRange(
                        code_rate=float(r["code_rate"]),
                        delta_begin=float(d["begin"]),
                        delta_end=float(d["end"]),
                        delta_step=float(d["step"]),
                        efficiency_begin=float(e["begin"]),
                        efficiency_end=float(e["end"]),
                        efficiency_step=float(e["step"]),
                    )
                )
            if not r_adapt_params_ranges:
                raise ConfigError(
                    "Array with code rate(R) and adaptation parameters ranges "
                    "is empty!"
                )
            for r in r_adapt_params_ranges:
                if r.code_rate <= 0.0 or r.code_rate >= 1.0:
                    raise ConfigError("Code rate(R) must be: 0 < R < 1!")
                if (
                    r.delta_begin <= 0.0
                    or r.delta_begin >= 1.0
                    or r.delta_end <= 0.0
                    or r.delta_end >= 1.0
                    or r.delta_begin > r.delta_end
                ):
                    raise ConfigError(
                        "Invalid delta begin or end parameters. Delta must be: "
                        "0 < delta < 1, and begin cannot be larger than end!"
                    )
                if r.delta_step <= 0.0:
                    raise ConfigError("Delta step must be > 0!")
                if r.delta_begin != r.delta_end:
                    if r.delta_step - EPSILON > r.delta_end - r.delta_begin:
                        raise ConfigError("Delta step is too large.")
                if (
                    r.efficiency_begin < 1.0
                    or r.efficiency_end < 1.0
                    or r.efficiency_begin > r.efficiency_end
                ):
                    raise ConfigError(
                        "Invalid efficiency begin or end parameters. "
                        "Efficiency(f_EC) must be: f_EC >= 1, and begin cannot "
                        "be larger than end!"
                    )
                if r.efficiency_step <= 0.0:
                    raise ConfigError("Efficiency step must be > 0!")
                if r.efficiency_begin != r.efficiency_end:
                    if (
                        r.efficiency_step - EPSILON
                        > r.efficiency_end - r.efficiency_begin
                    ):
                        raise ConfigError("Efficiency step is too large.")
            r_adapt_params_ranges.sort(key=lambda r: r.code_rate)
        else:
            for m in ra["code_rate_QBER_adaptation_parameters_maps"]:
                r_qber_adapt_params_maps.append(
                    RQBERAdaptationParametersMap(
                        code_rate=float(m["code_rate"]),
                        params=QBERAdaptationParameters(
                            qber=float(m["QBER"]),
                            delta=float(m["delta"]),
                            efficiency=float(m["efficiency"]),
                        ),
                    )
                )
            if not r_qber_adapt_params_maps:
                raise ConfigError(
                    "Array with code rate(R), QBER and adaptation parameters "
                    "maps is empty!"
                )
            for m in r_qber_adapt_params_maps:
                if m.code_rate <= 0.0 or m.code_rate >= 1.0:
                    raise ConfigError("Code rate(R) must be: 0 < R < 1!")
                if m.params.qber <= 0.0 or m.params.qber >= 1.0:
                    raise ConfigError(
                        "Invalid QBER parameter. QBER must be: 0 < QBER < 1!"
                    )
                if m.params.delta <= 0.0 or m.params.delta >= 1.0:
                    raise ConfigError(
                        "Invalid delta parameter. Delta must be: 0 < delta < 1!"
                    )
                if m.params.efficiency < 1.0:
                    raise ConfigError(
                        "Invalid efficiency parameter. Efficiency(f_EC) must "
                        "be: f_EC >= 1!"
                    )
            # Stable sort preserves per-rate ordering of multiple entries,
            # matching std::sort-by-code_rate in the reference for the
            # grouped-map lookups (src/config.cpp:389-394).
            r_qber_adapt_params_maps.sort(key=lambda m: m.code_rate)

    tpu = config.get("tpu", {})
    batch_size = int(tpu.get("batch_size", 0))
    dtype = str(tpu.get("dtype", "float32"))
    if dtype not in ("float32", "float64", "bfloat16"):
        raise ConfigError("tpu.dtype must be one of float32|float64|bfloat16")
    use_pallas = bool(tpu.get("use_pallas", False))
    phase1_iterations = int(tpu.get("phase1_iterations", -1))
    schedule = str(tpu.get("schedule", "flooding"))
    if schedule not in ("flooding", "layered"):
        raise ConfigError("tpu.schedule must be flooding|layered")
    force_engine = str(tpu.get("force_engine", ""))
    if force_engine not in ("", "qc", "qc_stream", "generic", "stream",
                            "xla"):
        raise ConfigError(
            "tpu.force_engine must be one of "
            "qc|qc_stream|generic|stream|xla (or absent)"
        )

    return Config(
        threads_number=threads_number,
        trials_number=trials_number,
        simulation_seed=simulation_seed,
        enable_privacy_maintenance=enable_privacy_maintenance,
        enable_throughput_measurement=enable_throughput_measurement,
        consider_rtt=consider_rtt,
        rtt_ms=rtt_ms,
        decoding_algorithm=algorithm,
        primary=primary,
        secondary=secondary,
        decoding_alg_max_iterations=max_iterations,
        matrix_format=matrix_format,
        trace_qkd_ldpc=trace_qkd_ldpc,
        trace_decoding_alg=trace_decoding_alg,
        trace_decoding_alg_llr=trace_decoding_alg_llr,
        enable_msg_llr_threshold=enable_threshold,
        msg_llr_threshold=msg_llr_threshold,
        r_qber_ranges=tuple(r_qber_ranges),
        enable_code_rate_adaptation=enable_code_rate_adaptation,
        enable_untainted_puncturing=enable_untainted_puncturing,
        use_adaptation_parameters_ranges=use_adaptation_parameters_ranges,
        r_adapt_params_ranges=tuple(r_adapt_params_ranges),
        r_qber_adapt_params_maps=tuple(r_qber_adapt_params_maps),
        batch_size=batch_size,
        dtype=dtype,
        use_pallas=use_pallas,
        phase1_iterations=phase1_iterations,
        schedule=schedule,
        force_engine=force_engine,
    )


def format_config_info(cfg: Config, cfg_name: str, cfg_number: int) -> str:
    """Console banner for one run (reference: src/config.cpp:52-86)."""
    throughput = (
        f"Enabled, RTT = {cfg.rtt_ms:.3f} ms"
        if cfg.enable_throughput_measurement
        else "Disabled"
    )
    rate_adapt = "Disabled"
    if cfg.enable_code_rate_adaptation:
        rate_adapt = "Enabled" + (
            " (ranges)" if cfg.use_adaptation_parameters_ranges else " (maps)"
        )
    lines = [
        f"------------------------- CONFIG #{cfg_number} INFO --------------------------",
        f"Config name: {cfg_name}",
        f"Threads number: {cfg.threads_number}",
        f"Trials number: {cfg.trials_number}",
        f"Simulation seed: {cfg.simulation_seed}",
        "Privacy maintenance: "
        + ("Enabled" if cfg.enable_privacy_maintenance else "Disabled"),
        f"Throughput measurement: {throughput}",
        f"Decoding algorithm: {cfg.decoding_algorithm.display_name}",
        f"Decoding algorithm maximum iterations: {cfg.decoding_alg_max_iterations}",
        f"Parity-check matrix format: {cfg.matrix_format.display_name}",
        f"Code rate adaptation: {rate_adapt}",
        "Untainted puncturing: "
        + ("Enabled" if cfg.enable_untainted_puncturing else "Disabled"),
        "--------------------------------------------------------------------",
    ]
    return "\n".join(lines)
