"""Library rounds: a closed loop of one client calling
``protocol.qkd_ldpc_rate_adapt`` on ``frames`` frames a round, the next
round sent when the last one's flags and iterations are on the host.

The specs are the rate-adaptation points that ``simulation.
prepare_sim_inputs`` makes from the workload's ``program_config`` (the
port's config schema) on the cell's code: one spec per point, built in
set-up. Round ``r`` takes spec ``order[r]``, each run of ``len(specs)``
rounds being a permutation drawn from the seed, so every seed serves every
spec equally often; its keys are block ``r mod pool`` of a pool made on the
card from the seed: Alice's bits, Bob's (Alice's with independent errors at
the link's QBER, the QBER of the code's bracket) and Alice's punctured
bits.

Workload keys: ``frames``, ``pool``, ``specs`` (how many points the
config gives the code), ``config_seed``
(the point positions' generator, fixed so that every seed runs the same
specs), ``program_config``, ``trace_rounds`` and ``compare`` (``rounds``:
how many of the window's rounds the reference runs again, drawn from the
seed; ``limits``).
"""

from __future__ import annotations

import gc
import json
import tempfile
import time
from pathlib import Path
from typing import List

import numpy as np

from benchmark.harness import trace
from benchmark.reference import adapt, compare
from benchmark.reference.alist import read_alist
from benchmark.reference.decoder import Graph


def make_pool(torch, seed: int, blocks: int, frames: int, n: int, qber: float,
              device):
    """(Alice's bits, the error pattern, Alice's punctured bits), each
    [blocks, frames, n] int8, made on the device from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    shape = (blocks, frames, n)
    alice = torch.randint(0, 2, shape, generator=gen, dtype=torch.int8,
                          device=device)
    errors = (torch.rand(shape, generator=gen, device=device) < qber).to(torch.int8)
    punct = torch.randint(0, 2, shape, generator=gen, dtype=torch.int8,
                          device=device)
    return alice, errors, punct


def round_inputs(pool, block: int, payload: int, punctured: int):
    """(Alice's payload key, Bob's, Alice's punctured bits) of one round."""
    alice, errors, punct = pool
    a = alice[block, :, :payload].contiguous()
    return a, a ^ errors[block, :, :payload], punct[block, :, :punctured].contiguous()


def schedule(seed: int, specs: int, rounds: int) -> List[int]:
    rng = np.random.default_rng([seed, 2])
    order: List[int] = []
    while len(order) < rounds:
        order.extend(int(i) for i in rng.permutation(specs))
    return order[:rounds]


class Cell:
    kind = "rounds"

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.w = ctx.workload
        self.seed = ctx.seed
        self.round = 0
        self.sample: list = []
        self.pick = np.random.default_rng([ctx.seed, 3])
        self.round_ms: List[float] = []
        self.traced_rounds: List[dict] = []
        self.trace = None

    # -- set-up ---------------------------------------------------------
    def _program_config(self, work: Path) -> Path:
        data = dict(self.w["program_config"])
        data["simulation_seed"] = self.w["config_seed"]
        data["use_config_simulation_seed"] = True
        data["trials_number"] = self.w["frames"]
        data["decoding_algorithm_max_iterations"] = self.ctx.config["max_iterations"]
        data["matrix_format"] = 1  # alist
        path = work / "run.json"
        path.write_text(json.dumps(data))
        return path

    def setup(self) -> None:
        torch = self.ctx.torch
        from qkd_ldpc_v_tpu_torch import protocol
        from qkd_ldpc_v_tpu_torch.config import parse_config_data
        from qkd_ldpc_v_tpu_torch.simulation import prepare_sim_inputs

        self.torch = torch
        self.protocol = protocol
        with tempfile.TemporaryDirectory() as tmp:
            cfg = parse_config_data(self._program_config(Path(tmp)))
        matrix_path = self.ctx.path(self.ctx.config["matrix"])
        sim_in = prepare_sim_inputs([matrix_path], cfg)[0]
        self.specs, self.factors = [], []
        for comb in sim_in.combinations:
            self.specs.append(protocol.make_protocol_spec(
                sim_in.matrix, cfg.decoding_algorithm,
                cfg.decoding_alg_max_iterations, cfg.enable_msg_llr_threshold,
                cfg.enable_privacy_maintenance, params=comb.matrix_params))
            self.factors.append((comb.scaling_factors.primary,
                                 comb.scaling_factors.secondary,
                                 cfg.msg_llr_threshold))
        if len(self.specs) != self.w["specs"]:
            raise RuntimeError(f"{len(self.specs)} rate-adaptation points, "
                               f"the cell states {self.w['specs']}")
        n = sim_in.matrix.num_bit_nodes
        self.qber = decoding(sim_in.matrix.code_rate, self.w)[3]
        self.pool = make_pool(torch, self.seed, self.w["pool"],
                              self.w["frames"], n, self.qber, self.ctx.device)
        sizes = [(spec.num_key_bits, len(spec.punctured_positions))
                 for spec in self.specs]
        # Every round's inputs, made before the window.
        self.inputs = [[round_inputs(self.pool, b, *size)
                        for b in range(self.w["pool"])] for size in sizes]
        for s in range(len(self.specs)):
            self._round(s, 0)
        self.ctx.synchronize()

    # -- the window -----------------------------------------------------
    def _round(self, s: int, block: int):
        alice, bob, punct = self.inputs[s][block]
        primary, secondary, threshold = self.factors[s]
        res = self.protocol.qkd_ldpc_rate_adapt(
            self.specs[s], alice, bob, self.qber, primary=primary,
            secondary=secondary, threshold=threshold, alice_punct=punct)
        flags = (res.syndromes_match.cpu(), res.keys_match.cpu(),
                 res.iterations.cpu())
        return res, flags

    def _rounds(self, stop, log_ms, traced=None) -> int:
        done = 0
        order = schedule(self.seed + self.round, len(self.specs), 1 << 16)
        while True:
            s = order[done]
            block = self.round % self.w["pool"]
            t0 = time.perf_counter()
            with self.torch.profiler.record_function("bench.round"):
                res, flags = self._round(s, block)
            log_ms.append((time.perf_counter() - t0) * 1e3)
            if traced is not None:
                traced.append({"frames": int(flags[2].numel()),
                               "iterations": int(flags[2].to(self.torch.int64).sum())})
            self._keep(s, block, res)
            self.round += 1
            done += 1
            if stop(done):
                return done

    def _keep(self, s, block, res) -> None:
        """Reservoir sample of the rounds, drawn from the seed."""
        k = self.w["compare"]["rounds"]
        entry = (s, block, res)
        if len(self.sample) < k:
            self.sample.append(entry)
        else:
            j = int(self.pick.integers(0, self.round + 1))
            if j < k:
                self.sample[j] = entry

    def run_window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        self.attempted = self._rounds(
            lambda _: time.perf_counter() - t0 >= seconds, self.round_ms)
        return {"round_ms_p95": float(np.percentile(self.round_ms, 95))}

    def run_traced(self) -> None:
        count = self.w["trace_rounds"]
        with trace.traced() as holder:
            with self.torch.profiler.record_function(trace.WINDOW):
                self._rounds(lambda done: done >= count, [],
                             self.traced_rounds)
                self.ctx.synchronize()
        self.trace = holder[0]

    def release(self) -> None:
        del self.specs, self.protocol, self.inputs
        gc.collect()
        self.ctx.empty_cache()

    # -- correctness ----------------------------------------------------
    def compare(self) -> dict:
        w, c = self.w, self.ctx.config
        code = read_alist(self.ctx.path(c["matrix"]))
        graph = Graph(code, self.ctx.device)
        pts = reference_points(code, self.ctx.path(c["untainted"]), w)
        algorithm, primary, secondary, qber = decoding(1.0 - code.m / code.n, w)
        frames = wrong = keys_wrong = 0
        for s, block, res in self.sample:
            point = pts[s]
            payload = len(point.payload(code.n))
            alice, bob, punct = round_inputs(self.pool, block, payload,
                                             len(point.punctured))
            want, alice_kept, bob_kept = compare.round_reference(
                graph, point, alice, bob, punct, qber, algorithm, primary,
                secondary, c["max_iterations"])
            got = compare.Outcome(res.syndromes_match.cpu().numpy(),
                                  res.keys_match.cpu().numpy(),
                                  res.iterations.cpu().numpy())
            frames += len(want.iterations)
            wrong += compare.mismatched(got, want)
            keys_wrong += int((compare.key_rows_differ(res.alice_out, alice_kept)
                               | compare.key_rows_differ(res.bob_out, bob_kept)).sum())
        # The positions both sides puncture come from the .untp beside
        # the matrix: held to the untainted greedy on the code itself.
        listed = adapt.read_untainted(self.ctx.path(c["untainted"]))
        return {"frame_mismatch": wrong / max(frames, 1),
                "key_mismatch": keys_wrong / max(frames, 1),
                "untainted_faults": adapt.untainted_faults(code, listed)}

    # -- per-layer readings ---------------------------------------------
    def layer(self) -> dict:
        c = self.ctx.config
        return {"kind": self.kind, "trace": self.trace,
                "chunks": self.traced_rounds, "round_ms": self.round_ms,
                "n": c["num_bit_nodes"], "m": c["num_check_nodes"],
                "edges": c["edges"], "schedule": c["schedule"]}


def bracket(code_rate: float, entries, key="code_rate"):
    """The first entry (ascending code rate) whose rate is at least the
    code's, the upstream's lookup."""
    for e in sorted(entries, key=lambda e: e[key]):
        if code_rate <= e[key]:
            return e
    raise ValueError(f"no bracket holds code rate {code_rate}")


ALGORITHMS = {2: "NMSA", 3: "OMSA", 4: "ANMSA", 5: "AOMSA"}
FACTORS = {"NMSA": ("min_sum_normalized_parameters", "alpha", None),
           "OMSA": ("min_sum_offset_parameters", "beta", None),
           "ANMSA": ("adaptive_min_sum_normalized_parameters", "alpha", "nu"),
           "AOMSA": ("adaptive_min_sum_offset_parameters", "beta", "sigma")}


def decoding(code_rate: float, w) -> tuple:
    """(algorithm, primary, secondary, the link's QBER) of the cell's
    bracket, read from the program config's maps (factor maps, not
    ranges)."""
    pc = w["program_config"]
    algorithm = ALGORITHMS[pc["decoding_algorithm"]]
    node, first, second = FACTORS[algorithm]
    maps = pc[node]
    primary = bracket(code_rate, maps[f"code_rate_{first}_maps"])[first]
    secondary = (bracket(code_rate, maps[f"code_rate_{second}_maps"])[second]
                 if second else 1.0)
    qr = bracket(code_rate, pc["code_rate_QBER_ranges"])["QBER"]
    if qr["begin"] != qr["end"]:
        raise ValueError("a rounds cell runs one QBER")
    return algorithm, primary, secondary, qr["begin"]


def reference_points(code, untainted_path, w):
    """The rate-adaptation points of the cell's bracket, worked out again
    from the program config's ranges."""
    pc = w["program_config"]
    r0 = 1.0 - code.m / code.n
    qr = bracket(r0, pc["code_rate_QBER_ranges"])["QBER"]
    ar = bracket(r0, pc["code_rate_adaptation_parameters"]
                 ["code_rate_adaptation_parameters_ranges"])
    return adapt.points(
        code, adapt.read_untainted(untainted_path), w["config_seed"],
        adapt.expand(qr["begin"], qr["end"], qr["step"]),
        adapt.expand(*(ar["delta"][k] for k in ("begin", "end", "step"))),
        adapt.expand(*(ar["efficiency"][k] for k in ("begin", "end", "step"))))
