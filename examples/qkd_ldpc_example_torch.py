"""Textbook walk-through on the PyTorch port: one fixed-rate reconciliation
round with tracing.

Mirrors the reference's library example (reference:
example/qkd_ldpc_example.cpp:1-41): Johnson, *Introducing Low-Density
Parity-Check Codes*, example 2.5 (p. 33) — a 6-bit key, the 4x6 parity-check
matrix, SPA decoding with an LLR threshold of 100, full tracing.

Run: ``python examples/qkd_ldpc_example_torch.py [--device cuda|cpu]``

Two decodes are shown: the reference-exact traced f64 oracle (the same
trajectory the C++ example prints), then the batched float64 torch decoder
on the same frame on ``--device`` (default ``cuda``, which raises without a
CUDA device), demonstrating they agree.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from qkd_ldpc_v_tpu_torch.config import Config, DecodingAlgorithm, RQBERRange
from qkd_ldpc_v_tpu_torch.models.hmatrix import from_dense
from qkd_ldpc_v_tpu_torch.models.layout import layout_for
from qkd_ldpc_v_tpu_torch.ops.channel import calculate_syndrome
from qkd_ldpc_v_tpu_torch.ops.decoders import get_decoder
from qkd_ldpc_v_tpu_torch.tracing import traced_protocol_round


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the batched decode runs (default: cuda)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (use "
                           "--device cpu)")
    device = torch.device(args.device)

    # The (N=6, K=2, M=4, R=0.34) matrix of the textbook example — the same
    # asset the reference ships as
    # sparse_matrices/matrices_uncompressed/(N=6,K=2,M=4,R=0.34).mtrx.
    dense = np.array(
        [
            [1, 1, 0, 1, 0, 0],
            [0, 1, 1, 0, 1, 0],
            [1, 0, 0, 0, 1, 1],
            [0, 0, 1, 1, 0, 1],
        ],
        dtype=np.int8,
    )
    matrix = from_dense(dense)

    cfg = Config(
        decoding_algorithm=DecodingAlgorithm.SPA,
        decoding_alg_max_iterations=100,
        enable_msg_llr_threshold=True,
        msg_llr_threshold=100.0,
        trace_qkd_ldpc=True,
        trace_decoding_alg=True,
        trace_decoding_alg_llr=True,
        r_qber_ranges=(RQBERRange(0.99, 0.2, 0.2, 0.1),),
    )

    alice = np.array([0, 0, 1, 0, 1, 1])
    bob = np.array([1, 0, 1, 0, 1, 1])  # one flipped bit
    qber = 0.2

    print("=== Reference-exact traced round (f64 oracle) ===")
    decision, ok, keys_match, iters = traced_protocol_round(
        matrix, alice, bob, qber, cfg
    )

    print(f"\n=== Batched float64 torch decoder on the same frame "
          f"({device.type}) ===")
    layout = layout_for(matrix)
    decode = get_decoder(
        layout, cfg.decoding_algorithm, cfg.decoding_alg_max_iterations,
        use_threshold=True, dtype=torch.float64,
    )
    log_p = float(np.log((1 - qber) / qber))
    llr = torch.tensor(np.where(bob == 1, -log_p, log_p)[None, :],
                       dtype=torch.float64, device=device)
    syndrome = calculate_syndrome(
        layout, torch.tensor(alice[None, :], dtype=torch.int8, device=device))
    res = decode(llr, syndrome, 1.0, 1.0, 100.0)
    device_decision = res.decision[0].cpu().numpy()
    device_iters = int(res.iterations[0])
    print(f"decision: {device_decision.tolist()}")
    print(f"iterations: {device_iters} (oracle: {iters})")
    assert np.array_equal(device_decision, decision), "device != oracle"
    assert device_iters == iters
    print("device decode matches the reference-exact trajectory.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
