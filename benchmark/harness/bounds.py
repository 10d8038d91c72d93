"""The least time an NVIDIA H100 (SXM) could take for a decode: frozen
copies of the bound arithmetic the port's smoke test used (``bound``,
``decode_bound``, ``mc_bound``, ``spa_bound`` and their constants), so a
kernel's roofline share reads the same whatever implements the kernel.

Peaks. Published (NVIDIA's H100 SXM data sheet, at the 700 W limit): HBM
3.35 TB/s; 67 TFLOP/s of float32 outside the tensor cores, which counts an
FMA as two operations, so 33.5 T simple operations/s. Derived (from the
data sheet's 132 SMs and 1.98 GHz boost clock, not a published figure):
the INT32 lanes, 64 per SM, 16.7 T operations/s; the SFU (MUFU), 16
operations per clock and SM, 4.18 T/s.

Work is the algorithm's, counted from the inputs, not the kernel's loops.
Operations per edge and iteration that normalized min-sum needs: the
bit->check message T - E 1; the two-minimum update on |m| 3 (max, min,
min; the magnitude is an operand modifier); the sign parity 1 (xor of m's
sign bit); the excluded minimum 2 (compare |m| with min1, select); the
scale 1; the output sign 2 (row sign xor m's sign bit, applied to the
magnitude); the total 1 (flooding: accumulate) or 2 (layered:
t + (val - E)); the decision's parity 2 (total <= 0, xor). The mc modes
also draw the keys: 32 integer operations per bit, 30 for the generator
(a Philox4x32-10 call is 60 operations and gives the words of four
positions; a bit takes two streams: 2 * 60 / 4) and 2 for the selection;
they share the f32 issue slots and, alone, need the INT32 lanes. The SPA
pair's operations per edge and iteration (from the machine code along the
path a message takes): SPA 59 issued like f32 and 4 on the SFU, SPA-lin 23
and 1. Bytes: each input byte read once and each output byte written once.

Every function returns ``(bound_ms, bound_by)``, ``bound_by`` being
``"bytes"`` or ``"operations"``, for ``frames`` frames whose iteration
counts sum to ``iterations``.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
INT32_OPS_PER_S = 16.7e12  # derived
MUFU_OPS_PER_S = 4.18e12  # derived
OPS_PER_EDGE = {"flooding": 13, "layered": 14}
MC_INT_OPS_PER_BIT = 32
SPA_OPS_PER_EDGE = {"SPA": {"f32": 59, "mufu": 4},
                    "SPA_APPROX": {"f32": 23, "mufu": 1}}


def _pick(byte_ms, op_ms):
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def bound(frames, n, edges, iterations, schedule, bytes_per_bit=2):
    """Trial mode reads two int8 keys per bit, frame mode Alice's int8
    frame and a float32 LLR (``bytes_per_bit`` 5); both write 6 bytes of
    statistics per frame."""
    byte_ms = (bytes_per_bit * frames * n + 6 * frames) / HBM_BYTES_PER_S * 1e3
    op_ms = OPS_PER_EDGE[schedule] * edges * iterations / F32_OPS_PER_S * 1e3
    return _pick(byte_ms, op_ms)


def decode_bound(frames, n, m, edges, iterations, schedule):
    """Decode mode: float32 LLRs and the syndrome in, decisions and 5
    bytes of statistics out per frame."""
    byte_ms = frames * (5 * n + m + 5) / HBM_BYTES_PER_S * 1e3
    op_ms = OPS_PER_EDGE[schedule] * edges * iterations / F32_OPS_PER_S * 1e3
    return _pick(byte_ms, op_ms)


def mc_bound(frames, n, edges, iterations, schedule):
    """mc mode: no key bytes in, 6 bytes of statistics out per frame; the
    decode's f32 operations plus the generator's and the selection's
    integer operations, in the same issue slots and, alone, on the INT32
    lanes."""
    byte_ms = 6 * frames / HBM_BYTES_PER_S * 1e3
    f32_ops = OPS_PER_EDGE[schedule] * edges * iterations
    int_ops = MC_INT_OPS_PER_BIT * frames * n
    op_ms = max((f32_ops + int_ops) / F32_OPS_PER_S,
                int_ops / INT32_OPS_PER_S) * 1e3
    return _pick(byte_ms, op_ms)


def spa_bound(mode, frames, n, m, edges, iterations, alg):
    """The SPA pair in ``mode`` (trial, mc, decode, frame): bytes as the
    modes above, f32 (and mc integer) operations over the issue rate, the
    integer ones alone over the INT32 lanes, MUFU ones over the SFU."""
    per_frame = {"trial": 2 * n + 6, "mc": 6,
                 "decode": 5 * n + m + 5}.get(mode, 5 * n + 6)
    int_ops = MC_INT_OPS_PER_BIT * frames * n if mode == "mc" else 0
    byte_ms = per_frame * frames / HBM_BYTES_PER_S * 1e3
    f32_ops, mufu_ops = (SPA_OPS_PER_EDGE[alg][k] * edges * iterations
                         for k in ("f32", "mufu"))
    op_ms = max((f32_ops + int_ops) / F32_OPS_PER_S,
                int_ops / INT32_OPS_PER_S,
                mufu_ops / MUFU_OPS_PER_S) * 1e3
    return _pick(byte_ms, op_ms)
