// The SPA pair's check update (SPA and SPA-lin-approx), once for the four
// kernels of this package: csrc/fused_qc.cu, csrc/qc_stream.cu,
// csrc/fused_generic.cu and csrc/generic_stream.cu.
//
// It is the check-pass variant every TPU kernel computes for the pair
// (qkd_ldpc_v_tpu/ops/pallas_qc.py, pallas_qc_stream.py, pallas_generic.py
// and pallas_stream.py), flooding only. For a check with syndrome sign ss
// and bit->check messages m_i in slot order:
//   t_i = tanh(m_i * 0.5)                       (SPA-lin: tanh_lin)
//   prod = ss; prod = prod * t_i for each i     (sequential, from ss)
//   ratio_i = prod / t_i
//   m_i' = 2 * atanh(guard(ratio_i))            (SPA-lin: 2 * atanh_lin,
//                                                no guard)
// and the caller clamps m_i'. The plain torch versions are
// ops/qc_decoder.py::decode_flooding and ops/decoders.py::make_decoder in
// float32, with ops/linapprox.py; the kernels are held to them bit for bit.
//
// What makes the bits equal: torch's float32 tanh and atanh on CUDA are the
// CUDA math library's tanhf and atanhf, which these steps call (the TPU
// kernels' log identity for atanh was a Mosaic workaround); the products,
// the quotient and the tables' multiply-adds are single IEEE operations, as
// torch's elementwise kernels make them, because every source is built
// with -fmad=false, IEEE division (no fast math) and no flush-to-zero, so
// that 0/0 (a zero message) reaches the guard as NaN. The table ladders
// are first-true-wins, as the plain where-chains folded from the last
// segment: a NaN input fails every bound and takes the last branch
// (tanh_lin: 1; atanh_lin: the last segment, NaN), and the sign is applied
// as x < 0 ? -r : r, never copysignf, which would also flip -0 and NaN.
// The guard tests NaN before fminf / fmaxf, which would drop it.
//
// spa_row is the row helper all four kernels call where their messages are
// addressable by slot; the streamed generic kernel's register run spells the
// same steps out over its unrolled array. spa.cu applies spa_term and
// spa_extrinsic to a tensor, so that the elementwise steps are tested alone
// against torch (chip_smoke.py, phase 2g).

#pragma once

#include <cmath>

namespace {

// The check update of a kernel instantiation (its CHECK template flag):
// min-sum (the min-sum family's own code), SPA or SPA-lin-approx.
constexpr int kMinSum = 0;
constexpr int kSpa = 1;
constexpr int kSpaLin = 2;

// ops/linapprox.py::tanh_lin_approx (reference :146-160).
__device__ __forceinline__ float tanh_lin(float x) {
  const float ax = fabsf(x);
  float r;
  if (ax < 0.5f) {
    r = 0.9242f * ax + 0.0f;
  } else if (ax < 0.9f) {
    r = 0.6355f * ax + 0.1444f;
  } else if (ax < 1.2f) {
    r = 0.3912f * ax + 0.3642f;
  } else if (ax < 1.75f) {
    r = 0.1958f * ax + 0.5986f;
  } else if (ax < 2.5f) {
    r = 0.0603f * ax + 0.8358f;
  } else if (ax < 3.5f) {
    r = 0.0115f * ax + 0.9577f;
  } else if (ax < 8.0f) {
    r = 0.0004f * ax + 0.9967f;
  } else {
    r = 1.0f;
  }
  return x < 0.f ? -r : r;
}

// ops/linapprox.py::atanh_lin_approx (reference :162-172); the last
// segment extrapolates.
__device__ __forceinline__ float atanh_lin(float x) {
  const float ax = fabsf(x);
  float r;
  if (ax < 0.7f) {
    r = 1.196f * ax + -0.0323f;
  } else if (ax < 0.9f) {
    r = 2.9187f * ax + -1.214f;
  } else if (ax < 0.999f) {
    r = 10.8717f * ax + -8.3717f;
  } else {
    r = 2510.9f * ax + -2505.9f;
  }
  return x < 0.f ? -r : r;
}

// ops/linapprox.py::guard_atanh_ratio in float32: NaN (0/0) becomes 0, and
// the ratio is clamped to the largest float below one in magnitude.
__device__ __forceinline__ float guard_ratio(float r) {
  if (isnan(r)) return 0.f;
  return fminf(fmaxf(r, -0x1.fffffep-1f), 0x1.fffffep-1f);
}

// The term of one bit->check message m: tanh(m * 0.5).
template <int CHECK>
__device__ __forceinline__ float spa_term(float m) {
  const float x = m * 0.5f;
  return CHECK == kSpa ? tanhf(x) : tanh_lin(x);
}

// The check->bit value of an exclusion ratio: 2 * atanh(ratio), guarded for
// SPA.
template <int CHECK>
__device__ __forceinline__ float spa_extrinsic(float ratio) {
  return 2.f * (CHECK == kSpa ? atanhf(guard_ratio(ratio)) : atanh_lin(ratio));
}

// One check's update. term(j) returns the term of slot j (spa_term of its
// message), and may park it where the message was; parked(j) returns it
// again; emit(j, v) takes slot j's unclamped check->bit value. Slots run in
// order 0 .. degree - 1 in both loops.
template <int CHECK, typename Term, typename Parked, typename Emit>
__device__ __forceinline__ void spa_row(int degree, bool syn, Term term,
                                        Parked parked, Emit emit) {
  float prod = syn ? -1.f : 1.f;
  for (int j = 0; j < degree; ++j) prod = prod * term(j);
  for (int j = 0; j < degree; ++j) emit(j, spa_extrinsic<CHECK>(prod / parked(j)));
}

}  // namespace
