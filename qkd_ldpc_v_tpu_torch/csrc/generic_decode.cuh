// Per-edge steps of the streamed generic kernel (csrc/generic_stream.cu),
// which decodes an arbitrary sparse parity-check matrix from raw keys (trial
// mode) or from LLRs and a syndrome (decode mode), for the min-sum family
// NMSA/OMSA/ANMSA/AOMSA and the SPA pair (SPA, SPA-lin-approx: the check
// update of spa.cuh) on the flooding schedule, a group of frames per block in
// a batch-minor layout of its own. The fused generic kernel
// (csrc/fused_generic.cu) keeps a layout and steps of its own and does not
// include this header; Params' other modes (frame, mc) are its modes'
// numbers, kept so that this header's layout stays as it was.
//
// The helpers: the channel LLR (input_llr, llr_of_bit), the two-minimum
// chain (two_min, last_min2), the row sign (row_sign_of), the min-sum value
// (minsum_value), the clamp (clamp_msg), the decision-syndrome mismatch
// (mismatch) and Alice's syndrome (alice_syndrome). They keep the plain
// decoder's f32 association (llr-first totals in slot order; the min-sum
// value as f * row_sign * excl * eabs or row_sign * excl * max(eabs - f,
// 0)).
//
// Edges are addressed directly through index tables built on the host from
// models/layout.py::EdgeLayout, in its internal (degree-sorted) node order
// (ops/fused_generic.py::launch_tables):
//   cptr[M+1]   check-major edge offsets of each internal check
//   cbit[E]     internal bit of each check-major edge
//   bptr[N+1]   bit-major edge offsets of each internal bit
//   bedge[E]    check-major position of each bit-major edge (to_bit_major)
//   bit_ext[N]  external index of each internal bit (bit_order)
//   chk_ext[M]  external index of each internal check (check_order)
//
// Exactness: each bit total is the channel LLR first, then its check->bit
// messages in slot order (ascending check index), added one by one; the
// min-sum value is +-1 sign logic and one multiply or one subtraction;
// sources are built with -fmad=false, no fast math and no flush-to-zero.
// Rate-adapted LLRs carry the float32 maximum on shortened bits, so sums
// can overflow to inf, and inf - inf gives NaN. With the NONFINITE flag of
// the helpers the kernel follows the plain decoder (and JAX's XLA decoder)
// there: min and max propagate NaN as torch.minimum / torch.maximum do (PTX
// min.NaN / max.NaN), and where every |message| of a check is inf the
// second minimum is inf too (the plain decoder's tie rule; the chain's
// second minimum starts at the float32 maximum and would stay there).
//
// The code has internal linkage in each source that includes it.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "spa.cuh"

namespace {

constexpr int kMaxThreads = 1024;

// What a launch decodes: raw keys (trial), LLRs and a syndrome (decode),
// Alice's rate-adapted frame and its LLRs (frame; fused kernel only), or keys
// it draws itself (mc; fused kernel only).
enum Mode { kDecode = 0, kTrial = 1, kFrame = 2, kMc = 3 };

struct Params {
  const int8_t* alice;    // trial, frame: [B, N] 0/1, external order
  const int8_t* bob;      // trial: [B, N] 0/1
  const float* llr_in;    // decode, frame: [B, N]
  const int8_t* syn_in;   // decode: [B, M] 0/1
  const int32_t* table;   // cptr, cbit, bptr, bedge, bit_ext, chk_ext
  float* scratch;         // the caller's global scratch (per-block slices)
  int n, m, e, batch, max_iter, use_threshold, mode;
  float log_p, primary, secondary, threshold;
  int8_t* dec_out;        // decode: [B, N]
  int8_t* conv;           // [B]
  int8_t* keys;           // trial, frame, mc: [B]
  int32_t* iters;         // [B]
};

struct Tables {
  const int* cptr;
  const int* cbit;
  const int* bptr;
  const int* bedge;
  const int* bit_ext;
  const int* chk_ext;
};

__device__ __forceinline__ Tables tables_of(const Params& p) {
  Tables t;
  t.cptr = p.table;
  t.cbit = t.cptr + p.m + 1;
  t.bptr = t.cbit + p.e;
  t.bedge = t.bptr + p.n + 1;
  t.bit_ext = t.bedge + p.e;
  t.chk_ext = t.bit_ext + p.n;
  return t;
}

// f32 min and max; with NONFINITE they return NaN where either operand is
// NaN, else they drop a NaN operand as fminf / fmaxf do.
template <bool NONFINITE>
__device__ __forceinline__ float min_of(float a, float b) {
  if (!NONFINITE) return fminf(a, b);
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <bool NONFINITE>
__device__ __forceinline__ float max_of(float a, float b) {
  if (!NONFINITE) return fmaxf(a, b);
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <bool NONFINITE = false>
__device__ __forceinline__ float clamp_msg(float x, const Params& p) {
  if (!p.use_threshold) return x;
  return min_of<NONFINITE>(max_of<NONFINITE>(x, -p.threshold), p.threshold);
}

// Where internal check c is unsatisfied by the decisions: 1 or 0 for planes
// of one frame (int8_t), a mask of frames for bit-packed planes (bit f =
// frame f).
template <typename T>
__device__ __forceinline__ int mismatch(int c, const int* cptr, const int* cbit,
                                        const T* dec, const T* syn) {
  int par = syn[c];
  for (int k = cptr[c]; k < cptr[c + 1]; ++k) par ^= dec[cbit[k]];
  return par;
}

// One step of the two-minimum chain over a check's |messages|, in slot
// order: a tie at the minimum makes min2 == min1.
template <bool NONFINITE = false>
__device__ __forceinline__ void two_min(float av, bool first, float& min1,
                                        float& min2) {
  if (first) {
    min1 = av;
  } else {
    min2 = min_of<NONFINITE>(min2, max_of<NONFINITE>(min1, av));
    min1 = min_of<NONFINITE>(min1, av);
  }
}

// The second minimum of a check of `degree` edges once the chain is done:
// with NONFINITE, inf where every |message| is inf (degree >= 2), as the
// plain decoder's tie at the minimum gives.
template <bool NONFINITE>
__device__ __forceinline__ float last_min2(int degree, float min1,
                                           float min2) {
  return (NONFINITE && degree >= 2 && isinf(min1)) ? min1 : min2;
}

// The sign of a check's product: its syndrome bit times the parity of its
// negative messages.
__device__ __forceinline__ float row_sign_of(bool syn, int neg) {
  return (syn ? -1.f : 1.f) * ((neg & 1) == 0 ? 1.f : -1.f);
}

template <bool OFFSET, bool NONFINITE = false>
__device__ __forceinline__ float minsum_value(float mm, float min1, float min2,
                                              float row_sign, float f) {
  const float excl = mm > 0.f ? 1.f : -1.f;
  const float eabs = (fabsf(mm) == min1) ? min2 : min1;
  if (OFFSET) return row_sign * excl * max_of<NONFINITE>(eabs - f, 0.f);
  return f * row_sign * excl * eabs;
}

// The channel LLR in trial mode, from whether Bob's bit is 1.
__device__ __forceinline__ float llr_of_bit(const Params& p, bool one) {
  return one ? -p.log_p : p.log_p;
}

// The channel LLR of internal bit i of the frame whose keys or LLRs start
// at `row`, formed from the inputs: +-log_p from Bob's bit in trial mode,
// the caller's LLR in decode and frame mode.
__device__ __forceinline__ float input_llr(const Params& p, const Tables& t,
                                           size_t row, int i) {
  const int j = t.bit_ext[i];
  if (p.mode == kTrial) return llr_of_bit(p, p.bob[row + j] == 1);
  return p.llr_in[row + j];
}

// Alice's syndrome bit of check c: the parity of Alice's bits on the check
// in trial and frame mode, the caller's syndrome in decode mode.
__device__ __forceinline__ int8_t alice_syndrome(int c, const Params& p,
                                                 const Tables& t, int frame,
                                                 int parity) {
  if (p.mode != kDecode) return (int8_t)parity;
  return (int8_t)(p.syn_in[(size_t)frame * p.m + t.chk_ext[c]] == 1);
}

}  // namespace
