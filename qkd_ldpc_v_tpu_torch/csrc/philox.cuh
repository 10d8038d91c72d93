// The Monte-Carlo (mc) channel inside a kernel: the Philox4x32-10 generator,
// the error sort keys, and a block-wide exact selection of the k smallest
// keys. Included by the three kernels with an mc mode (csrc/fused_qc.cu,
// csrc/qc_stream.cu and csrc/fused_generic.cu).
//
// Replaces the TPU's hardware PRNG (pltpu.prng_seed / prng_random_bits) and
// the 32-pass bitwise k-th-smallest search of the JAX mc kernels
// (qkd_ldpc_v_tpu/ops/pallas_qc.py:305-349, pallas_qc_stream.py:292-350,
// pallas_generic.py:475-526). No GPU generator reproduces the TPU's bits, so
// the port's own generator is held bit for bit to its plain mirror,
// qkd_ldpc_v_tpu_torch/ops/philox.py, whose docstring fixes the stream
// layout: key = (seed low word, seed high word), counter = (p >> 2, frame,
// stream, 0) for external bit position p, value = word p & 3; stream 0 is
// Alice's bits (word & 1), stream 1 the error sort keys. Written by hand, not
// with curand, whose counter layout is not this one.
//
// Sort keys: (word >> idx_bits << idx_bits) | p with idx_bits =
// max(1, bit length of N - 1), so every key is distinct and the count of
// keys <= the k-th smallest is exactly k (the JAX rule, kept at N=102400
// where it leaves 15 random bits).
//
// Selection (kth_smallest): a radix select on the keys' bytes, high byte
// first. Each level counts the keys that share the prefix found so far in a
// 256-bin shared histogram, and one thread walks the bins to the bucket that
// holds the k-th key (kth_smallest_scan: one warp, with a scan). As soon as
// that bucket holds at most kCollect keys, one more pass gathers them into
// a shared list and each is ranked against the others; the keys are
// distinct, so one of them has rank k. On uniform keys that is two passes
// over the keys at N=10240 (about 40 keys per bucket) and three at
// N=102400 (about 400, then 2).
//
// Cost: one Philox call (ten rounds of two 32-bit multiplies, two
// multiply-highs, two three-input XORs and two key adds) per bit and stream
// where a kernel calls mc_alice / mc_sort_key, of which each call uses one
// word of four (the streamed QC kernel); the fused QC and fused generic
// kernels call mc_counter_words once per counter and use all four.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSelectBins = 256;
constexpr int kCollect = 512;

// The mc channel's streams (the counter's third word).
constexpr uint32_t kStreamAlice = 0;
constexpr uint32_t kStreamErrors = 1;

// A chunk's Philox key.
struct McKey {
  uint32_t k0, k1;
};

// What an mc launch draws from: the chunk's key, the chunk index of the
// launch's first frame, the errors per frame and the position field of the
// sort keys (mc_idx_bits). The kernels take it as an argument of its own
// beside their Params: with these fields inside Params, nvcc unrolled and
// unswitched the loops of the other modes less (fewer loads in flight, a
// spill in the streamed generic kernel; scripts/sass_torch_kernels.py shows
// it), so those modes keep the Params they had.
struct McDraw {
  McKey key;
  int frame0, num_errors, idx_bits;
};

// Bits of the position field of a sort key: max(1, bit length of n - 1).
__host__ __device__ inline int mc_idx_bits(long long n) {
  int bits = 1;
  while ((1ll << bits) < n) ++bits;
  return bits;
}

// A sort key's position field.
__device__ __forceinline__ uint32_t mc_low_mask(int idx_bits) {
  return (1u << idx_bits) - 1u;
}

// Philox4x32-10 of counter c under key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The word of external position p of `frame` (its index in the chunk) in
// `stream`.
__device__ __forceinline__ uint32_t mc_word(McKey key, int p, int frame,
                                            uint32_t stream) {
  const uint4 w = philox4x32_10(
      make_uint4((uint32_t)p >> 2, (uint32_t)frame, stream, 0u), key.k0,
      key.k1);
  switch (p & 3) {
    case 0: return w.x;
    case 1: return w.y;
    case 2: return w.z;
    default: return w.w;
  }
}

// The four words of counter q (external positions 4q .. 4q + 3) of
// `frame` in `stream`, from one call.
__device__ __forceinline__ uint4 mc_counter_words(McKey key, int q, int frame,
                                                  uint32_t stream) {
  return philox4x32_10(make_uint4((uint32_t)q, (uint32_t)frame, stream, 0u),
                       key.k0, key.k1);
}

__device__ __forceinline__ int mc_alice(McKey key, int p, int frame) {
  return (int)(mc_word(key, p, frame, kStreamAlice) & 1u);
}

// The error sort key of external position p: random high bits, p below.
__device__ __forceinline__ uint32_t mc_sort_key(McKey key, int p, int frame,
                                                int idx_bits) {
  return (mc_word(key, p, frame, kStreamErrors) >> idx_bits << idx_bits) |
         (uint32_t)p;
}

// Shared state of one block's selection.
struct Selection {
  unsigned hist[kSelectBins];
  uint32_t list[kCollect];
  uint32_t prefix, result;
  int rank, count, listed;
};

// The k-th smallest (1 <= k <= the number of keys) of distinct 32-bit keys
// that the block's threads enumerate: for_each(f) calls f(key) on the
// calling thread's share of the keys, and every thread of the block calls
// kth_smallest. Returns the key in every thread.
template <typename ForEach>
__device__ uint32_t kth_smallest(ForEach for_each, int k, Selection& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) {
    s.prefix = 0;
    s.rank = k;
  }
  int shift = 24;
  for (;; shift -= 8) {
    // Keys that share the prefix above this byte are counted by this byte.
    const uint32_t above = shift == 24 ? 0u : 0xffffffffu << (shift + 8);
    for (int b = tid; b < kSelectBins; b += nt) s.hist[b] = 0;
    __syncthreads();
    const uint32_t prefix = s.prefix;
    for_each([&](uint32_t key) {
      if ((key & above) == prefix)
        atomicAdd(&s.hist[(key >> shift) & 0xffu], 1u);
    });
    __syncthreads();
    if (tid == 0) {
      int r = s.rank, b = 0;
      while (r > (int)s.hist[b]) r -= (int)s.hist[b++];
      s.prefix = prefix | ((uint32_t)b << shift);
      s.rank = r;
      s.count = (int)s.hist[b];
      s.listed = 0;
    }
    __syncthreads();
    if (shift == 0) {  // every bit fixed: the key itself
      const uint32_t key = s.prefix;
      __syncthreads();  // read before a later call resets it
      return key;
    }
    if (s.count <= kCollect) break;
  }
  // The bucket's keys (those that share the prefix down to this byte),
  // gathered and ranked among themselves.
  const uint32_t within = 0xffffffffu << shift;
  const uint32_t prefix = s.prefix;
  for_each([&](uint32_t key) {
    if ((key & within) == prefix) s.list[atomicAdd(&s.listed, 1)] = key;
  });
  __syncthreads();
  const int n = s.listed, rank = s.rank;
  for (int i = tid; i < n; i += nt) {
    const uint32_t key = s.list[i];
    int below = 0;
    for (int j = 0; j < n; ++j) below += s.list[j] < key;
    if (below == rank - 1) s.result = key;
  }
  __syncthreads();
  return s.result;
}

// kth_smallest with each level's bucket found by one warp at once (lane l
// sums bins 8l .. 8l + 7, a warp scan and a ballot find the lane whose bins
// hold the rank-th key, and that lane walks its eight) in place of one
// thread's walk over the 256 bins while the block waits; the same result.
// The fused QC and fused generic kernels' selection.
template <typename ForEach>
__device__ uint32_t kth_smallest_scan(ForEach for_each, int k, Selection& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) {
    s.prefix = 0;
    s.rank = k;
  }
  int shift = 24;
  for (;; shift -= 8) {
    const uint32_t above = shift == 24 ? 0u : 0xffffffffu << (shift + 8);
    for (int b = tid; b < kSelectBins; b += nt) s.hist[b] = 0;
    __syncthreads();
    const uint32_t prefix = s.prefix;
    for_each([&](uint32_t key) {
      if ((key & above) == prefix)
        atomicAdd(&s.hist[(key >> shift) & 0xffu], 1u);
    });
    __syncthreads();
    if (tid < 32) {
      const int rank = s.rank;
      unsigned c[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = s.hist[8 * tid + i];
        sum += c[i];
      }
      unsigned incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, d);
        if (tid >= d) incl += v;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, incl >= (unsigned)rank);
      if (tid == __ffs(hit) - 1) {
        int r = rank - (int)(incl - sum), bin = 8 * tid + 7;
        unsigned cnt = c[7];
        bool found = false;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (!found) {
            if (r <= (int)c[i]) {
              bin = 8 * tid + i;
              cnt = c[i];
              found = true;
            } else {
              r -= (int)c[i];
            }
          }
        }
        s.prefix = prefix | ((uint32_t)bin << shift);
        s.rank = r;
        s.count = (int)cnt;
        s.listed = 0;
      }
    }
    __syncthreads();
    if (shift == 0) {  // every bit fixed: the key itself
      const uint32_t key = s.prefix;
      __syncthreads();  // read before a later call resets it
      return key;
    }
    if (s.count <= kCollect) break;
  }
  // The bucket's keys (those that share the prefix down to this byte),
  // gathered and ranked among themselves.
  const uint32_t within = 0xffffffffu << shift;
  const uint32_t prefix = s.prefix;
  for_each([&](uint32_t key) {
    if ((key & within) == prefix) s.list[atomicAdd(&s.listed, 1)] = key;
  });
  __syncthreads();
  const int n = s.listed, rank = s.rank;
  for (int i = tid; i < n; i += nt) {
    const uint32_t key = s.list[i];
    int below = 0;
    for (int j = 0; j < n; ++j) below += s.list[j] < key;
    if (below == rank - 1) s.result = key;
  }
  __syncthreads();
  return s.result;
}

}  // namespace
