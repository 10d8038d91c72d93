// The channel's exact error injection (ops/channel.py: inject_errors) as
// one kernel: Bob's key is Alice's with exactly num_errors positions of each
// frame flipped, those whose sort key (hi, position) is smallest, where hi is
// the frame's random 32-bit word at that position (wide keys) or the word
// shifted right by b = max(1, bit_length(N - 1)) (narrow keys).
//
// It replaces no Pallas kernel: the JAX package forms these keys and selects
// in XLA (qkd_ldpc_v_tpu/ops/channel.py), and the port's plain version
// forms int64 keys, calls torch.kthvalue, compares, casts and XORs, each a
// pass over the frame in device memory.
//
// Bound: the bytes. The words are int64, 8 bytes a bit, beside one byte of
// Alice's key in and one of Bob's out; at 4096 frames of 102400 bits one
// read of the words takes 1.0 ms at 3.35 TB/s and one read of everything
// 1.25 ms.
//
// Design: one block a frame, and in the common case two passes over its
// words and one over its keys.
//   1. The words: a histogram in shared memory of the top 12 bits of the
//      composite key K = hi << p | position (p = b bits, so every K is
//      distinct and K's order is (hi, position)'s), 4096 bins, and a block
//      scan that finds the bin holding the num_errors-th smallest key and
//      the count of keys below it.
//   2. The words again and Alice's key: Bob's key written for every
//      position, flipped below that bin and not flipped from it on; the keys
//      of the bin itself (N / 4096 on uniform words, 25 at N = 102400) go to
//      a candidate list in shared memory, and a rank count among them flips
//      the smallest num_errors - below.
// Nothing else goes to device memory. Where the bin holds more keys than the
// list (words crowded into one bin, equal words, N beyond 8M), further rounds
// histogram the next 12 bits of the keys inside the bin, one pass over the
// words each, until it fits; the last digit holds one key, so every input
// stays exact after at most six rounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 12;
constexpr int kBins = 1 << kDigitBits;
constexpr int kBinsPerThread = kBins / kThreads;
constexpr unsigned kCandidates = 2048;

// The bin holding the need-th smallest key of a histogram: its index, the
// keys in the bins below it and the keys in it.
struct Bin {
  unsigned index, below, count;
};

struct Shared {
  unsigned hist[kBins];
  unsigned long long candidates[kCandidates];
  unsigned warp_sums[kWarps];
  unsigned num_candidates;
  Bin bin;
};

__device__ __forceinline__ unsigned long long sort_key(long long word, int i,
                                                       int hi_shift,
                                                       int pos_bits) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(word) >>
                                          hi_shift)
          << pos_bits) |
         static_cast<unsigned>(i);
}

// f(i, word) for every position i of a frame, four neighbouring positions a
// thread step (two 16-byte loads) where VEC.
template <bool VEC, class F>
__device__ __forceinline__ void for_each_word(const long long* __restrict__ w,
                                              int n, F f) {
  if (VEC) {
    const longlong2* w2 = reinterpret_cast<const longlong2*>(w);
    for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) {
      const longlong2 lo = __ldg(w2 + i / 2), hi = __ldg(w2 + i / 2 + 1);
      f(i, lo.x);
      f(i + 1, lo.y);
      f(i + 2, hi.x);
      f(i + 3, hi.y);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) f(i, __ldg(w + i));
  }
}

// bob[i] = alice[i] ^ flip(i, word) for every position i of a frame.
template <bool VEC, class F>
__device__ __forceinline__ void write_each(const long long* __restrict__ w,
                                           const signed char* __restrict__ a,
                                           signed char* __restrict__ b, int n,
                                           F flip) {
  if (VEC) {
    const longlong2* w2 = reinterpret_cast<const longlong2*>(w);
    for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) {
      const longlong2 lo = __ldg(w2 + i / 2), hi = __ldg(w2 + i / 2 + 1);
      const char4 in = __ldg(reinterpret_cast<const char4*>(a + i));
      char4 out;
      out.x = static_cast<char>(in.x ^ flip(i, lo.x));
      out.y = static_cast<char>(in.y ^ flip(i + 1, lo.y));
      out.z = static_cast<char>(in.z ^ flip(i + 2, hi.x));
      out.w = static_cast<char>(in.w ^ flip(i + 3, hi.y));
      *reinterpret_cast<char4*>(b + i) = out;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      b[i] = static_cast<signed char>(a[i] ^ flip(i, __ldg(w + i)));
  }
}

// s.bin = the bin of s.hist holding the need-th smallest key (1-based; need
// is at most the histogram's total). Each thread scans kBinsPerThread
// neighbouring bins; a warp-shuffle scan and one over the warps' sums give
// each thread the count below its bins.
__device__ void find_bin(Shared& s, unsigned need) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned local[kBinsPerThread];
  unsigned sum = 0;
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) {
    local[j] = s.hist[t * kBinsPerThread + j];
    sum += local[j];
  }
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s.warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned total = lane < kWarps ? s.warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(0xffffffffu, total, o);
      if (lane >= o) total += v;
    }
    if (lane < kWarps) s.warp_sums[lane] = total;
  }
  __syncthreads();
  unsigned below = incl - sum + (warp > 0 ? s.warp_sums[warp - 1] : 0);
  if (below < need && need <= below + sum) {
    for (int j = 0; j < kBinsPerThread; ++j) {
      if (need <= below + local[j]) {
        s.bin = Bin{static_cast<unsigned>(t * kBinsPerThread + j), below,
                    local[j]};
        break;
      }
      below += local[j];
    }
  }
  __syncthreads();
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    inject_select_kernel(const long long* __restrict__ words,
                         const signed char* __restrict__ alice,
                         signed char* __restrict__ bob, int n, int num_errors,
                         int hi_shift, int pos_bits) {
  __shared__ Shared s;
  const size_t row = blockIdx.x;
  const long long* w = words + row * n;
  const signed char* a = alice + row * n;
  signed char* b = bob + row * n;
  if (num_errors == 0) {
    write_each<VEC>(w, a, b, n, [](int, long long) { return 0; });
    return;
  }
  if (threadIdx.x == 0) s.num_candidates = 0;

  // The keys whose bits from `shift` up equal `prefix` hold the need-th
  // smallest of them, the num_errors-th smallest of the frame; each round
  // fixes the next digit of the prefix.
  int shift = (32 - hi_shift) + pos_bits;
  unsigned long long prefix = 0;
  unsigned need = static_cast<unsigned>(num_errors);
  for (;;) {
    const int high = shift;
    const int digit = min(kDigitBits, shift);
    shift -= digit;
    for (int j = threadIdx.x; j < kBins; j += kThreads) s.hist[j] = 0;
    __syncthreads();
    for_each_word<VEC>(w, n, [&](int i, long long word) {
      const unsigned long long key = sort_key(word, i, hi_shift, pos_bits);
      if ((key >> high) == prefix)
        atomicAdd(&s.hist[static_cast<unsigned>(key >> shift) &
                          ((1u << digit) - 1)],
                  1u);
    });
    __syncthreads();
    find_bin(s, need);
    const Bin bin = s.bin;
    need -= bin.below;
    prefix = (prefix << digit) | bin.index;
    if (bin.count <= kCandidates) break;
  }

  write_each<VEC>(w, a, b, n, [&](int i, long long word) {
    const unsigned long long key = sort_key(word, i, hi_shift, pos_bits);
    const unsigned long long top = key >> shift;
    if (top == prefix) s.candidates[atomicAdd(&s.num_candidates, 1u)] = key;
    return static_cast<int>(top < prefix);
  });
  __syncthreads();
  const unsigned count = s.num_candidates;
  const unsigned long long position_mask = (1ull << pos_bits) - 1;
  for (unsigned j = threadIdx.x; j < count; j += kThreads) {
    const unsigned long long key = s.candidates[j];
    unsigned rank = 0;
    for (unsigned m = 0; m < count; ++m) rank += s.candidates[m] < key;
    if (rank < need) {
      const int i = static_cast<int>(key & position_mask);
      b[i] = static_cast<signed char>(a[i] ^ 1);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// Bob's keys bob [batch, n] int8: alice [batch, n] int8 with the num_errors
// (0 .. n) positions of each frame flipped whose sort keys are smallest,
// from words [batch, n] int64 holding 0 .. 2**32 - 1; narrow 0 takes the
// wide keys (hi = word), 1 the narrow ones (hi = word >> b). Launches on
// the caller's stream and returns the CUDA error of the launch.
int inject_select(const long long* words, const signed char* alice,
                  signed char* bob, int batch, int n, int num_errors,
                  int narrow, void* stream) {
  if (batch < 1 || n < 1 || num_errors < 0 || num_errors > n)
    return static_cast<int>(cudaErrorInvalidValue);
  int pos_bits = 1;
  while (pos_bits < 31 && (static_cast<long long>(n - 1) >> pos_bits) != 0)
    ++pos_bits;
  const int hi_shift = narrow ? pos_bits : 0;
  const bool vec = n % 4 == 0 && aligned(words, 16) && aligned(alice, 4) &&
                   aligned(bob, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    inject_select_kernel<true><<<batch, kThreads, 0, s>>>(
        words, alice, bob, n, num_errors, hi_shift, pos_bits);
  else
    inject_select_kernel<false><<<batch, kThreads, 0, s>>>(
        words, alice, bob, n, num_errors, hi_shift, pos_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
