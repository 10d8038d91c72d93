// The SPA pair's elementwise steps (csrc/spa.cuh) applied to a tensor, so
// that they are held alone against torch: chip_smoke.py (phase 2g) feeds
// every float32 bit pattern through each step and compares the bits with
// torch.tanh(x * 0.5), 2 * torch.atanh(guard_atanh_ratio(x)) and the
// ops/linapprox.py tables on the card. It is a test entry: no decoder calls
// it. Built with the kernels' flags, so the steps compile as they do
// inside the kernels.

#include <cstdint>
#include <cuda_runtime.h>

#include "spa.cuh"

namespace {

// step: 0 spa_term<kSpa>, 1 spa_extrinsic<kSpa>, 2 spa_term<kSpaLin>,
// 3 spa_extrinsic<kSpaLin>.
template <int STEP>
__global__ void spa_steps_kernel(const float* x, float* out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = x[i];
    float r;
    if (STEP == 0) r = spa_term<kSpa>(v);
    if (STEP == 1) r = spa_extrinsic<kSpa>(v);
    if (STEP == 2) r = spa_term<kSpaLin>(v);
    if (STEP == 3) r = spa_extrinsic<kSpaLin>(v);
    out[i] = r;
  }
}

}  // namespace

extern "C" {

// out[i] = step(x[i]) for i < n, on the caller's stream; returns the CUDA
// error of the launch.
int spa_steps(const float* x, float* out, long long n, int step,
              void* stream) {
  if (n < 1 || step < 0 || step > 3) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  const int grid = blocks < 65536 ? (int)blocks : 65536;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (step) {
    case 0: spa_steps_kernel<0><<<grid, threads, 0, s>>>(x, out, n); break;
    case 1: spa_steps_kernel<1><<<grid, threads, 0, s>>>(x, out, n); break;
    case 2: spa_steps_kernel<2><<<grid, threads, 0, s>>>(x, out, n); break;
    default: spa_steps_kernel<3><<<grid, threads, 0, s>>>(x, out, n); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
