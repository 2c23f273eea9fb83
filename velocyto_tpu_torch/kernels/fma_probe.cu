// FP32 FMA-chain ceiling probe for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel of the kernel bench, bench.py::_fma_kern
// (launched by _fma_run): per element, eight interleaved chains
// y_i <- y_i * x + 0.25 run 128 steps from y_i = x * (0.1 + 0.1 i), and
// the output is y_0 + y_1 + ... + y_7 summed in that order.  x is loaded
// per element, so the chain is a degree-128 polynomial of a runtime value
// that no compiler can fold.
//
// What bounds it: FP32 issue.  Each element costs 8 x 128 fused
// multiply-adds against 8 bytes of device-memory traffic, so the kernel
// is four orders of magnitude above the memory roofline.
//
// What the design does about it: one thread per element with the eight
// chains in registers, fully unrolled, so each step issues eight
// independent FFMA instructions that hide each other's latency.  The
// chain uses fmaf (one rounding per step); the plain version rounds twice
// (multiply, then add), so the two agree to rtol 1e-5, not bit for bit.
//
// C interface (bound with ctypes): vtt_fma_probe returns the cudaError_t of
// the launch as an int; 0 means the kernel was queued.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;
constexpr int kSteps = 128;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fma_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  float y[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) y[c] = xv * (float)(0.1 + 0.1 * c);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) y[c] = fmaf(y[c], xv, 0.25f);
  }
  float acc = y[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) acc += y[c];
  out[i] = acc;
}

}  // namespace

extern "C" int vtt_fma_probe(const void* x, void* out, int64_t n,
                             void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  fma_probe_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
