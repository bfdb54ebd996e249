// Fused DP release at the cut: per-sample L2 clip + Gaussian noise.
//
// Replaces the TPU kernel src/repro/kernels/dp_release/kernel.py:
// dp_release_pallas (body _kernel). For each row r of x viewed as [B, F]:
//   n2    = sum_k x[r,k]^2
//   scale = min(1, clip_norm / sqrt(max(n2, 1e-24)))
//   out[r,k] = x[r,k] * scale + sigma * noise[r,k]   (noise read only if sigma > 0)
// The scale is the formula of src/repro/kernels/dp_release/ref.py:20-23, its
// rsqrt written as an IEEE division and square root; kernel.py:31-32 agrees
// with it within an ulp. float32 in and out. As on the TPU, the unclipped row is never written:
// only the release leaves the kernel.
//
// What bounds it on an H100: a few flops per element against 8 bytes read
// (12 with noise) and 4 written, so bytes. The row is read twice (once for
// the norm, once for the scaled write); at the paper's cut sizes
// (16,384 floats for COVID-CT, 802,816 for MURA) the second read mostly hits
// the 50 MB L2 cache, so device memory sees about one read per input.
//
// Design: one block per sample. Its threads sum x^2 over the row with a
// strided loop (adjacent threads, adjacent addresses), reduce across each
// warp with shuffles and across warps through shared memory, then a second
// strided pass writes the release. No limit on the row size: the TPU
// kernel's VMEM cap (3*F*4 <= 12 MB) does not apply. One block per row
// leaves SMs idle at small B; splitting a row over blocks is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
dp_release_kernel(const float* __restrict__ x, const float* __restrict__ noise,
                  float* __restrict__ out, long long F, float clip_norm,
                  float sigma) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float row_scale;
  const long long base = (long long)blockIdx.x * F;
  const float* xr = x + base;

  float s = 0.f;
  for (long long k = threadIdx.x; k < F; k += kThreads) {
    const float v = xr[k];
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (threadIdx.x == 0) row_scale = fminf(1.f, clip_norm / sqrtf(fmaxf(t, 1e-24f)));
  }
  __syncthreads();
  const float scale = row_scale;

  float* orow = out + base;
  if (sigma > 0.f) {
    const float* nr = noise + base;
    for (long long k = threadIdx.x; k < F; k += kThreads)
      orow[k] = xr[k] * scale + sigma * nr[k];
  } else {
    for (long long k = threadIdx.x; k < F; k += kThreads) orow[k] = xr[k] * scale;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): non-zero when the
// launch was refused. `noise` may be null when sigma is 0.
extern "C" int dp_release_launch(const float* x, const float* noise, float* out,
                                 long long B, long long F, float clip_norm,
                                 float sigma, void* stream) {
  if (B == 0 || F == 0) return 0;
  dp_release_kernel<<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
      x, noise, out, F, clip_norm, sigma);
  return (int)cudaGetLastError();
}
