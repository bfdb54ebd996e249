// Fused DP release at the cut: per-sample L2 clip + Gaussian noise.
//
// Replaces the TPU kernel src/repro/kernels/dp_release/kernel.py:
// dp_release_pallas (body _kernel). For each row r of x viewed as [B, F]:
//   n2    = sum_k x[r,k]^2
//   scale = min(1, clip_norm / sqrt(max(n2, 1e-24)))
//   out[r,k] = x[r,k] * scale + sigma * noise[r,k]   (noise read only if sigma > 0)
// The scale is the formula of src/repro/kernels/dp_release/ref.py:20-23, its
// rsqrt written as an IEEE division and square root; kernel.py:31-32 agrees
// with it within an ulp. As on the TPU kernel (kernel.py:29-36), x is
// float32, bfloat16 or float16 and the noise is of x's type or float32
// (the guard draws float32 noise beside a bf16 cut, guard.py:195), each
// element is converted to float32 on load, every sum and sigma * noise is
// float32, and the release is rounded once, to x's dtype (to nearest
// even). As on the TPU, the unclipped row is never written: only the
// release leaves the kernel.
//
// What bounds it on an H100: a few flops per element against 8 bytes read
// (12 with noise) and 4 written, so bytes. The row is read twice (once for
// the norm, once for the scaled write); at the paper's cut sizes
// (16,384 floats for COVID-CT, 802,816 for MURA, 25.7 MB at B 8) the second
// read mostly hits the 50 MB L2 cache, so device memory sees about one read
// per input. A bf16 x with float32 noise moves 2 + 4 + 2 bytes an element.
//
// Design. The plan (blocks a row k, chunk, float4 or scalar) is chosen by
// the wrapper (kernels/dp_release/ops.py release_plan) and checked here.
// k = 1: one block a row sums x^2 over its row and writes the release, one
// launch. k > 1, where B rows alone leave SMs idle: two launches over a
// [k, B] grid. The first has block j of row r sum x^2 over chunk j into
// partials[r, j] (a scratch buffer the wrapper allocates); the second has
// every block of row r add the row's k partials in the order 0 .. k-1, so
// all of them, and every relaunch, get the same bits of n2, then write its
// chunk. Within a block the sum is a fixed tree (each thread's strided
// terms in order, warp shuffles, then the 16 warp sums), so a relaunch is
// bit-identical. float32 loads and stores are float4 when F % 4 == 0 (and
// each chunk starts on a multiple of 4) and x and the noise are both
// float32, else scalar; the 2-byte types take the scalar path. The noise's
// type N is the second template parameter. The kernel allocates nothing.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;

// an element as float32, and a float32 back in the element's type
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// The block's total of `s`, the same bits in every thread: each warp
// reduces by shuffles, then every warp reduces the 16 warp sums in the same
// butterfly.
__device__ __forceinline__ float block_sum(float s, float* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  float t = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

// This thread's part of sum x^2 over xr[begin, end); with VEC4 (float32
// only) both ends are multiples of 4. Four loads in flight a thread.
template <typename T, bool VEC4>
__device__ __forceinline__ float chunk_sumsq(const T* __restrict__ xr, long long begin,
                                             long long end) {
  float s = 0.f;
  if constexpr (VEC4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr + begin);
    const long long n = (end - begin) / 4;
    long long i = threadIdx.x;
    for (; i + 3 * kThreads < n; i += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = x4[i + u * kThreads];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s = fmaf(v[u].x, v[u].x, s);
        s = fmaf(v[u].y, v[u].y, s);
        s = fmaf(v[u].z, v[u].z, s);
        s = fmaf(v[u].w, v[u].w, s);
      }
    }
    for (; i < n; i += kThreads) {
      const float4 v = x4[i];
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s);
      s = fmaf(v.w, v.w, s);
    }
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
      const float v = to_f(xr[i]);
      s = fmaf(v, v, s);
    }
  }
  return s;
}

__device__ __forceinline__ float row_scale(float n2, float clip_norm) {
  return fminf(1.f, clip_norm / sqrtf(fmaxf(n2, 1e-24f)));
}

// out[k] = x[k] * scale (+ sigma * noise[k]) over [begin, end) of a row;
// the noise (of type N) is read only when sigma > 0.
template <typename T, typename N, bool VEC4>
__device__ __forceinline__ void chunk_apply(const T* __restrict__ xr,
                                            const N* __restrict__ nr,
                                            T* __restrict__ orow, long long begin,
                                            long long end, float scale, float sigma) {
  if constexpr (VEC4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr + begin);
    float4* o4 = reinterpret_cast<float4*>(orow + begin);
    const long long n = (end - begin) / 4;
    if (sigma > 0.f) {
      const float4* n4 = reinterpret_cast<const float4*>(nr + begin);
      for (long long i = threadIdx.x; i < n; i += kThreads) {
        const float4 v = x4[i], z = n4[i];
        o4[i] = make_float4(v.x * scale + sigma * z.x, v.y * scale + sigma * z.y,
                            v.z * scale + sigma * z.z, v.w * scale + sigma * z.w);
      }
    } else {
      for (long long i = threadIdx.x; i < n; i += kThreads) {
        const float4 v = x4[i];
        o4[i] = make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
      }
    }
  } else if (sigma > 0.f) {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads)
      orow[i] = from_f<T>(to_f(xr[i]) * scale + sigma * to_f(nr[i]));
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads)
      orow[i] = from_f<T>(to_f(xr[i]) * scale);
  }
}

// k = 1: block r owns row r.
template <typename T, typename N, bool VEC4>
__global__ void __launch_bounds__(kThreads)
dp_release_rows(const T* __restrict__ x, const N* __restrict__ noise,
                T* __restrict__ out, long long F, float clip_norm, float sigma) {
  __shared__ float warp_sums[kThreads / 32];
  const long long base = (long long)blockIdx.x * F;
  const float n2 = block_sum(chunk_sumsq<T, VEC4>(x + base, 0, F), warp_sums);
  chunk_apply<T, N, VEC4>(x + base, noise ? noise + base : nullptr, out + base, 0, F,
                          row_scale(n2, clip_norm), sigma);
}

// k > 1, first launch: partials[r, j] = sum of x^2 over chunk j of row r.
template <typename T, bool VEC4>
__global__ void __launch_bounds__(kThreads)
dp_release_partials(const T* __restrict__ x, float* __restrict__ partials, long long F,
                    long long chunk) {
  __shared__ float warp_sums[kThreads / 32];
  const long long r = blockIdx.y, begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < F ? begin + chunk : F;
  const float s = block_sum(chunk_sumsq<T, VEC4>(x + r * F, begin, end), warp_sums);
  if (threadIdx.x == 0) partials[r * gridDim.x + blockIdx.x] = s;
}

// k > 1, second launch: n2 of row r is its k partials added in the order
// 0 .. k-1 (by every thread: the same bits everywhere), then chunk j.
template <typename T, typename N, bool VEC4>
__global__ void __launch_bounds__(kThreads)
dp_release_scaled(const T* __restrict__ x, const N* __restrict__ noise,
                  T* __restrict__ out, const float* __restrict__ partials, long long F,
                  long long chunk, float clip_norm, float sigma) {
  const long long r = blockIdx.y, begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < F ? begin + chunk : F;
  const float* pr = partials + r * gridDim.x;
  float n2 = 0.f;
  for (unsigned j = 0; j < gridDim.x; ++j) n2 += pr[j];
  const long long base = r * F;
  chunk_apply<T, N, VEC4>(x + base, noise ? noise + base : nullptr, out + base, begin, end,
                          row_scale(n2, clip_norm), sigma);
}

template <typename T, typename N, bool VEC4>
int launch(const T* x, const N* noise, T* out, float* partials, long long B,
           long long F, float clip_norm, float sigma, int k, long long chunk,
           cudaStream_t stream) {
  if (k == 1) {
    dp_release_rows<T, N, VEC4><<<(unsigned)B, kThreads, 0, stream>>>(x, noise, out, F,
                                                                      clip_norm, sigma);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)k, (unsigned)B);
  dp_release_partials<T, VEC4><<<grid, kThreads, 0, stream>>>(x, partials, F, chunk);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  dp_release_scaled<T, N, VEC4><<<grid, kThreads, 0, stream>>>(x, noise, out, partials, F,
                                                               chunk, clip_norm, sigma);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the plan on `stream` and returns cudaGetLastError(): non-zero
// when a launch was refused, or cudaErrorInvalidValue when the plan does not
// fit the shape (its k chunks of `chunk` features must cover F, the last one
// non-empty; float4 needs x and the noise float32, F and chunk multiples of
// 4 and 16-byte aligned tensors; k > 1 needs `partials` [B, k] float32 and
// B <= 65535), `dtype` is none of 0 (float32), 1 (bfloat16), 2 (float16)
// (the type of x and out), or `noise_dtype` is neither `dtype` nor 0 (the
// noise in x's type or in float32). `noise` may be null when sigma is 0,
// and is not read then.
extern "C" int dp_release_launch_plan_mixed(const void* x, const void* noise, void* out,
                                            float* partials, long long B, long long F,
                                            float clip_norm, float sigma, int k,
                                            long long chunk, int vec4, int dtype,
                                            int noise_dtype, void* stream) {
  if (B == 0 || F == 0) return 0;
  if (sigma <= 0.f) noise = nullptr;
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)out | (uintptr_t)noise;
  const bool covers = k >= 1 && chunk >= 1 && chunk * k >= F && chunk * (k - 1) < F;
  const bool aligned = !vec4 || (dtype == 0 && noise_dtype == 0 && F % 4 == 0 &&
                                 chunk % 4 == 0 && addr % 16 == 0);
  const bool split_ok = k == 1 || (partials != nullptr && B <= 65535);
  const bool types_ok = dtype >= 0 && dtype <= 2 && (noise_dtype == dtype || noise_dtype == 0);
  if (!covers || !aligned || !split_ok || (sigma > 0.f && noise == nullptr) || !types_ok)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define DP_RELEASE_LAUNCH(T, N, V)                                                          \
  launch<T, N, V>(static_cast<const T*>(x), static_cast<const N*>(noise),                  \
                  static_cast<T*>(out), partials, B, F, clip_norm, sigma, k, chunk, s)
  if (dtype == 1)
    return noise_dtype == 1 ? DP_RELEASE_LAUNCH(__nv_bfloat16, __nv_bfloat16, false)
                            : DP_RELEASE_LAUNCH(__nv_bfloat16, float, false);
  if (dtype == 2)
    return noise_dtype == 2 ? DP_RELEASE_LAUNCH(__half, __half, false)
                            : DP_RELEASE_LAUNCH(__half, float, false);
  return vec4 ? DP_RELEASE_LAUNCH(float, float, true) : DP_RELEASE_LAUNCH(float, float, false);
#undef DP_RELEASE_LAUNCH
}

// The entry point with the noise in x's type: the mixed launch with
// noise_dtype = dtype.
extern "C" int dp_release_launch_plan_typed(const void* x, const void* noise, void* out,
                                            float* partials, long long B, long long F,
                                            float clip_norm, float sigma, int k,
                                            long long chunk, int vec4, int dtype,
                                            void* stream) {
  return dp_release_launch_plan_mixed(x, noise, out, partials, B, F, clip_norm, sigma, k,
                                      chunk, vec4, dtype, dtype, stream);
}

// The float32 entry point of the interface before the typed one: the typed
// launch with dtype 0.
extern "C" int dp_release_launch_plan(const float* x, const float* noise, float* out,
                                      float* partials, long long B, long long F,
                                      float clip_norm, float sigma, int k, long long chunk,
                                      int vec4, void* stream) {
  return dp_release_launch_plan_typed(x, noise, out, partials, B, F, clip_norm, sigma, k,
                                      chunk, vec4, 0, stream);
}
