// Fused privacy layer: Conv3x3 (SAME) + bias + ReLU + MaxPool2x2 + noise.
//
// Replaces the TPU kernel src/repro/kernels/privacy_conv/kernel.py:
// privacy_conv_pallas (body _kernel). Same function, same layouts:
//   x [B, H, W, Cin] NHWC, w [3, 3, Cin, Cout] HWIO, b [Cout],
//   noise [B, H/2, W/2, Cout] -> out [B, H/2, W/2, Cout],
//   out = max over the 2x2 window of relu(conv(x, w) + b) + noise_scale * noise
// with zero padding of one pixel (H and W even). As on the TPU kernel
// (kernel.py:34-45) the tensors are float32, bfloat16 or float16 (one type
// for all five here), each element is converted to float32 on load, every
// sum is float32, and the output is stored in x's dtype (rounded to nearest
// even). As on the TPU, the pre-pool activation never leaves the chip: it
// lives in registers.
//
// What bounds it on an H100: at the COVID-CT shape ([B,64,64,1] -> 16
// channels) each input value feeds 9 x Cout = 144 multiply-adds, while each
// output element is read once as noise and written once; about 8 flops per
// byte moved, well under the ~20 flops per byte at which float32 FMA
// (67 TFLOP/s) would overtake memory (3.35 TB/s). So the bound is bytes.
// Cin = 1 gives a tensor core nothing to do, so this design is plain FMA.
//
// Design. A block owns a tile of 8 x 8 pooled pixels (16 x 16 pre-pool)
// and up to 16 output channels (4 groups of 4). It stages the tile's
// 18 x 18 x Cin input halo in shared memory once, with the SAME padding
// written there as zeros, so the inner loop has no bounds test; and the
// weights and biases of its channels beside it. A thread owns one pooled
// pixel and 4 consecutive channels: 16 float32 accumulators (4 channels x
// the 4 pre-pool positions), summed by FMA in the order ci -> kh -> kw, a
// 4 x 4 window of the halo and one float4 of weights a tap. It then reads
// the noise and writes the output as float4 along Cout where Cout % 4 == 0
// and the type is float32, else element by element. Cin is a template parameter: 1 (fully unrolled,
// the COVID-CT stage) or 0, the generic variant, which stages Cin 16
// channels at a time. The wrapper (kernels/privacy_conv/ops.py conv_plan) chooses the
// variant and the channels a block; this file checks that they fit the
// shape. Any B, H, W (even), Cin >= 1 and Cout >= 1; a tile or a channel
// group past the edge computes zeros and stores nothing. The kernel
// allocates nothing.
//
// Banked. The fleet's production cycle (protocol.py:89-101 in the JAX
// package: jax.vmap of the client forward over N queue items, each with
// its own client's bank) is one launch of the same kernel over N x b
// images: x [N, b, H, W, Cin], stacked banks w [C, 3, 3, Cin, Cout] and
// b [C, Cout], cids [N] int32, noise and out [N, b, H/2, W/2, Cout]. A
// block decodes its image as before, its item n = image / b from that, and
// stages the weights and biases of bank cids[n]; the arithmetic after the
// staging is the unbanked kernel's, in the same order, so each item's output
// has the bits of an unbanked launch on that item. A bank index outside
// [0, C) writes NaN over the block's outputs instead of reading past the
// banks.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

constexpr int TH = 8, TW = 8;                 // pooled pixels a block
constexpr int HH = 2 * TH + 2, HW = 2 * TW + 2;  // input halo rows, columns
constexpr int PLANE = HH * HW + 1;            // one channel of the halo, odd stride
constexpr int CPT = 4;                        // output channels a thread
constexpr int MAX_CPB = 16;                   // output channels a block
constexpr int CIN_CHUNK = 16;                 // input channels the generic variant stages
constexpr int MAX_THREADS = TH * TW * MAX_CPB / CPT;

template <typename T, int CIN, bool VEC4>
__global__ void __launch_bounds__(MAX_THREADS)
privacy_conv_tile(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, const T* __restrict__ noise,
                  T* __restrict__ out, int H, int W, int Cin, int Cout,
                  float noise_scale, int cpb, int cblocks, int tiles_x, int tiles_y,
                  const int* __restrict__ cids, int per_item, int n_banks) {
  constexpr int CC = CIN > 0 ? CIN : CIN_CHUNK;
  __shared__ float halo[CC * PLANE];
  __shared__ __align__(16) float ws[9 * CC * MAX_CPB];
  __shared__ float bs[MAX_CPB];

  // the block: its channel block fastest, then the tile's column, row, image
  int bid = blockIdx.x;
  const int cb = bid % cblocks;
  bid /= cblocks;
  const int tx = bid % tiles_x;
  bid /= tiles_x;
  const int ty = bid % tiles_y;
  const int b = bid / tiles_y;
  const int co0 = cb * cpb;
  // banked: this image's item reads the weights and biases of its bank
  bool bad_bank = false;
  if (cids != nullptr) {
    const int bank = cids[b / per_item];
    bad_bank = bank < 0 || bank >= n_banks;
    const long long k = bad_bank ? 0 : bank;
    w += k * 9 * Cin * Cout;
    bias += k * Cout;
  }
  // the thread: its channel group fastest, then its pixel in the tile
  const int ngroups = cpb / CPT;
  const int cg = threadIdx.x % ngroups, pix = threadIdx.x / ngroups;
  const int pi = pix / TW, pj = pix % TW;
  const int y0 = 2 * ty * TH - 1, x0 = 2 * tx * TW - 1;  // the halo's origin in x
  const int nthreads = blockDim.x;

  if (threadIdx.x < cpb)
    bs[threadIdx.x] = co0 + threadIdx.x < Cout ? to_f(bias[co0 + threadIdx.x]) : 0.f;
  // acc[c][q]: channel co0 + CPT*cg + c, pre-pool position q = 2*dy + dx
  float acc[CPT][4];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[c][q] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    const int cc = CIN > 0 ? CIN : min(CC, Cin - c0);
    if (c0 > 0) __syncthreads();  // every thread is done with the last chunk
    // the halo, in x's order (ci fastest) so that the loads coalesce;
    // outside the image it is the SAME padding, zero
    for (int e = threadIdx.x; e < HH * HW * cc; e += nthreads) {
      const int ci = e % cc, p = e / cc;
      const int yy = p / HW, xx = p % HW;
      const int gy = y0 + yy, gx = x0 + xx;
      halo[ci * PLANE + p] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
          ? to_f(x[(((long long)b * H + gy) * W + gx) * Cin + c0 + ci])
          : 0.f;
    }
    // ws[(tap*CC + ci)*cpb + c] = w[tap][c0 + ci][co0 + c], zero past Cout
    for (int e = threadIdx.x; e < 9 * cc * cpb; e += nthreads) {
      const int c = e % cpb, r = e / cpb;
      const int ci = r % cc, tap = r / cc;
      ws[(tap * CC + ci) * cpb + c] =
          co0 + c < Cout ? to_f(w[((long long)tap * Cin + c0 + ci) * Cout + co0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ci = 0; ci < (CIN > 0 ? CIN : cc); ++ci) {
      const float* hp = halo + ci * PLANE + 2 * pi * HW + 2 * pj;
      float p[4][4];
#pragma unroll
      for (int dy = 0; dy < 4; ++dy)
#pragma unroll
        for (int dx = 0; dx < 4; ++dx) p[dy][dx] = hp[dy * HW + dx];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4 wv =
              *reinterpret_cast<const float4*>(&ws[((kh * 3 + kw) * CC + ci) * cpb + CPT * cg]);
          const float wc[CPT] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            acc[c][0] = fmaf(p[kh][kw], wc[c], acc[c][0]);
            acc[c][1] = fmaf(p[kh][kw + 1], wc[c], acc[c][1]);
            acc[c][2] = fmaf(p[kh + 1][kw], wc[c], acc[c][2]);
            acc[c][3] = fmaf(p[kh + 1][kw + 1], wc[c], acc[c][3]);
          }
        }
      }
    }
  }

  const int Ho = H / 2, Wo = W / 2;
  const int i = ty * TH + pi, j = tx * TW + pj, co = co0 + CPT * cg;
  if (i >= Ho || j >= Wo || co >= Cout) return;
  float v[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const float bv = bs[CPT * cg + c];
    // relu then max equals max then relu: both are monotone
    v[c] = fmaxf(fmaxf(fmaxf(acc[c][0] + bv, acc[c][1] + bv),
                       fmaxf(acc[c][2] + bv, acc[c][3] + bv)), 0.f);
  }
  if (bad_bank) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) v[c] = __int_as_float(0x7fc00000);
  }
  const long long o = (((long long)b * Ho + i) * Wo + j) * Cout + co;
  if constexpr (VEC4) {
    if (noise_scale > 0.f) {
      const float4 z = *reinterpret_cast<const float4*>(noise + o);
      v[0] += noise_scale * z.x;
      v[1] += noise_scale * z.y;
      v[2] += noise_scale * z.z;
      v[3] += noise_scale * z.w;
    }
    *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (co + c < Cout) {
        if (noise_scale > 0.f) v[c] += noise_scale * to_f(noise[o + c]);
        out[o + c] = from_f<T>(v[c]);
      }
    }
  }
}

template <typename T, int CIN, bool VEC4>
int launch(const T* x, const T* w, const T* bias, const T* noise, T* out, int B, int H, int W, int Cin, int Cout, float noise_scale, int cpb,
           const int* cids, int per_item, int n_banks, cudaStream_t stream) {
  const int tiles_x = (W / 2 + TW - 1) / TW, tiles_y = (H / 2 + TH - 1) / TH;
  const int cblocks = (Cout + cpb - 1) / cpb;
  const long long blocks = (long long)B * tiles_y * tiles_x * cblocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  privacy_conv_tile<T, CIN, VEC4><<<(unsigned)blocks, TH * TW * (cpb / CPT), 0, stream>>>(
      x, w, bias, noise, out, H, W, Cin, Cout, noise_scale, cpb, cblocks, tiles_x, tiles_y,
      cids, per_item, n_banks);
  return (int)cudaGetLastError();
}

// The checks and the dispatch of every entry point; cids null is unbanked.
// dtype: 0 float32, 1 bfloat16, 2 float16, the type of all five tensors.
int launch_plan(const void* x, const void* w, const void* bias, const int* cids,
                const void* noise, void* out, int B, int per_item, int n_banks, int H, int W,
                int Cin, int Cout, float noise_scale, int cin_variant, int channels_per_block,
                int vec4, int dtype, void* stream) {
  if (noise_scale <= 0.f) noise = nullptr;
  const uintptr_t addr = (uintptr_t)out | (uintptr_t)noise;
  const bool ok = B >= 0 && H >= 0 && W >= 0 && H % 2 == 0 && W % 2 == 0 && Cin >= 1 &&
                  Cout >= 1 && (cin_variant == 0 || (cin_variant == 1 && Cin == 1)) &&
                  channels_per_block % CPT == 0 && channels_per_block >= CPT &&
                  channels_per_block <= MAX_CPB &&
                  dtype >= 0 && dtype <= 2 &&
                  (!vec4 || (dtype == 0 && Cout % 4 == 0 && addr % 16 == 0)) &&
                  (noise_scale <= 0.f || noise != nullptr) &&
                  (cids == nullptr || (per_item >= 1 && n_banks >= 1 && B % per_item == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int cpb = channels_per_block;
#define PRIVACY_CONV_LAUNCH(T, C, V)                                                     \
  launch<T, C, V>(static_cast<const T*>(x), static_cast<const T*>(w),                     \
                  static_cast<const T*>(bias), static_cast<const T*>(noise),              \
                  static_cast<T*>(out), B, H, W, Cin, Cout, noise_scale, cpb, cids, per_item, \
                  n_banks, s)
#define PRIVACY_CONV_HALF(T) \
  (cin_variant == 1 ? PRIVACY_CONV_LAUNCH(T, 1, false) : PRIVACY_CONV_LAUNCH(T, 0, false))
  if (dtype == 1) return PRIVACY_CONV_HALF(__nv_bfloat16);
  if (dtype == 2) return PRIVACY_CONV_HALF(__half);
  if (cin_variant == 1)
    return vec4 ? PRIVACY_CONV_LAUNCH(float, 1, true) : PRIVACY_CONV_LAUNCH(float, 1, false);
  return vec4 ? PRIVACY_CONV_LAUNCH(float, 0, true) : PRIVACY_CONV_LAUNCH(float, 0, false);
#undef PRIVACY_CONV_HALF
#undef PRIVACY_CONV_LAUNCH
}

}  // namespace

// Launches on `stream` with the wrapper's plan and returns
// cudaGetLastError(): non-zero when the launch was refused, or
// cudaErrorInvalidValue when the plan does not fit the shape. cin_variant is
// 1 (which must equal Cin) or 0 (any Cin); channels_per_block is 4, 8,
// 12 or 16; vec4 needs float32, Cout % 4 == 0 and 16-byte aligned out and
// noise; dtype is 0 (float32), 1 (bfloat16) or 2 (float16), the type of x,
// w, bias, noise and out alike. `noise` may be null when noise_scale is 0,
// and is not read then.
extern "C" int privacy_conv_launch_plan_typed(const void* x, const void* w, const void* bias,
                                              const void* noise, void* out, int B, int H, int W,
                                              int Cin, int Cout, float noise_scale,
                                              int cin_variant, int channels_per_block, int vec4,
                                              int dtype, void* stream) {
  return launch_plan(x, w, bias, nullptr, noise, out, B, 1, 1, H, W, Cin, Cout, noise_scale,
                     cin_variant, channels_per_block, vec4, dtype, stream);
}

// The float32 entry point of the interface before the typed one.
extern "C" int privacy_conv_launch_plan(const float* x, const float* w, const float* bias,
                                        const float* noise, float* out, int B, int H, int W,
                                        int Cin, int Cout, float noise_scale, int cin_variant,
                                        int channels_per_block, int vec4, void* stream) {
  return launch_plan(x, w, bias, nullptr, noise, out, B, 1, 1, H, W, Cin, Cout, noise_scale,
                     cin_variant, channels_per_block, vec4, 0, stream);
}

// The banked launch: N items of `per_item` images each (B = N * per_item
// images in x, noise and out), item n reading bank cids[n] of the n_banks
// stacked in w [n_banks, 3, 3, Cin, Cout] and bias [n_banks, Cout]. The
// plan is the unbanked plan of the B images; the checks are the same, and
// per_item >= 1, n_banks >= 1, B % per_item == 0, cids not null. float32.
extern "C" int privacy_conv_banked_launch_plan(const float* x, const float* w,
                                               const float* bias, const int* cids,
                                               const float* noise, float* out, int B,
                                               int per_item, int n_banks, int H, int W, int Cin,
                                               int Cout, float noise_scale, int cin_variant,
                                               int channels_per_block, int vec4, void* stream) {
  if (cids == nullptr) return (int)cudaErrorInvalidValue;
  return launch_plan(x, w, bias, cids, noise, out, B, per_item, n_banks, H, W, Cin, Cout,
                     noise_scale, cin_variant, channels_per_block, vec4, 0, stream);
}
