// Fused privacy layer: Conv3x3 (SAME) + bias + ReLU + MaxPool2x2 + noise.
//
// Replaces the TPU kernel src/repro/kernels/privacy_conv/kernel.py:
// privacy_conv_pallas (body _kernel). Same function, same layouts:
//   x [B, H, W, Cin] NHWC, w [3, 3, Cin, Cout] HWIO, b [Cout],
//   noise [B, H/2, W/2, Cout] -> out [B, H/2, W/2, Cout], all float32,
//   out = max over the 2x2 window of relu(conv(x, w) + b) + noise_scale * noise
// with zero padding of one pixel (H and W even). As on the TPU, the pre-pool
// activation never leaves the chip: it lives in four registers per thread.
//
// What bounds it on an H100: at the COVID-CT shape ([B,64,64,1] -> 16
// channels) each input value feeds 9 x Cout = 144 multiply-adds, while each
// output element is read once as noise and written once; about 8 flops per
// byte moved, well under the ~20 flops per byte at which float32 FMA
// (67 TFLOP/s) would overtake memory (3.35 TB/s). So the bound is bytes.
// Cin = 1 gives a tensor core nothing to do, so this design is plain FMA.
//
// Design: one thread per pooled output (b, i, j, co), co fastest. Adjacent
// threads write adjacent addresses (NHWC), read the noise coalesced, read
// the weights w[kh][kw][ci][co] coalesced, and the Cout threads of one pixel
// read the same 4x4xCin input window, which the L1 cache broadcasts. Any Cin
// and Cout; the wrapper allocates the output, the kernel allocates nothing.
#include <cuda_runtime.h>

namespace {

__global__ void privacy_conv_kernel(const float* __restrict__ x,
                                    const float* __restrict__ w,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ noise,
                                    float* __restrict__ out,
                                    int B, int H, int W, int Cin, int Cout,
                                    float noise_scale) {
  const int Ho = H / 2, Wo = W / 2;
  const long long total = (long long)B * Ho * Wo * Cout;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int co = (int)(idx % Cout);
    long long r = idx / Cout;
    const int j = (int)(r % Wo);
    r /= Wo;
    const int i = (int)(r % Ho);
    const int b = (int)(r / Ho);
    // the 4x4 input window under the four 3x3 taps of this 2x2 pool window
    const int y0 = 2 * i - 1, x0 = 2 * j - 1;
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
    for (int ci = 0; ci < Cin; ++ci) {
      float p[4][4];
#pragma unroll
      for (int dy = 0; dy < 4; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 4; ++dx) {
          const int yy = y0 + dy, xx = x0 + dx;
          p[dy][dx] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
              ? x[(((long long)b * H + yy) * W + xx) * Cin + ci]
              : 0.f;
        }
      }
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float wv = w[((long long)(kh * 3 + kw) * Cin + ci) * Cout + co];
          a00 = fmaf(p[kh][kw], wv, a00);
          a01 = fmaf(p[kh][kw + 1], wv, a01);
          a10 = fmaf(p[kh + 1][kw], wv, a10);
          a11 = fmaf(p[kh + 1][kw + 1], wv, a11);
        }
      }
    }
    const float bv = bias[co];
    // relu then max equals max then relu: both are monotone
    float v = fmaxf(fmaxf(a00 + bv, a01 + bv), fmaxf(a10 + bv, a11 + bv));
    v = fmaxf(v, 0.f);
    if (noise_scale > 0.f) v += noise_scale * noise[idx];
    out[idx] = v;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): non-zero when the
// launch was refused. `noise` may be null when noise_scale is 0.
extern "C" int privacy_conv_launch(const float* x, const float* w,
                                   const float* bias, const float* noise,
                                   float* out, int B, int H, int W, int Cin,
                                   int Cout, float noise_scale, void* stream) {
  const long long total = (long long)B * (H / 2) * (W / 2) * Cout;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // the loop strides past it
  privacy_conv_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, w, bias, noise, out, B, H, W, Cin, Cout, noise_scale);
  return (int)cudaGetLastError();
}
