// Mamba-1 selective scan forward, with the recurrent state held in
// registers across the whole time loop.
//
// Replaces the TPU kernel src/repro/kernels/selective_scan/kernel.py:
// selective_scan_pallas (body _kernel). For batch b, channel d < di and
// state s < st, from h_{-1} = 0:
//   h_t[d,s] = exp(dt_t[d] * A[d,s]) * h_{t-1}[d,s] + (dt_t[d] * u_t[d]) * B_t[s]
//   y_t[d]   = sum_s h_t[d,s] * C_t[s] + D[d] * u_t[d]
// u, dt, y: [Bsz, S, di]; B, C: [Bsz, S, st]; A: [di, st]; D: [di]; all
// float32 and contiguous. The state update is the plain version's rounding,
// a product and a sum each rounded (no fused multiply-add), with expf; only
// the order of the sum over s differs.
//
// As on the TPU (kernel.py:8-10), the state h never leaves the chip and the
// discretised dA = exp(dt*A) and dBu = dt*u*B, [Bsz, S, di, st] each (4.3 GB
// each at falcon-mamba-7b's widths, B 4, S 2048), are never written to
// device memory: the kernel reads u, dt, B, C once and writes y once.
//
// What bounds it on an H100: bytes, in principle. At falcon-mamba-7b's
// widths it moves about 806 MB (0.24 ms at 3.35 TB/s) against 1.07e9 expf,
// one per (b, t, d, s), on the special-function units (16 a clock on each
// SM: about 0.25 ms for the ex2 alone at 1.98 GHz), plus the multiplies,
// adds and the shuffle reduction, so the instruction rate is close to the
// byte rate.
//
// Design: one lane per (b, d, s) state, L = min(32, next power of two of st)
// lanes per channel, each holding R = ceil(st / L) states; h and A sit in
// registers. A block takes CPB channels of one batch row (CPB * L threads,
// at most 1024) and walks the time axis in chunks of TC steps: each chunk
// stages B_t and C_t (shared by every channel of the row) and the block's
// u_t and dt_t in shared memory with coalesced loads, runs the TC steps, and
// writes the chunk's y from shared memory with coalesced stores. The sum
// over s is a shuffle reduction over the L lanes of a channel. One thread per
// (b, d) would give falcon-mamba only 32,768 threads for 132 SMs, each with a
// serial loop of 2048 steps; one lane per state gives 524,288.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmemBytes = 96 * 1024;  // a chunk's staging; two blocks fit an SM

template <int R>
__global__ void __launch_bounds__(kMaxThreads, 2)
selective_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ A, const float* __restrict__ D,
                      float* __restrict__ y, int S, int di, int st, int L, int CPB,
                      int TC) {
  extern __shared__ float smem[];
  float* bs = smem;            // [TC][st]
  float* cs = bs + TC * st;    // [TC][st]
  float* us = cs + TC * st;    // [TC][CPB]
  float* dts = us + TC * CPB;  // [TC][CPB]
  float* ys = dts + TC * CPB;  // [TC][CPB]

  const int b = blockIdx.y, d0 = blockIdx.x * CPB;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ch = tid / L, lane = tid - ch * L;
  const int d = d0 + ch;
  const bool live = d < di;

  float a[R], h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane + r * L;
    a[r] = (live && s < st) ? A[(long long)d * st + s] : 0.f;
    h[r] = 0.f;
  }
  const float Dv = live ? D[d] : 0.f;
  const long long row0 = (long long)b * S;

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int n = min(TC, S - t0);
    const long long bc0 = (row0 + t0) * st;
    for (int e = tid; e < n * st; e += nthreads) {
      bs[e] = Bm[bc0 + e];
      cs[e] = Cm[bc0 + e];
    }
    for (int e = tid; e < n * CPB; e += nthreads) {
      const int t = e / CPB, c = e - t * CPB, dd = d0 + c;
      const long long idx = (row0 + t0 + t) * di + dd;
      us[e] = dd < di ? u[idx] : 0.f;
      dts[e] = dd < di ? dt[idx] : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float dtv = dts[t * CPB + ch], uv = us[t * CPB + ch];
      const float dtu = __fmul_rn(dtv, uv);
      float yp = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = lane + r * L;
        if (s < st) {
          const float dA = expf(__fmul_rn(dtv, a[r]));
          h[r] = __fadd_rn(__fmul_rn(dA, h[r]), __fmul_rn(dtu, bs[t * st + s]));
          yp = fmaf(h[r], cs[t * st + s], yp);
        }
      }
      for (int off = L >> 1; off > 0; off >>= 1)
        yp += __shfl_xor_sync(0xffffffffu, yp, off);
      if (lane == 0) ys[t * CPB + ch] = __fadd_rn(yp, __fmul_rn(Dv, uv));
    }
    __syncthreads();  // the chunk's y is complete

    for (int e = tid; e < n * CPB; e += nthreads) {
      const int t = e / CPB, c = e - t * CPB, dd = d0 + c;
      if (dd < di) y[(row0 + t0 + t) * di + dd] = ys[e];
    }
    // the next chunk's loads come after this thread's stores, and its
    // compute after the barrier that follows them
  }
}

template <int R>
int launch(const float* u, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* D, float* y, int Bsz, int S, int di, int st,
           int L, int CPB, int TC, cudaStream_t stream) {
  auto kernel = selective_scan_kernel<R>;
  const int bytes = (int)sizeof(float) * TC * (2 * st + 3 * CPB);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((di + CPB - 1) / CPB, Bsz);
  kernel<<<grid, CPB * L, bytes, stream>>>(u, dt, Bm, Cm, A, D, y, S, di, st, L, CPB, TC);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for st outside 1..128). d_tile is the channels a block takes, cut so that
// a block has at most 1024 threads and rounded up to fill whole warps;
// t_chunk the time steps staged at once, cut to fit 96 KB of shared memory.
extern "C" int selective_scan_launch(const float* u, const float* dt, const float* Bm,
                                     const float* Cm, const float* A, const float* D,
                                     float* y, int Bsz, int S, int di, int st, int d_tile,
                                     int t_chunk, void* stream) {
  if (Bsz == 0 || S == 0 || di == 0) return 0;
  if (st < 1 || st > 128 || d_tile < 1 || t_chunk < 1) return (int)cudaErrorInvalidValue;
  int L = 1;
  while (L < st && L < 32) L <<= 1;
  const int R = (st + L - 1) / L;
  const int per_warp = 32 / L;  // channels of one warp
  int CPB = d_tile < di ? d_tile : di;
  if (CPB > kMaxThreads / L) CPB = kMaxThreads / L;
  CPB = (CPB + per_warp - 1) / per_warp * per_warp;
  const int row_bytes = (int)sizeof(float) * (2 * st + 3 * CPB);
  int TC = t_chunk < S ? t_chunk : S;
  if (TC > kMaxSmemBytes / row_bytes) TC = kMaxSmemBytes / row_bytes;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (R) {
    case 1: return launch<1>(u, dt, Bm, Cm, A, D, y, Bsz, S, di, st, L, CPB, TC, s);
    case 2: return launch<2>(u, dt, Bm, Cm, A, D, y, Bsz, S, di, st, L, CPB, TC, s);
    case 3:
    case 4: return launch<4>(u, dt, Bm, Cm, A, D, y, Bsz, S, di, st, L, CPB, TC, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
