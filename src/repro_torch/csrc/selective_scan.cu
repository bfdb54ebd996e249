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
// What bounds it on an H100: at falcon-mamba-7b's widths it moves about
// 806 MB, 0.24 ms at 3.35 TB/s, and its 8.8 GFLOP take 0.13 ms on the FMA
// units, so the bound by bytes and operations is 0.24 ms. The least time is
// really set by both the bytes and the 1.07e9 expf, one per (b, t, d, s),
// each an ex2 on the special-function units: 16 a clock on each SM, about
// 0.25 ms for the ex2 alone at 1.98 GHz. Every other instruction of a state
// step (the loads of dt, u, B_t and C_t, the reduction over s, the store,
// the loop) takes instruction slots on top, so the design cuts those.
//
// Design: L lanes per (b, d) channel, each holding R states (s = R*lane + r)
// with h and A in registers; L and R are template parameters, so the state
// and shuffle loops unroll and a state past st is a zero A, B and C (its h
// stays 0) rather than a test. A block takes CPB channels of one batch row
// and walks the time axis in chunks of TC steps. Each chunk's B_t and C_t
// (shared by every channel of the row, zero-padded to L*R states) and the
// block's u_t and dt_t (channel-major, so a lane reads four steps of its
// channel with one float4 load) are copied into shared memory with
// cp.async, into one of two buffers: the copies of chunk c+1 are in flight
// while chunk c runs. Steps past S in the last chunk are staged as
// dt = u = 0, which leaves h unchanged. The time loop runs in groups of L
// steps: each lane keeps its partial h.C of each step of the group in a
// register, and one transposing reduce-scatter over the L lanes (L - 1
// shuffles, against log2(L) a step before) leaves step j's sum in lane j,
// which adds D*u and stores y; at L = 4 a warp's store covers four rows of
// 32 contiguous bytes. For st <= 16 (falcon-mamba), 4 lanes of 4 states:
// 131,072 lanes at falcon-mamba-7b's widths, B_t and C_t one float4 each a
// step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmemBytes = 96 * 1024;  // two chunks' staging; two blocks fit an SM

// 4 bytes global -> shared, asynchronously; bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Two blocks of 512 threads an SM (64 registers: the 4 x 4 shape spills 4
// bytes there, and ran slower at one block an SM without that cap); the
// 32-lane shape needs 91 and takes one.
template <int L, int R>
__global__ void __launch_bounds__(kMaxThreads, L >= 32 ? 1 : 2)
selective_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ A, const float* __restrict__ D,
                      float* __restrict__ y, int S, int di, int st, int CPB, int TC) {
  static_assert(L == 4 || L == 16 || L == 32, "lanes of a channel: 4, 16 or 32");
  static_assert(R == 1 || R == 4, "states of a lane: 1 or 4");
  constexpr int SP = L * R;  // states of a channel, st padded
  const int TP = TC + 4;     // a channel's staged row of u or dt: 16-byte aligned
  // two buffers, each [TC][SP] B, [TC][SP] C, [CPB][TP] u, [CPB][TP] dt
  const int buf_floats = 2 * TC * SP + 2 * CPB * TP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int b = blockIdx.y, d0 = blockIdx.x * CPB;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ch = tid / L, lane = tid % L;
  const int d = d0 + ch;
  const bool live = d < di;
  const long long row0 = (long long)b * S;

  // copies of chunk t0's B, C, u and dt into buffer `buf`; steps past S
  // and channels past di are zeros
  auto stage = [&](int buf, int t0) {
    float* bs = smem + buf * buf_floats;
    float* cs = bs + TC * SP;
    float* us = cs + TC * SP;
    float* dts = us + CPB * TP;
    const int n = min(TC, S - t0);
    for (int e = tid; e < TC * SP; e += nthreads) {
      const int t = e / SP, s = e - t * SP;
      const bool in = t < n && s < st;
      const long long off = in ? (row0 + t0 + t) * st + s : 0;
      cp_async4(bs + e, Bm + off, in ? 4 : 0);
      cp_async4(cs + e, Cm + off, in ? 4 : 0);
    }
    for (int e = tid; e < TC * CPB; e += nthreads) {
      const int t = e / CPB, c = e - t * CPB, dd = d0 + c;
      const bool in = t < n && dd < di;
      const long long idx = in ? (row0 + t0 + t) * di + dd : 0;
      cp_async4(us + c * TP + t, u + idx, in ? 4 : 0);
      cp_async4(dts + c * TP + t, dt + idx, in ? 4 : 0);
    }
  };

  float a[R], h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane * R + r;
    a[r] = (live && s < st) ? A[(long long)d * st + s] : 0.f;
    h[r] = 0.f;
  }
  const float Dv = live ? D[d] : 0.f;

  stage(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int t0 = 0, buf = 0; t0 < S; t0 += TC, buf ^= 1) {
    if (t0 + TC < S) stage(buf ^ 1, t0 + TC);  // in flight while this chunk runs
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this chunk's copies
    __syncthreads();                                          // everyone's

    const float* bs = smem + buf * buf_floats;
    const float* cs = bs + TC * SP;
    const float* uc = cs + TC * SP + ch * TP;
    const float* dtc = cs + TC * SP + CPB * TP + ch * TP;
    const int n = min(TC, S - t0);
    for (int g0 = 0; g0 < n; g0 += L) {  // steps past n leave h as it is
      float yp[L];
#pragma unroll
      for (int j4 = 0; j4 < L; j4 += 4) {
        const float4 dt4 = *reinterpret_cast<const float4*>(dtc + g0 + j4);
        const float4 u4 = *reinterpret_cast<const float4*>(uc + g0 + j4);
        const float dtv[4] = {dt4.x, dt4.y, dt4.z, dt4.w};
        const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int t = g0 + j4 + jj;
          const float dtu = __fmul_rn(dtv[jj], uv[jj]);
          float bv[R], cv[R];
          if constexpr (R == 4) {
            const float4 b4 = *reinterpret_cast<const float4*>(bs + t * SP + lane * 4);
            const float4 c4 = *reinterpret_cast<const float4*>(cs + t * SP + lane * 4);
            bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
            cv[0] = c4.x; cv[1] = c4.y; cv[2] = c4.z; cv[3] = c4.w;
          } else {
            bv[0] = bs[t * SP + lane];
            cv[0] = cs[t * SP + lane];
          }
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float dA = expf(__fmul_rn(dtv[jj], a[r]));
            h[r] = __fadd_rn(__fmul_rn(dA, h[r]), __fmul_rn(dtu, bv[r]));
            acc = fmaf(h[r], cv[r], acc);
          }
          yp[j4 + jj] = acc;
        }
      }
      // transposing reduce-scatter: after the round of `off`, yp[i] holds
      // the sum over 2*off lanes of step i + (lane & off ? off : 0) + ...;
      // at the end yp[0] is the sum over all L lanes of step `lane`
#pragma unroll
      for (int off = L / 2; off >= 1; off >>= 1) {
        const bool upper = lane & off;
#pragma unroll
        for (int i = 0; i < off; ++i) {
          const float send = upper ? yp[i] : yp[i + off];
          const float keep = upper ? yp[i + off] : yp[i];
          yp[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
      const int t = g0 + lane;
      if (live && t < n) y[(row0 + t0 + t) * di + d] = __fadd_rn(yp[0], __fmul_rn(Dv, uc[t]));
    }
    __syncthreads();  // this buffer is read before the next chunk but one lands in it
  }
}

template <int L, int R>
int launch(const float* u, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* D, float* y, int Bsz, int S, int di, int st,
           int d_tile, int t_chunk, cudaStream_t stream) {
  constexpr int SP = L * R;
  int CPB = d_tile < di ? d_tile : di;
  if (CPB > kMaxThreads / L) CPB = kMaxThreads / L;
  CPB = (CPB + 32 / L - 1) / (32 / L) * (32 / L);  // whole warps
  // time steps a chunk stages: t_chunk (at most S) rounded up to whole
  // groups of L, cut so that two chunks fit the shared-memory budget
  int TC = t_chunk < S ? t_chunk : S;
  TC = (TC + L - 1) / L * L;
  const int fit = (kMaxSmemBytes / 2 / (int)sizeof(float) - 8 * CPB) / (2 * SP + 2 * CPB);
  if (TC > fit) TC = fit / L * L;
  if (TC < L) return (int)cudaErrorInvalidValue;
  auto kernel = selective_scan_kernel<L, R>;
  const int bytes = (int)sizeof(float) * 2 * (2 * TC * SP + 2 * CPB * (TC + 4));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((di + CPB - 1) / CPB, Bsz);
  kernel<<<grid, CPB * L, bytes, stream>>>(u, dt, Bm, Cm, A, D, y, S, di, st, CPB, TC);
  return (int)cudaGetLastError();
}

// lanes of a channel that selective_scan_launch picks for st <= 16
constexpr int kLanesSt16 = 4;

}  // namespace

// As selective_scan_launch, with the lanes of a channel given: for st <= 16,
// 4 (4 states a lane) or 16 (one); for st <= 64, 16; for st <= 128, 32 (4
// states a lane each). 0 takes selective_scan_launch's choice.
extern "C" int selective_scan_launch_lanes(const float* u, const float* dt, const float* Bm,
                                           const float* Cm, const float* A, const float* D,
                                           float* y, int Bsz, int S, int di, int st,
                                           int d_tile, int t_chunk, int lanes,
                                           void* stream) {
  if (Bsz == 0 || S == 0 || di == 0) return 0;
  if (st < 1 || st > 128 || d_tile < 1 || t_chunk < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (st <= 16) {
    if (lanes == 0) lanes = kLanesSt16;
    if (lanes == 4)
      return launch<4, 4>(u, dt, Bm, Cm, A, D, y, Bsz, S, di, st, d_tile, t_chunk, s);
    if (lanes == 16)
      return launch<16, 1>(u, dt, Bm, Cm, A, D, y, Bsz, S, di, st, d_tile, t_chunk, s);
  } else if (st <= 64 && (lanes == 0 || lanes == 16)) {
    return launch<16, 4>(u, dt, Bm, Cm, A, D, y, Bsz, S, di, st, d_tile, t_chunk, s);
  } else if (st > 64 && (lanes == 0 || lanes == 32)) {
    return launch<32, 4>(u, dt, Bm, Cm, A, D, y, Bsz, S, di, st, d_tile, t_chunk, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for st outside 1..128). d_tile is the channels a block takes, cut so that
// a block has at most 512 threads and rounded up to fill whole warps;
// t_chunk the time steps staged at once, rounded up to whole groups of
// lanes and cut so that two chunks fit 96 KB of shared memory.
extern "C" int selective_scan_launch(const float* u, const float* dt, const float* Bm,
                                     const float* Cm, const float* A, const float* D,
                                     float* y, int Bsz, int S, int di, int st, int d_tile,
                                     int t_chunk, void* stream) {
  return selective_scan_launch_lanes(u, dt, Bm, Cm, A, D, y, Bsz, S, di, st, d_tile,
                                     t_chunk, 0, stream);
}
