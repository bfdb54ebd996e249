// Mamba-1 selective scan forward, with the recurrent state held in
// registers across the whole time loop, and its backward.
//
// The forward replaces the TPU kernel
// src/repro/kernels/selective_scan/kernel.py: selective_scan_pallas (body
// _kernel); the backward replaces none (the TPU kernel has no VJP): it is
// the port's counterpart of the gradient XLA takes of the JAX model's
// lax.scan, so that a Mamba layer trains on the card (see the backward's
// note further down). For batch b, channel d < di and
// state s < st, from h_{-1} = 0:
//   h_t[d,s] = exp(dt_t[d] * A[d,s]) * h_{t-1}[d,s] + (dt_t[d] * u_t[d]) * B_t[s]
//   y_t[d]   = sum_s h_t[d,s] * C_t[s] + D[d] * u_t[d]
// u, dt, y: [Bsz, S, di]; B, C: [Bsz, S, st]; A: [di, st]; D: [di]; all
// float32 and contiguous, save u, which may be bfloat16 (read as float32:
// the plain version's u.float(), exactly). The state update is the plain version's rounding,
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmemBytes = 96 * 1024;  // two chunks' staging; two blocks fit an SM

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
//
// hck, where not null: the state entering every K-step chunk of time,
// [Bsz, ceil(S / K), di, st] float32 (K a multiple of L), which the
// backward recomputes the states from; it is stored at the start of the
// group of L steps that begins the chunk, from the registers.
template <int L, int R, typename TU>
__global__ void __launch_bounds__(kMaxThreads, L >= 32 ? 1 : 2)
selective_scan_kernel(const TU* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ A, const float* __restrict__ D,
                      float* __restrict__ y, float* __restrict__ hck, int S, int di, int st,
                      int CPB, int TC, int K) {
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
      if constexpr (std::is_same<TU, float>::value) {
        cp_async4(us + c * TP + t, u + idx, in ? 4 : 0);
      } else {  // a 2-byte u: read and widened here (cp.async takes 4 bytes or more)
        us[c * TP + t] = in ? to_f32(u[idx]) : 0.f;
      }
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
      if (hck != nullptr && (t0 + g0) % K == 0 && live) {
        float* hp = hck + (((long long)b * ((S + K - 1) / K) + (t0 + g0) / K) * di + d) * st;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int s = lane * R + r;
          if (s < st) hp[s] = h[r];
        }
      }
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

template <int L, int R, typename TU = float>
int launch(const TU* u, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* D, float* y, int Bsz, int S, int di, int st,
           int d_tile, int t_chunk, cudaStream_t stream, float* hck = nullptr, int K = 0) {
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
  if (hck != nullptr && (K < L || K % L != 0)) return (int)cudaErrorInvalidValue;
  auto kernel = selective_scan_kernel<L, R, TU>;
  const int bytes = (int)sizeof(float) * 2 * (2 * TC * SP + 2 * CPB * (TC + 4));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((di + CPB - 1) / CPB, Bsz);
  kernel<<<grid, CPB * L, bytes, stream>>>(u, dt, Bm, Cm, A, D, y, hck, S, di, st, CPB, TC, K);
  return (int)cudaGetLastError();
}

// lanes of a channel that selective_scan_launch picks for st <= 16
constexpr int kLanesSt16 = 4;

// ---------------------------------------------------------------- backward
//
// The gradient of y = scan(u, dt, B, C, A, D) given dy [Bsz, S, di]
// float32: du (in u's type), d(dt) [Bsz, S, di]; dB and dC as one
// [slabs, Bsz, S, st] partial sum a slab (the caller sums the slabs); dA
// as [Bsz, di, st] and dD as [Bsz, di] (the caller sums over the batch).
// With g_t = dL/dh_t = C_t dy_t + exp(dt_{t+1} A) g_{t+1} (per d, s):
//   dC_t[s] = sum_d h_t dy_t            dB_t[s] = sum_d g_t dt_t u_t
//   x = sum_s g_t B_t[s]                du_t = x dt_t + D dy_t
//   z = sum_s g_t h_{t-1} exp(dt_t A) A   d(dt_t) = x u_t + z
//   dA[s] = sum_t g_t h_{t-1} exp(dt_t A) dt_t      dD = sum_t dy_t u_t
// No [Bsz, S, di, st] tensor is written. The forward stores the state
// entering every K = 32 steps (hck); the backward walks the chunks from
// the last, recomputes a chunk's 32 states from its checkpoint into
// registers (the forward's own roundings, so the same states bit for bit),
// then walks them back, carrying g. What bounds it: like the forward, the
// expf (two a state step: the recompute and the walk back) and the bytes
// (u, dt, dy, the checkpoints read once, du and d(dt) written once).
//
// Design: 16 lanes a (b, d) channel, one state a lane (st <= 16), so a
// lane's 32 recomputed states and its two per-step partial sums over s
// stay in registers; CPB = 32 channels a block (512 threads). Each chunk's
// u, dt, dy (channel-major, padded against bank conflicts) and B, C are
// staged in shared memory. The sums over s (x and z) go through the
// forward's transposing reduce-scatter, a group of 16 steps at a time;
// the sums over d (dB, dC) through one shuffle between a warp's two
// channels, then per-warp rows in shared memory summed over the block's
// warps when the chunk is done and added to the block's slab. A block
// takes every gridDim.x-th tile of CPB channels, so the slabs number
// gridDim.x (the caller sizes it to about one block an SM).
constexpr int kBwdSteps = 32;  // the checkpoint interval K
constexpr int kBwdLanes = 16;
constexpr int kBwdChannels = 32;

template <typename TU>
__global__ void __launch_bounds__(kBwdChannels * kBwdLanes, 1)
selective_scan_bwd_kernel(const TU* __restrict__ u, const float* __restrict__ dt,
                          const float* __restrict__ Bm, const float* __restrict__ Cm,
                          const float* __restrict__ A, const float* __restrict__ D,
                          const float* __restrict__ dy, const float* __restrict__ hck,
                          TU* __restrict__ du, float* __restrict__ ddt,
                          float* __restrict__ dBp, float* __restrict__ dCp,
                          float* __restrict__ dAp, float* __restrict__ dDp, int Bsz, int S,
                          int di, int st) {
  constexpr int K = kBwdSteps, L = kBwdLanes, CPB = kBwdChannels, NW = CPB * L / 32;
  constexpr int KP = K + 1;
  __shared__ float su[CPB * KP], sdt[CPB * KP], sdy[CPB * KP];
  __shared__ float sB[K * L], sC[K * L];
  extern __shared__ float4 pd4[];
  float* pdB = reinterpret_cast<float*>(pd4);  // [NW][K][L]
  float* pdC = pdB + NW * K * L;

  const int b = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ch = tid / L, s = tid % L, w = tid / 32;
  const long long row0 = (long long)b * S;
  const int nck = (S + K - 1) / K;
  const int tiles = (di + CPB - 1) / CPB;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int d0 = tile * CPB, d = d0 + ch;
    const bool live = d < di, sl = live && s < st;
    const float a_s = sl ? A[(long long)d * st + s] : 0.f;
    const float Dv = live ? D[d] : 0.f;
    float carry = 0.f, dA_acc = 0.f, dD_acc = 0.f;
    for (int k = nck - 1; k >= 0; --k) {
      const int t0 = k * K, n = min(K, S - t0);
      __syncthreads();  // the last chunk's reads of shared memory are done
      for (int e = tid; e < K * CPB; e += nthreads) {
        const int t = e / CPB, c = e - t * CPB, dd = d0 + c;
        const bool in = t < n && dd < di;
        const long long idx = (row0 + t0 + t) * di + dd;
        su[c * KP + t] = in ? to_f32(u[idx]) : 0.f;
        sdt[c * KP + t] = in ? dt[idx] : 0.f;
        sdy[c * KP + t] = in ? dy[idx] : 0.f;
      }
      for (int e = tid; e < K * L; e += nthreads) {
        const int t = e / L, ss = e - t * L;
        const bool in = t < n && ss < st;
        const long long off = (row0 + t0 + t) * st + ss;
        sB[e] = in ? Bm[off] : 0.f;
        sC[e] = in ? Cm[off] : 0.f;
      }
      __syncthreads();
      const float* uc = su + ch * KP;
      const float* dtc = sdt + ch * KP;
      const float* dyc = sdy + ch * KP;
      const float h0 = sl ? hck[(((long long)b * nck + k) * di + d) * st + s] : 0.f;
      // the chunk's states, recomputed as the forward computed them
      float hs[K];
      float h = h0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float dtu = __fmul_rn(dtc[j], uc[j]);
        const float dA = expf(__fmul_rn(dtc[j], a_s));
        h = __fadd_rn(__fmul_rn(dA, h), __fmul_rn(dtu, sB[j * L + s]));
        hs[j] = h;
      }
      // walked back a group of L steps at a time; steps past n carry
      // dt = u = dy = 0 (their g is the carry, unchanged: exp(0) = 1)
#pragma unroll
      for (int gi = K / L - 1; gi >= 0; --gi) {
        float p1[L], p2[L];
#pragma unroll
        for (int jj = L - 1; jj >= 0; --jj) {
          const int j = gi * L + jj;
          const float dtv = dtc[j], uv = uc[j], dyv = dyc[j];
          const float g = carry + sC[j * L + s] * dyv;
          const float dA = expf(__fmul_rn(dtv, a_s));
          const float dlog = g * (j > 0 ? hs[j - 1] : h0) * dA;  // dL/d(dt_t A[s])
          dA_acc += dlog * dtv;
          p1[jj] = g * sB[j * L + s];
          p2[jj] = dlog * a_s;
          float qB = g * __fmul_rn(dtv, uv), qC = hs[j] * dyv;
          qB += __shfl_xor_sync(0xffffffffu, qB, 16);
          qC += __shfl_xor_sync(0xffffffffu, qC, 16);
          if ((tid & 16) == 0) {
            pdB[(w * K + j) * L + s] = qB;
            pdC[(w * K + j) * L + s] = qC;
          }
          carry = dA * g;
        }
        // the forward's transposing reduce-scatter: afterwards p1[0] and
        // p2[0] of lane s hold the sums over the channel's L lanes of step
        // gi * L + s
#pragma unroll
        for (int off = L / 2; off >= 1; off >>= 1) {
          const bool upper = s & off;
#pragma unroll
          for (int i = 0; i < off; ++i) {
            const float send1 = upper ? p1[i] : p1[i + off];
            const float keep1 = upper ? p1[i + off] : p1[i];
            const float send2 = upper ? p2[i] : p2[i + off];
            const float keep2 = upper ? p2[i + off] : p2[i];
            p1[i] = keep1 + __shfl_xor_sync(0xffffffffu, send1, off);
            p2[i] = keep2 + __shfl_xor_sync(0xffffffffu, send2, off);
          }
        }
        const int j = gi * L + s;
        if (live && j < n) {
          const float dtv = dtc[j], uv = uc[j], dyv = dyc[j];
          const long long idx = (row0 + t0 + j) * di + d;
          du[idx] = from_f32<TU>(p1[0] * dtv + Dv * dyv);
          ddt[idx] = p1[0] * uv + p2[0];
          dD_acc += dyv * uv;
        }
      }
      __syncthreads();  // every warp's rows of dB and dC
      for (int e = tid; e < n * L; e += nthreads) {
        const int t = e / L, ss = e - t * L;
        if (ss >= st) continue;
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int ww = 0; ww < NW; ++ww) {
          sb += pdB[(ww * K + t) * L + ss];
          sc += pdC[(ww * K + t) * L + ss];
        }
        const long long off = (((long long)blockIdx.x * Bsz + b) * S + t0 + t) * st + ss;
        dBp[off] = first ? sb : dBp[off] + sb;  // this block's own slab
        dCp[off] = first ? sc : dCp[off] + sc;
      }
    }
    if (sl) dAp[((long long)b * di + d) * st + s] = dA_acc;
#pragma unroll
    for (int off = L / 2; off >= 1; off >>= 1) dD_acc += __shfl_xor_sync(0xffffffffu, dD_acc, off);
    if (live && s == 0) dDp[(long long)b * di + d] = dD_acc;
  }
}

template <typename TU>
int bwd_launch(const TU* u, const float* dt, const float* Bm, const float* Cm, const float* A,
               const float* D, const float* dy, const float* hck, TU* du, float* ddt,
               float* dBp, float* dCp, float* dAp, float* dDp, int Bsz, int S, int di, int st,
               int slabs, cudaStream_t stream) {
  auto kernel = selective_scan_bwd_kernel<TU>;
  const int bytes = (int)sizeof(float) * 2 * (kBwdChannels * kBwdLanes / 32) * kBwdSteps *
                    kBwdLanes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(slabs, Bsz);
  kernel<<<grid, kBwdChannels * kBwdLanes, bytes, stream>>>(u, dt, Bm, Cm, A, D, dy, hck, du,
                                                            ddt, dBp, dCp, dAp, dDp, Bsz, S,
                                                            di, st);
  return (int)cudaGetLastError();
}

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

// The forward with its two options: u_type 0 (float32) or 1 (bfloat16),
// and hck (not null: the states entering every ck_steps steps, [Bsz,
// ceil(S / ck_steps), di, st] float32, for selective_scan_bwd_launch, which
// takes ck_steps 32). A bfloat16 u or checkpoints take st <= 16 (the lanes
// selective_scan_launch picks there); the rest as selective_scan_launch.
extern "C" int selective_scan_fwd_launch(const void* u, const float* dt, const float* Bm,
                                         const float* Cm, const float* A, const float* D,
                                         float* y, float* hck, int Bsz, int S, int di, int st,
                                         int d_tile, int t_chunk, int u_type, int ck_steps,
                                         void* stream) {
  if (Bsz == 0 || S == 0 || di == 0) return 0;
  if (st < 1 || d_tile < 1 || t_chunk < 1 || u_type < 0 || u_type > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (u_type == 0 && hck == nullptr)
    return selective_scan_launch_lanes((const float*)u, dt, Bm, Cm, A, D, y, Bsz, S, di, st,
                                       d_tile, t_chunk, 0, stream);
  if (st > 16) return (int)cudaErrorInvalidValue;
  if (u_type == 0)
    return launch<kLanesSt16, 4, float>((const float*)u, dt, Bm, Cm, A, D, y, Bsz, S, di, st,
                                        d_tile, t_chunk, s, hck, ck_steps);
  return launch<kLanesSt16, 4, __nv_bfloat16>((const __nv_bfloat16*)u, dt, Bm, Cm, A, D, y, Bsz,
                                              S, di, st, d_tile, t_chunk, s, hck, ck_steps);
}

// The backward (see its note): st <= 16, the checkpoints hck of
// selective_scan_fwd_launch at ck_steps 32, u and du of u_type (0 float32,
// 1 bfloat16), dBp and dCp [slabs, Bsz, S, st], dAp [Bsz, di, st], dDp
// [Bsz, di]; slabs is the grid's first dimension (at least 1).
extern "C" int selective_scan_bwd_launch(const void* u, const float* dt, const float* Bm,
                                         const float* Cm, const float* A, const float* D,
                                         const float* dy, const float* hck, void* du,
                                         float* ddt, float* dBp, float* dCp, float* dAp,
                                         float* dDp, int Bsz, int S, int di, int st,
                                         int u_type, int slabs, void* stream) {
  if (Bsz == 0 || S == 0 || di == 0) return 0;
  if (st < 1 || st > kBwdLanes || slabs < 1 || u_type < 0 || u_type > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (u_type == 0)
    return bwd_launch<float>((const float*)u, dt, Bm, Cm, A, D, dy, hck, (float*)du, ddt, dBp,
                             dCp, dAp, dDp, Bsz, S, di, st, slabs, s);
  return bwd_launch<__nv_bfloat16>((const __nv_bfloat16*)u, dt, Bm, Cm, A, D, dy, hck,
                                   (__nv_bfloat16*)du, ddt, dBp, dCp, dAp, dDp, Bsz, S, di, st,
                                   slabs, s);
}
