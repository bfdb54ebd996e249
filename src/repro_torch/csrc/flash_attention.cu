// Flash attention forward: online-softmax attention, causal, sliding-window
// or bidirectional, with grouped kv heads read in place.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (body _kernel). For each batch b, query head h and
// query position i, with g = h / (H / KV) the kv head of h (what the JAX
// wrapper's jnp.repeat(k, H / KV, axis=2) gives, ops.py:27-28):
//   s_ij = (q_i * scale) . k_j            scale = 1/sqrt(hd), applied to q in f32
//   s_ij = -1e30 where j >= S, or (causal) j > i, or (window > 0) |i - j| >= window
//   o_i  = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-30)
// Inputs are read in their own dtype (float32 or bfloat16) and turned into
// float32 on load; every product, sum and exp is float32 (expf,
// IEEE division), as in the TPU kernel; the output is written in q's dtype,
// rounded to nearest even. Layout [B, S, heads, hd], contiguous.
//
// The masked score is the finite sentinel -1e30 of kernel.py:21, not -inf.
// A row whose first kv tile is fully masked (a sliding window) then gets
// exp(0) = 1 terms, which the next tile wipes out through
// corr = exp(-1e30 - m) = 0, exactly as on the TPU; with -inf the same path
// would give exp(-inf - -inf) = NaN. Tiles that are masked for every row of
// the query tile are skipped: they would change nothing.
//
// What bounds it on an H100: at the LM configs' widths, operations. llama3.2-1b
// at S 2048 does 4*hd flops per unmasked (q, k) pair, 68.75 GFLOP, against
// about 84 MB moved: 0.07 ms for bfloat16 operands at the dense tensor-core
// peak (989 TFLOP/s). This kernel multiplies on the float32 FMA units, as
// the TPU kernel multiplies in f32 (kernel.py:37-40,57): at their 67 TFLOP/s
// peak the same flops take about 1 ms.
//
// Design: one block of 256 threads per (q tile of 64 rows, head, batch); the
// kv tiles of 64 rows are staged through shared memory by a loop inside the
// block, which takes the place of the TPU's sequential kv grid dimension.
// Thread (ty, tx) of a 16 x 16 grid owns query rows 4*ty .. 4*ty+3: their
// scores against keys tx + 16*j (j < 4), their running max m and sum l, and
// their output columns tx + 16*c (c < hd/16), all in float32 registers. Row
// maxima and sums reduce over the 16 threads of a row group with shuffles.
// The probabilities go through shared memory to the P.V product. Shared
// rows of q and k are padded to an odd stride, so the column reads of the
// 16 threads of a half-warp hit 16 banks. No tensor cores: wgmma and TMA are
// later work. The first query tiles launched are the last ones, which carry
// the most kv tiles under a causal mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows of a block
constexpr int BK = 64;        // kv rows of a staged tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
struct Tiles {
  static constexpr int QS = HD + 1;  // odd strides: conflict-free column reads
  static constexpr int KS = HD + 1;
  static constexpr int VS = HD;
  static constexpr int PS = BK + 1;
  static constexpr int kFloats = BQ * QS + BK * KS + BK * VS + BQ * PS;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int H,
                       int KV, int causal, int window, float scale) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int NC = HD / 16;  // output columns of a thread
  using L = Tiles<HD>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * L::QS;
  float* vs = ks + BK * L::KS;
  float* ps = vs + BK * L::VS;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long q_row = (long long)H * HD, kv_row = (long long)KV * HD;
  const T* qb = q + (long long)b * S * q_row + (long long)h * HD;
  const T* kb = k + (long long)b * S * kv_row + (long long)g * HD;
  const T* vb = v + (long long)b * S * kv_row + (long long)g * HD;
  T* ob = o + (long long)b * S * q_row + (long long)h * HD;

  for (int e = tid; e < BQ * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD, s = q0 + r;
    qs[r * L::QS + d] = s < S ? to_f32(qb[s * q_row + d]) * scale : 0.f;
  }

  // kv positions any row of this tile may see
  const int q_last = min(q0 + BQ, S) - 1;
  int k_begin = 0, k_end = S;
  if (causal) k_end = min(k_end, q_last + 1);
  if (window > 0) {
    k_begin = max(0, q0 - window + 1);
    if (!causal) k_end = min(k_end, q_last + window);
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's reads of ks, vs, ps are done
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int r = e / HD, d = e - r * HD, s = k0 + r;
      const bool in = s < S;
      ks[r * L::KS + d] = in ? to_f32(kb[s * kv_row + d]) : 0.f;
      vs[r * L::VS + d] = in ? to_f32(vb[s * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * L::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && abs(qpos - kpos) < window;
        if (!ok) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        ps[(4 * ty + i) * L::PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // every row's probabilities are in ps

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * L::PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[kk * L::VS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[qpos * q_row + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           int KV, int causal, int window, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  const int bytes = (int)Tiles<HD>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KV, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, int causal, int window, float scale,
                cudaStream_t stream) {
  // HEAD_DIMS of repro_torch/kernels/flash_attention/ops.py: the head dims
  // of the registered configs (hubert-xlarge's 80 is not a power of two)
  switch (hd) {
#define FA_CASE(D) \
  case D: return launch<T, D>(q, k, v, o, B, S, H, KV, causal, window, scale, stream);
    FA_CASE(32) FA_CASE(64) FA_CASE(80) FA_CASE(128)
#undef FA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for a head_dim or dtype it was not compiled for). dtype: 0 float32,
// 1 bfloat16. q and o are [B, S, H, hd]; k and v [B, S, KV, hd].
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int dtype, int B, int S, int H, int KV,
                                      int hd, int causal, int window, float scale,
                                      void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return dispatch_hd<float>(hd, q, k, v, o, B, S, H, KV, causal, window, scale, s);
    case 1:
      return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, H, KV, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
