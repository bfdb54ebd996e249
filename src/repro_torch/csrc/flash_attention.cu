// Flash attention forward: online-softmax attention, causal, sliding-window
// or bidirectional, with grouped kv heads read in place.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (body _kernel). For each batch b, query head h and
// query position i, with g = h / (H / KV) the kv head of h (what the JAX
// wrapper's jnp.repeat(k, H / KV, axis=2) gives, ops.py:27-28):
//   s_ij = (q_i * scale) . k_j            scale = 1/sqrt(hd)
//   s_ij = -1e30 where j >= S, or (causal) j > i, or (window > 0) |i - j| >= window
//   o_i  = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-30)
// Layout [B, S, heads, hd], contiguous; the output is in q's dtype, rounded
// to nearest even. Two kernels, chosen by the dtype:
//
//  * float32: flash_attention_f32, every product, sum and exp in float32
//    on the FMA units (expf, IEEE division), as the TPU kernel computes in
//    f32 (kernel.py:37-40,57). TF32 tensor-core products would round the
//    inputs to 10 bits and break the 2e-5 parity with the JAX package.
//  * bfloat16: flash_attention_bf16, on the tensor cores with
//    mma.sync.m16n8k16 (bf16 operands, float32 accumulators).
//
// The masked score is the finite sentinel -1e30 of kernel.py:21, not -inf.
// A row whose first kv tile is fully masked (a sliding window) then gets
// exp(0) = 1 terms, which the next tile wipes out through
// corr = exp(-1e30 - m) = 0, exactly as on the TPU; with -inf the same path
// would give exp(-inf - -inf) = NaN. Tiles that are masked for every row of
// a query tile (or, in the bf16 kernel, of a warp's 16 rows) are skipped:
// they would change nothing, since every row's own position is unmasked.
//
// What bounds it on an H100: operations. llama3.2-1b at S 2048 does 4*hd
// flops per unmasked (q, k) pair, 68.75 GFLOP, against about 84 MB moved:
// 0.07 ms for bfloat16 operands at the dense tensor-core peak (989 TFLOP/s).
// On the FMA units (67 TFLOP/s) the same flops take about 1 ms, which is
// why the bf16 path runs on the tensor cores.
//
// float32 design: one block of 256 threads per (q tile of 64 rows, head,
// batch); kv tiles of 64 rows staged through shared memory by a loop inside
// the block, which takes the place of the TPU's sequential kv grid
// dimension. Thread (ty, tx) of a 16 x 16 grid owns query rows
// 4*ty .. 4*ty+3: their scores against keys tx + 16*j (j < 4), their m and
// l, and their output columns tx + 16*c, all in registers; the
// probabilities go through shared memory to the P.V product.
//
// bfloat16 design (FlashAttention-2's shape, on mma.sync):
//  * A block takes one query tile of one (head, batch): 16 rows a warp, 4
//    or 8 warps (64 or 128 rows; q_rows of flash_attention_launch_tiles).
//    Q is copied once into shared memory and held as A fragments in
//    registers for the whole kv loop.
//  * K and V tiles of 64 rows stream through a ring of 2 stages with 16-byte
//    cp.async: the copy of tile j+1 is in flight while tile j multiplies.
//    Rows past S are zero-filled (cp.async src-size 0). Shared rows are
//    hd + 8 bf16 long (hd 80: 176 bytes), which keeps every row 16-byte
//    aligned and puts the 8 row addresses of each ldmatrix phase in 8
//    distinct 4-bank groups, so ldmatrix is conflict-free at every hd.
//  * S = Q.K^T from ldmatrix'd K fragments into float32 accumulators: a
//    product of two bf16 values is exact in float32, so only the sums
//    round. The scale is applied to the float32 scores after the product
//    (kernel.py:35 scales q in f32 before it; rounding q*scale to bf16 would
//    change the inputs at hd 80 and 128, where the scale is no power of
//    two), folded with log2(e) so that each exponential is one ex2 on the
//    special-function unit.
//  * Only a tile that crosses the causal diagonal, a window edge or the
//    ragged tail for a warp's rows gets the per-element mask.
//  * Online softmax on the accumulators: m, l and O in float32 registers;
//    row max and sum reduce over the 4 lanes of a quad (l only at the end).
//  * P.V keeps P at near float32 precision: each probability is split into
//    hi = bf16(p) and lo = bf16(p - hi), and both multiply the same V
//    fragments (ldmatrix .trans) into one float32 accumulator; the residual
//    |p - hi - lo| is at most 2^-17 p. The m16n8 accumulator layout of two
//    adjacent score tiles is the A layout of one k16 step, so P never goes
//    through shared memory. This costs 1.5x the MMA work of the function
//    (6*hd against 4*hd flops per pair); the bound counts the function's.
//  * Epilogue: O / max(l, 1e-30), rounded to bf16, staged through the
//    warp's own rows of the Q buffer and stored 16 bytes a thread.
//  Why mma.sync and not wgmma: wgmma needs its B operand (and, for the
//  fastest form, A) in shared memory in its own swizzled layout, fed by TMA
//  and mbarriers, with warpgroup-wide register fragments; P would have to
//  go through shared memory or the register-A form. mma.sync reaches the
//  tensor cores from the same registers the softmax works in. The FA3
//  shape (TMA, wgmma, warp specialisation) is later work.
//
// In both kernels the first query tiles launched are the last ones, which
// carry the most kv tiles under a causal mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;  // kv rows of a staged tile
constexpr float kNegInf = -1e30f;

// kv tiles [first, end) that any query row in [qa, qb] (inclusive) may see
__device__ __forceinline__ void kv_range(int qa, int qb, int S, int causal, int window,
                                         int* begin, int* end) {
  int k_begin = 0, k_end = S;
  if (causal) k_end = min(k_end, qb + 1);
  if (window > 0) {
    k_begin = max(0, qa - window + 1);
    if (!causal) k_end = min(k_end, qb + window);
  }
  *begin = (k_begin / BK) * BK;
  *end = k_end;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal, int window) {
  bool ok = kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && abs(qpos - kpos) < window;
  return ok;
}

// ------------------------------------------------------------ float32, FMA
constexpr int BQ32 = 64;         // query rows of a float32 block
constexpr int kThreads32 = 256;  // 16 x 16

template <int HD>
struct Tiles32 {
  static constexpr int QS = HD + 1;  // odd strides: conflict-free column reads
  static constexpr int KS = HD + 1;
  static constexpr int VS = HD;
  static constexpr int PS = BK + 1;
  static constexpr int kFloats = BQ32 * QS + BK * KS + BK * VS + BQ32 * PS;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// Two blocks an SM: without the minimum ptxas held hd 32 to 64 registers
// and spilled; with it every head dim fits in 108 or fewer, no spills.
template <int HD>
__global__ void __launch_bounds__(kThreads32, 2)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int S, int H, int KV,
                    int causal, int window, float scale) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int NC = HD / 16;  // output columns of a thread
  using L = Tiles32<HD>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ32 * L::QS;
  float* vs = ks + BK * L::KS;
  float* ps = vs + BK * L::VS;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * BQ32;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long q_row = (long long)H * HD, kv_row = (long long)KV * HD;
  const float* qb = q + (long long)b * S * q_row + (long long)h * HD;
  const float* kb = k + (long long)b * S * kv_row + (long long)g * HD;
  const float* vb = v + (long long)b * S * kv_row + (long long)g * HD;
  float* ob = o + (long long)b * S * q_row + (long long)h * HD;

  for (int e = tid; e < BQ32 * HD; e += kThreads32) {
    const int r = e / HD, d = e - r * HD, s = q0 + r;
    qs[r * L::QS + d] = s < S ? qb[s * q_row + d] * scale : 0.f;
  }

  int k_first, k_end;
  kv_range(q0, min(q0 + BQ32, S) - 1, S, causal, window, &k_first, &k_end);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_first; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's reads of ks, vs, ps are done
    for (int e = tid; e < BK * HD; e += kThreads32) {
      const int r = e / HD, d = e - r * HD, s = k0 + r;
      const bool in = s < S;
      ks[r * L::KS + d] = in ? kb[s * kv_row + d] : 0.f;
      vs[r * L::VS + d] = in ? vb[s * kv_row + d] : 0.f;
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
        if (!visible(qpos, k0 + tx + 16 * j, S, causal, window)) sc[i][j] = kNegInf;
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
    for (int c = 0; c < NC; ++c) ob[qpos * q_row + tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
               int KV, int causal, int window, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_f32<HD>;
  const int bytes = (int)Tiles32<HD>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ32 - 1) / BQ32, H, B);
  kernel<<<grid, kThreads32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, causal, window, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bfloat16, mma.sync
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; bytes < 16 zero-fills the rest (0: all zero)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; results below 2^-126 flush to 0, far
// under the float32 rounding of a row sum whose largest term is 1
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as bf16x2, round to nearest even; x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// p (two adjacent columns) as hi + lo bf16 pairs
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t* hi, uint32_t* lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  *hi = *reinterpret_cast<uint32_t*>(&h);
  *lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

template <int HD, int NW>
struct TilesBf16 {
  static constexpr int BQ = 16 * NW;   // query rows of a block
  static constexpr int LD = HD + 8;    // bf16 a shared row: 16-byte aligned, no conflicts
  static constexpr int kElems = BQ * LD + 2 * 2 * BK * LD;  // Q, then 2 stages of K and V
  static constexpr size_t kBytes = sizeof(bf16) * kElems;
};

// A minimum of one block an SM leaves ptxas free to spend registers (234 at
// hd 128), which ran faster on the card than its own choice (PERF.md).
template <int HD, int NW>
__global__ void __launch_bounds__(NW * 32, 1)
flash_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H, int KV,
                     int causal, int window, float scale_log2) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  using T = TilesBf16<HD, NW>;
  constexpr int BQ = T::BQ, LD = T::LD, THREADS = NW * 32;
  constexpr int CH = HD / 8;      // 16-byte chunks of a row
  constexpr int KS = HD / 16;     // k16 steps of Q.K^T
  constexpr int NS = BK / 8;      // n8 tiles of a score tile
  constexpr int NO = HD / 8;      // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]; the output later
  bf16* kvs = qs + BQ * LD;                       // [stage][K, V][BK][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // row in an 8-row group, column pair
  const int wq0 = q0 + warp * 16;           // this warp's first query row
  const long long q_row = (long long)H * HD, kv_row = (long long)KV * HD;
  const bf16* qb = q + (long long)b * S * q_row + (long long)h * HD;
  const bf16* kb = k + (long long)b * S * kv_row + (long long)g * HD;
  const bf16* vb = v + (long long)b * S * kv_row + (long long)g * HD;
  bf16* ob = o + (long long)b * S * q_row + (long long)h * HD;

  auto load_kv = [&](int stage, int k0) {
    bf16* kd = kvs + stage * 2 * BK * LD;
    bf16* vd = kd + BK * LD;
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH, col = (c - r * CH) * 8, s = k0 + r;
      const bool in = s < S;
      const long long off = in ? (long long)s * kv_row + col : 0;
      cp_async16(kd + r * LD + col, kb + off, in ? 16 : 0);
      cp_async16(vd + r * LD + col, vb + off, in ? 16 : 0);
    }
  };

  int k_first, k_end;
  kv_range(q0, min(q0 + BQ, S) - 1, S, causal, window, &k_first, &k_end);
  const int n_tiles = (k_end - k_first + BK - 1) / BK;

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, col = (c - r * CH) * 8, s = q0 + r;
    const bool in = s < S;
    cp_async16(qs + r * LD + col, qb + (in ? (long long)s * q_row + col : 0), in ? 16 : 0);
  }
  load_kv(0, k_first);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q as A fragments: rows wq0 + (lane & 15), columns 16*kk + 8*(lane >> 4)
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  // this thread's rows: wq0 + gq (accumulator elements 0, 1) and + 8 (2, 3)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  const int w_last = wq0 + 15;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_first + it * BK;
    if (it + 1 < n_tiles) load_kv((it + 1) & 1, k0 + BK);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile it have landed
    __syncthreads();     // and everyone's

    // masked for all 16 rows of the warp, or rows all past S: nothing to add
    const bool skip = wq0 >= S || (causal && k0 > w_last) ||
                      (window > 0 && (wq0 - (k0 + BK - 1) >= window ||
                                      k0 - w_last >= window));
    if (!skip) {
      const bf16* ksm = kvs + (it & 1) * 2 * BK * LD;
      const bf16* vsm = ksm + BK * LD;

      float sacc[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          // K rows 16np + (lane & 7) + 8*(lane >> 4), columns 16kk + 8*((lane >> 3) & 1):
          // b0, b1 of score tile 2np, then of 2np + 1
          uint32_t kf[4];
          ldmatrix_x4(kf, ksm + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                              (((lane >> 3) & 1) << 3));
          mma_bf16(sacc[2 * np], qf[kk], kf[0], kf[1]);
          mma_bf16(sacc[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
      }

#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] *= scale_log2;
      // the per-element mask, only where the tile crosses the ragged tail,
      // the diagonal or a window edge for some row of the warp
      if (k0 + BK > S || (causal && k0 + BK - 1 > wq0) ||
          (window > 0 && (w_last - k0 >= window || k0 + BK - 1 - wq0 >= window))) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible(wq0 + gq + (e >> 1) * 8, k0 + n * 8 + 2 * tq + (e & 1), S, causal,
                         window))
              sacc[n][e] = kNegInf;
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sacc[n][e]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2_ftz(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] *= corr[e >> 1];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_ftz(sacc[n][e] - m[e >> 1]);
          sacc[n][e] = p;
          l[e >> 1] += p;
        }

      // O += (P_hi + P_lo) V, one k16 step per pair of score tiles
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(sacc[2 * kk][0], sacc[2 * kk][1], &ph[0], &pl[0]);
        split_bf16(sacc[2 * kk][2], sacc[2 * kk][3], &ph[1], &pl[1]);
        split_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], &ph[2], &pl[2]);
        split_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], &ph[3], &pl[3]);
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          // V rows 16kk + (lane & 7) + 8*((lane >> 3) & 1), columns 16np + 8*(lane >> 4),
          // transposed: b0, b1 of output tile 2np, then of 2np + 1
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vsm + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                                    np * 16 + ((lane >> 4) << 3));
          mma_bf16(oacc[2 * np], ph, vf[0], vf[1]);
          mma_bf16(oacc[2 * np], pl, vf[0], vf[1]);
          mma_bf16(oacc[2 * np + 1], ph, vf[2], vf[3]);
          mma_bf16(oacc[2 * np + 1], pl, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // everyone is done with this stage before it is refilled
  }

  // epilogue: the quad's partial sums, O / max(l, 1e-30) in the warp's own
  // rows of the Q buffer, then 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  bf16* os = qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(os + (gq + 8 * r) * LD + n * 8 + 2 * tq) =
          pack_bf16(oacc[n][2 * r] / l[r], oacc[n][2 * r + 1] / l[r]);
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, col = (c - r * CH) * 8, s = wq0 + r;
    if (s < S)
      *reinterpret_cast<uint4*>(ob + (long long)s * q_row + col) =
          *reinterpret_cast<const uint4*>(os + r * LD + col);
  }
}

template <int HD, int NW>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int KV, int causal, int window, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_bf16<HD, NW>;
  const int bytes = (int)TilesBf16<HD, NW>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int BQ = TilesBf16<HD, NW>::BQ;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NW * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, H, KV, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// query rows of a bfloat16 block that flash_attention_launch uses
constexpr int kBf16QRows = 64;

}  // namespace

// As flash_attention_launch, with the query rows of a bfloat16 block given:
// 64 (4 warps) or 128 (8 warps). float32 takes 64 only.
extern "C" int flash_attention_launch_tiles(const void* q, const void* k, const void* v,
                                            void* o, int dtype, int B, int S, int H, int KV,
                                            int hd, int causal, int window, float scale,
                                            int q_rows, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // the head dims of the registered configs (HEAD_DIMS of
  // repro_torch/kernels/flash_attention/ops.py; hubert-xlarge's 80 is not a
  // power of two)
  if (dtype == 0 && q_rows == BQ32) {
    switch (hd) {
#define FA_CASE(D) \
  case D: return launch_f32<D>(q, k, v, o, B, S, H, KV, causal, window, scale, s);
      FA_CASE(32) FA_CASE(64) FA_CASE(80) FA_CASE(128)
#undef FA_CASE
    }
  } else if (dtype == 1 && (q_rows == 64 || q_rows == 128)) {
    switch (hd) {
#define FA_CASE(D)                                                                          \
  case D:                                                                                   \
    return q_rows == 64                                                                     \
               ? launch_bf16<D, 4>(q, k, v, o, B, S, H, KV, causal, window, scale, s)      \
               : launch_bf16<D, 8>(q, k, v, o, B, S, H, KV, causal, window, scale, s);
      FA_CASE(32) FA_CASE(64) FA_CASE(80) FA_CASE(128)
#undef FA_CASE
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for a head_dim or dtype it was not compiled for). dtype: 0 float32 (64
// query rows a block), 1 bfloat16 (kBf16QRows). q and o are [B, S, H, hd];
// k and v [B, S, KV, hd].
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int B, int S, int H, int KV, int hd,
                                      int causal, int window, float scale, void* stream) {
  return flash_attention_launch_tiles(q, k, v, o, dtype, B, S, H, KV, hd, causal, window,
                                      scale, dtype == 0 ? BQ32 : kBf16QRows, stream);
}
