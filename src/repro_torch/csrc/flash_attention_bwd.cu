// Flash attention backward for Hopper (sm_90a), CUDA C++: two variants of two kernels.
//
// The JAX package has no backward kernel: its Pallas kernel
// src/repro/kernels/flash_attention.py (_flash_kernel, launched by
// flash_attention_bhsd through pl.pallas_call) is forward-only and JAX trains
// on the XLA path. The port trains through its forward kernel
// (csrc/flash_attention.cu), so the gradient of that kernel is a kernel too.
// It computes the gradient of exactly what the forward computes: softmax
// attention over keys counted from 0 (no end-alignment when S < T) with the
// kv-padding mask k < T, the causal mask k <= q and the sliding mask
// q - k < window, GQA (q-head h reads kv-head h / (Hq / Hkv)), f32 sums, and
// dq, dk, dv written in q's dtype through strides in the model's (B, S, H, D)
// layout. Its plain version is ref.attention_bwd_ref:
//
//   s = q k^T / sqrt(D) (masked), lse = logsumexp_k(s), P = exp(s - lse),
//   Dr = rowsum(dO * O), dP = dO V^T, dS = P * (dP - Dr),
//   dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), dV = P^T dO,
//
// dK and dV summed over the q-heads of each kv group. O is the forward's
// output as stored; the row statistics are not stored by the forward (its
// kernels stay as they are), so they are recomputed here by a pass over K.
//
// What bounds it on the H100: operations, as the forward (~2.5 x its work:
// five products of S x T x D per head against the forward's two). Two
// variants, picked by dtype and head dim alone (kernels/flash_attention.py
// bwd_variant), each a pair of kernels, all deterministic (no atomics):
//
// The mma variant (bf16 at D in {16, 64, 128}: the models' training path)
// runs the five products on the tensor cores with mma.sync m16n8k16 (bf16
// operands, f32 sums), four warps a block, each warp 16 rows of the block's
// own tile; tiles are staged in shared memory as they are and, where a
// product reads them along the other axis, transposed, so every fragment is
// one 32-bit load (rows padded by 8 bf16: the 8 rows of a fragment load hit
// distinct banks). P and dS enter the next product from the accumulator
// registers, rounded to bf16 as the operand type requires. It is simple, not
// pipelined: no TMA, no wgmma, no overlap of loads with products (a later
// redesign).
//
//   * flash_bwd_dq_mma_kernel, one block per (b, q-head, 64 query rows):
//     Dr, then the row statistics from S = Q K^T over the visible 64-key
//     tiles (lse to scratch), then S and dP = dO V^T again for P and dS, and
//     dQ += dS K with dQ in registers;
//   * flash_bwd_dkdv_mma_kernel, one block per (b, kv-head, 64 keys): K and V
//     stay in shared memory while the block walks the group's q-heads and the
//     32-row q tiles that see its keys: S^T = K Q^T and dP^T = V dO^T, P^T and
//     dS^T from the scratch lse and Dr, dV += P^T dO and dK += dS^T Q.
//
// The FMA variant (f32 at any D, bf16 at D = 8 and 256) is the first kernel
// written, built to be right and simple: f32 FMAs out of shared memory, so
// shared-memory bandwidth is its limit, as for the forward's FMA kernel:
//
//   * flash_bwd_dq_kernel, one block per (b, q-head, BLOCK query rows),
//     TPR threads a row: Dr from dO and O; a pass over the visible K tiles
//     for the row max and sum (lse, written to a scratch row for the second
//     kernel; a row with no visible key gets lse = +inf, so its P is 0);
//     then a pass over the K/V tiles for P, dP and dS, dS staged in shared
//     memory and multiplied by K into dQ, which lives in registers;
//   * flash_bwd_dkdv_kernel, one block per (b, kv-head, BLOCK keys), TPR
//     threads a key: K and V tiles stay in shared memory while the block
//     walks the q-heads of its group and the q tiles that can see its keys,
//     recomputing P and dS from the staged Q and dO tiles and the scratch
//     lse and Dr; dK and dV live in registers, so each is written once.
//
// Shared-memory rows are padded by one float, so the TPR threads of a row and
// the rows of a warp hit distinct banks. D = 256 takes tiles of 32 and 8
// threads a row, the other head dims tiles of 64 and 4 threads a row; every
// block has 256 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -1.0e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  int64_t b, s, h;
};

template <int D>
struct Tile {
  static constexpr int TPR = D >= 256 ? 8 : 4;      // threads a row (a query row, or a key)
  static constexpr int BLOCK = D >= 256 ? 32 : 64;  // rows of a block's own tile and of the tiles it walks
  static constexpr int THREADS = BLOCK * TPR;       // 256
  static constexpr int PER = BLOCK / TPR;           // rows of the other tile a thread takes: 16 or 4
  static constexpr int COLS = D / TPR;              // output columns a thread holds
  static constexpr int LD = D + 1;                  // padded row of a staged tile
  static constexpr int LP = BLOCK + 1;              // padded row of P or dS
  static constexpr size_t DQ_SMEM = sizeof(float) * (4 * BLOCK * LD + BLOCK * LP);
  static constexpr size_t DKDV_SMEM = sizeof(float) * (4 * BLOCK * LD + 2 * BLOCK * LP + 2 * BLOCK);
};

// Sum (or max) over the TPR consecutive lanes of a row.
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
template <int TPR>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ bool visible(int qi, int kk, int S, int T_len, int causal, int window) {
  bool ok = qi < S && kk < T_len;
  if (causal) ok = ok && kk <= qi;
  if (window > 0) ok = ok && (qi - kk) < window;
  return ok;
}

// Stage rows [r0, r0 + BLOCK) of one head of a (B, S, H, D) tensor into a
// padded f32 tile, zeros past n.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t row_stride, int r0, int n) {
  using C = Tile<D>;
  for (int idx = threadIdx.x; idx < C::BLOCK * D; idx += C::THREADS) {
    const int row = idx / D, d = idx % D;
    const int rr = r0 + row;
    dst[row * C::LD + d] = rr < n ? to_float(src[rr * row_stride + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ lse_out, float* __restrict__ dr_out,
    int S, int T_len, int Hq, int Hkv, int causal, int window, Strides qs, Strides ks, Strides vs, Strides os,
    Strides dos, Strides dqs, float scale) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BLOCK][LD]
  float* dOs = Qs + C::BLOCK * C::LD;
  float* Ks = dOs + C::BLOCK * C::LD;
  float* Vs = Ks + C::BLOCK * C::LD;
  float* dSs = Vs + C::BLOCK * C::LD;  // [BLOCK][LP]

  const int tid = threadIdx.x;
  const int r = tid / C::TPR;
  const int sub = tid % C::TPR;
  const int q0 = blockIdx.x * C::BLOCK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int qi = q0 + r;

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  stage<T, D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  stage<T, D>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, S);
  __syncthreads();

  // Dr = rowsum(dO * O) over the stored output
  float dr = 0.f;
  if (qi < S) {
    const T* orow = o + b * os.b + qi * os.s + h * os.h;
    for (int d = sub; d < D; d += C::TPR) dr = fmaf(dOs[r * C::LD + d], to_float(orow[d]), dr);
  }
  dr = row_sum<C::TPR>(dr);

  // kv range that any row of this tile can see (as the forward)
  const int q_last = min(q0 + C::BLOCK, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;
  const int k_first = (k_begin / C::BLOCK) * C::BLOCK;

  // pass 1: the row max and sum -> lse
  float m = NEG_INF, l = 0.f;
  for (int k0 = k_first; k0 < k_end; k0 += C::BLOCK) {
    __syncthreads();
    stage<T, D>(Ks, kb, ks.s, k0, T_len);
    __syncthreads();
    float s[C::PER];
#pragma unroll
    for (int i = 0; i < C::PER; ++i) s[i] = 0.f;
    const float* qrow = Qs + r * C::LD;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int i = 0; i < C::PER; ++i) s[i] = fmaf(qd, Ks[(sub + C::TPR * i) * C::LD + d], s[i]);
    }
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < C::PER; ++i) {
      s[i] = visible(qi, k0 + sub + C::TPR * i, S, T_len, causal, window) ? s[i] * scale : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    mx = row_max<C::TPR>(mx);
    const float m_new = fmaxf(m, mx);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < C::PER; ++i) psum += s[i] > NEG_INF ? expf(s[i] - m_new) : 0.f;
    psum = row_sum<C::TPR>(psum);
    l = l * expf(m - m_new) + psum;
    m = m_new;
  }
  const float lse = l > 0.f ? m + logf(l) : INFINITY;  // no visible key: P = 0
  if (qi < S && sub == 0) {
    const int64_t row = ((int64_t)b * Hq + h) * S + qi;
    lse_out[row] = lse;
    dr_out[row] = dr;
  }

  // pass 2: P, dP, dS -> dQ = dS K * scale
  float acc[C::COLS];
#pragma unroll
  for (int c = 0; c < C::COLS; ++c) acc[c] = 0.f;
  for (int k0 = k_first; k0 < k_end; k0 += C::BLOCK) {
    __syncthreads();
    stage<T, D>(Ks, kb, ks.s, k0, T_len);
    stage<T, D>(Vs, vb, vs.s, k0, T_len);
    __syncthreads();
    float s[C::PER], dp[C::PER];
#pragma unroll
    for (int i = 0; i < C::PER; ++i) s[i] = dp[i] = 0.f;
    const float* qrow = Qs + r * C::LD;
    const float* dorow = dOs + r * C::LD;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d], dod = dorow[d];
#pragma unroll
      for (int i = 0; i < C::PER; ++i) {
        const int j = (sub + C::TPR * i) * C::LD + d;
        s[i] = fmaf(qd, Ks[j], s[i]);
        dp[i] = fmaf(dod, Vs[j], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < C::PER; ++i) {
      const int j = sub + C::TPR * i;
      const float p = visible(qi, k0 + j, S, T_len, causal, window) ? expf(s[i] * scale - lse) : 0.f;
      dSs[r * C::LP + j] = p * (dp[i] - dr);
    }
    __syncwarp();  // a row's dS is written by the TPR lanes of one warp
    const float* dsrow = dSs + r * C::LP;
#pragma unroll 2
    for (int j = 0; j < C::BLOCK; ++j) {
      const float ds = dsrow[j];
      const float* krow = Ks + j * C::LD + sub;
#pragma unroll
      for (int c = 0; c < C::COLS; ++c) acc[c] = fmaf(ds, krow[C::TPR * c], acc[c]);
    }
  }
  if (qi < S) {
    T* out = dq + b * dqs.b + qi * dqs.s + h * dqs.h;
#pragma unroll
    for (int c = 0; c < C::COLS; ++c) from_float(out + sub + C::TPR * c, acc[c] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::THREADS) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse_in, const float* __restrict__ dr_in, T* __restrict__ dk, T* __restrict__ dv,
    int S, int T_len, int Hq, int Hkv, int causal, int window, Strides qs, Strides ks, Strides vs, Strides dos,
    Strides dks, Strides dvs, float scale) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* Ks = smem;  // [BLOCK][LD]
  float* Vs = Ks + C::BLOCK * C::LD;
  float* Qs = Vs + C::BLOCK * C::LD;
  float* dOs = Qs + C::BLOCK * C::LD;
  float* Ps = dOs + C::BLOCK * C::LD;  // [BLOCK keys][LP]
  float* dSs = Ps + C::BLOCK * C::LP;
  float* lse_s = dSs + C::BLOCK * C::LP;  // [BLOCK]
  float* dr_s = lse_s + C::BLOCK;

  const int tid = threadIdx.x;
  const int r = tid / C::TPR;
  const int sub = tid % C::TPR;
  const int k0 = blockIdx.x * C::BLOCK;  // key tile 0 first: under a causal mask it sees the most q tiles
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int kk = k0 + r;

  stage<T, D>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, T_len);
  stage<T, D>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, T_len);

  // q range that can see any key of this tile
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + C::BLOCK - 1 + window) : S;
  const int q_first = (q_begin / C::BLOCK) * C::BLOCK;

  float acc_k[C::COLS], acc_v[C::COLS];
#pragma unroll
  for (int c = 0; c < C::COLS; ++c) acc_k[c] = acc_v[c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    const int64_t stat0 = ((int64_t)b * Hq + h) * S;
    for (int q0 = q_first; q0 < q_end; q0 += C::BLOCK) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      stage<T, D>(Qs, qb, qs.s, q0, S);
      stage<T, D>(dOs, dob, dos.s, q0, S);
      for (int j = tid; j < C::BLOCK; j += C::THREADS) {
        const bool in = q0 + j < S;
        lse_s[j] = in ? lse_in[stat0 + q0 + j] : INFINITY;
        dr_s[j] = in ? dr_in[stat0 + q0 + j] : 0.f;
      }
      __syncthreads();
      float s[C::PER], dp[C::PER];
#pragma unroll
      for (int i = 0; i < C::PER; ++i) s[i] = dp[i] = 0.f;
      const float* krow = Ks + r * C::LD;
      const float* vrow = Vs + r * C::LD;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kd = krow[d], vd = vrow[d];
#pragma unroll
        for (int i = 0; i < C::PER; ++i) {
          const int j = (sub + C::TPR * i) * C::LD + d;
          s[i] = fmaf(Qs[j], kd, s[i]);
          dp[i] = fmaf(dOs[j], vd, dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < C::PER; ++i) {
        const int j = sub + C::TPR * i;
        const float p = visible(q0 + j, kk, S, T_len, causal, window) ? expf(s[i] * scale - lse_s[j]) : 0.f;
        Ps[r * C::LP + j] = p;
        dSs[r * C::LP + j] = p * (dp[i] - dr_s[j]);
      }
      __syncwarp();  // a key's P and dS are written by the TPR lanes of one warp
      const float* prow = Ps + r * C::LP;
      const float* dsrow = dSs + r * C::LP;
#pragma unroll 2
      for (int j = 0; j < C::BLOCK; ++j) {
        const float p = prow[j], ds = dsrow[j];
        const float* qrow = Qs + j * C::LD + sub;
        const float* dorow = dOs + j * C::LD + sub;
#pragma unroll
        for (int c = 0; c < C::COLS; ++c) {
          acc_v[c] = fmaf(p, dorow[C::TPR * c], acc_v[c]);
          acc_k[c] = fmaf(ds, qrow[C::TPR * c], acc_k[c]);
        }
      }
    }
  }
  if (kk < T_len) {
    T* ok = dk + b * dks.b + kk * dks.s + hk * dks.h;
    T* ov = dv + b * dvs.b + kk * dvs.s + hk * dvs.h;
#pragma unroll
    for (int c = 0; c < C::COLS; ++c) {
      from_float(ok + sub + C::TPR * c, acc_k[c] * scale);
      from_float(ov + sub + C::TPR * c, acc_v[c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *dr;
  int B, S, T_len, Hq, Hkv, causal, window;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Tile<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::DQ_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::DKDV_SMEM);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));  // as the forward
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k), *v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  dim3 grid_q((a.S + C::BLOCK - 1) / C::BLOCK, a.Hq, a.B);
  flash_bwd_dq_kernel<T, D><<<grid_q, C::THREADS, C::DQ_SMEM, stream>>>(
      q, k, v, static_cast<const T*>(a.o), dout, static_cast<T*>(a.dq), a.lse, a.dr, a.S, a.T_len, a.Hq, a.Hkv,
      a.causal, a.window, a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_k((a.T_len + C::BLOCK - 1) / C::BLOCK, a.Hkv, a.B);
  flash_bwd_dkdv_kernel<T, D><<<grid_k, C::THREADS, C::DKDV_SMEM, stream>>>(
      q, k, v, dout, a.lse, a.dr, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.T_len, a.Hq, a.Hkv,
      a.causal, a.window, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(a, stream);
    case 16: return launch<T, 16>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// The mma variant: bf16, D in {16, 64, 128}
// ---------------------------------------------------------------------------

namespace mma_bwd {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;  // four warps
constexpr int BQ = 64;        // dq kernel: query rows of a block, 16 a warp
constexpr int BK = 64;        // keys of a dkdv block (16 a warp) and of the tiles the dq kernel walks
constexpr int BQ2 = 32;       // query rows of the tiles the dkdv kernel walks
constexpr int PAD = 8;        // bf16 of padding a staged row

template <int D>
struct Smem {
  static constexpr int LD = D + PAD;     // row-major tiles
  static constexpr int LDT_K = BK + PAD;  // K^T in the dq kernel
  static constexpr int LDT_Q = BQ2 + PAD;  // Q^T and dO^T in the dkdv kernel
  static constexpr size_t DQ = sizeof(bf16) * (2 * BQ * LD + 2 * BK * LD + D * LDT_K) + sizeof(float) * BQ;
  static constexpr size_t DKDV = sizeof(bf16) * (2 * BK * LD + 2 * BQ2 * LD + 2 * D * LDT_Q) + sizeof(float) * 2 * BQ2;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b: m16n8k16, A row-major, B column-major, bf16 in, f32 sums
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows [r0, r0 + 16) x columns [k0, k0 + 16) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* t, int ld, int r0, int k0, int gid, int tig) {
  const bf16* p = t + (r0 + gid) * ld + k0 + 2 * tig;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// The B fragment of k in [k0, k0 + 16) x n in [n0, n0 + 8) where B[k][n] = t[n][k].
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* t, int ld, int n0, int k0, int gid, int tig) {
  const bf16* p = t + (n0 + gid) * ld + k0 + 2 * tig;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// The accumulators of n-tiles 2j and 2j + 1 (16 x 16) as the A fragment of
// the next product, whose k axis is their n axis.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// Stage rows [r0, r0 + R) of one head (row stride rs) into t[R][D + PAD], and
// its transpose into tt[D][R + PAD] when TRANS; zeros past n. 16-byte loads:
// the wrapper has checked that the head's base is 16-byte aligned and every
// stride a multiple of 8 elements.
template <int D, int R, bool TRANS>
__device__ __forceinline__ void stage(bf16* t, bf16* tt, const bf16* src, int64_t rs, int r0, int n) {
  constexpr int V = D / 8;
  for (int idx = threadIdx.x; idx < R * V; idx += THREADS) {
    const int row = idx / V, c = (idx % V) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < n) v = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + row) * rs + c);
    *reinterpret_cast<uint4*>(t + row * (D + PAD) + c) = v;
    if (TRANS) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) tt[(c + j) * (R + PAD) + row] = e[j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, const bf16* __restrict__ o,
    const bf16* __restrict__ dout, bf16* __restrict__ dq, float* __restrict__ lse_out, float* __restrict__ dr_out,
    int S, int T_len, int Hq, int Hkv, int causal, int window, Strides qs, Strides ks, Strides vs, Strides os,
    Strides dos, Strides dqs, float scale) {
  using M = Smem<D>;
  constexpr int LD = M::LD, LDT = M::LDT_K, KB = D / 16, NT = BK / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;                       // [BK][LD]
  bf16* Vs = Ks + BK * LD;
  bf16* KTs = Vs + BK * LD;                       // [D][LDT]
  float* dr_s = reinterpret_cast<float*>(KTs + D * LDT);  // [BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int rloc[2] = {16 * warp + gid, 16 * warp + gid + 8};  // this thread's two rows in the tile
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  stage<D, BQ, false>(Qs, nullptr, q + b * qs.b + h * qs.h, qs.s, q0, S);
  stage<D, BQ, false>(dOs, nullptr, dout + b * dos.b + h * dos.h, dos.s, q0, S);
  __syncthreads();
  {  // Dr = rowsum(dO * O), two threads a row
    const int row = threadIdx.x / 2, half = threadIdx.x % 2;
    float acc = 0.f;
    if (q0 + row < S) {
      const bf16* orow = o + b * os.b + (int64_t)(q0 + row) * os.s + h * os.h;
      for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
        acc = fmaf(__bfloat162float(dOs[row * LD + d]), __bfloat162float(orow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) dr_s[row] = acc;
  }
  __syncthreads();  // each thread reads other rows' Dr below, even when no key tile is visible

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;
  const int k_first = (k_begin / BK) * BK;

  // pass 1: the row max and sum -> lse
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  for (int k0 = k_first; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage<D, BK, false>(Ks, nullptr, kb, ks.s, k0, T_len);
    __syncthreads();
    float s[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      uint32_t a[4];
      load_a(a, Qs, LD, 16 * warp, 16 * kk, gid, tig);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bb[2];
        load_b(bb, Ks, LD, 8 * nt, 16 * kk, gid, tig);
        mma(s[nt], a, bb);
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 8 * nt + 2 * tig + (i & 1);
        s[nt][i] = visible(q0 + rloc[i >> 1], key, S, T_len, causal, window) ? s[nt][i] * scale : NEG_INF;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = row_max<4>(mx[r]);
      const float m_new = fmaxf(m[r], mx[r]);
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 2 * r; i < 2 * r + 2; ++i) psum += s[nt][i] > NEG_INF ? expf(s[nt][i] - m_new) : 0.f;
      psum = row_sum<4>(psum);
      l[r] = l[r] * expf(m[r] - m_new) + psum;
      m[r] = m_new;
    }
  }
  float lse[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;  // no visible key: P = 0
    dr[r] = dr_s[rloc[r]];
    const int qi = q0 + rloc[r];
    if (qi < S && tig == 0) {
      const int64_t row = ((int64_t)b * Hq + h) * S + qi;
      lse_out[row] = lse[r];
      dr_out[row] = dr[r];
    }
  }

  // pass 2: P, dP, dS -> dQ = dS K * scale
  float acc[DT][4] = {};
  for (int k0 = k_first; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage<D, BK, true>(Ks, KTs, kb, ks.s, k0, T_len);
    stage<D, BK, false>(Vs, nullptr, vb, vs.s, k0, T_len);
    __syncthreads();
    float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, Qs, LD, 16 * warp, 16 * kk, gid, tig);
      load_a(ado, dOs, LD, 16 * warp, 16 * kk, gid, tig);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bk[2], bv[2];
        load_b(bk, Ks, LD, 8 * nt, 16 * kk, gid, tig);
        load_b(bv, Vs, LD, 8 * nt, 16 * kk, gid, tig);
        mma(s[nt], aq, bk);
        mma(dp[nt], ado, bv);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int key = k0 + 8 * nt + 2 * tig + (i & 1);
        const float p = visible(q0 + rloc[r], key, S, T_len, causal, window) ? expf(s[nt][i] * scale - lse[r]) : 0.f;
        s[nt][i] = p * (dp[nt][i] - dr[r]);  // dS
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < DT; ++nt) {
        uint32_t bb[2];
        load_b(bb, KTs, LDT, 8 * nt, 16 * kk, gid, tig);
        mma(acc[nt], a, bb);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + rloc[r];
    if (qi >= S) continue;
    bf16* out = dq + b * dqs.b + (int64_t)qi * dqs.s + h * dqs.h + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < DT; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * nt) =
          __floats2bfloat162_rn(acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse_in, const float* __restrict__ dr_in,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int T_len, int Hq, int Hkv, int causal, int window,
    Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, float scale) {
  using M = Smem<D>;
  constexpr int LD = M::LD, LDT = M::LDT_Q, KB = D / 16, NT = BQ2 / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD]
  bf16* Vs = Ks + BK * LD;
  bf16* Qs = Vs + BK * LD;                        // [BQ2][LD]
  bf16* dOs = Qs + BQ2 * LD;
  bf16* QTs = dOs + BQ2 * LD;                     // [D][LDT]
  bf16* dOTs = QTs + D * LDT;
  float* lse_s = reinterpret_cast<float*>(dOTs + D * LDT);  // [BQ2]
  float* dr_s = lse_s + BQ2;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const int k0 = blockIdx.x * BK;  // key tile 0 first: under a causal mask it sees the most q tiles
  const int hk = blockIdx.y, b = blockIdx.z, G = Hq / Hkv;
  const int key[2] = {k0 + 16 * warp + gid, k0 + 16 * warp + gid + 8};

  stage<D, BK, false>(Ks, nullptr, k + b * ks.b + hk * ks.h, ks.s, k0, T_len);
  stage<D, BK, false>(Vs, nullptr, v + b * vs.b + hk * vs.h, vs.s, k0, T_len);

  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + BK - 1 + window) : S;
  const int q_first = (q_begin / BQ2) * BQ2;

  float acc_k[DT][4] = {}, acc_v[DT][4] = {};
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const int64_t stat0 = ((int64_t)b * Hq + h) * S;
    for (int q0 = q_first; q0 < q_end; q0 += BQ2) {
      __syncthreads();  // the previous tile is consumed (and K, V are staged)
      stage<D, BQ2, true>(Qs, QTs, q + b * qs.b + h * qs.h, qs.s, q0, S);
      stage<D, BQ2, true>(dOs, dOTs, dout + b * dos.b + h * dos.h, dos.s, q0, S);
      for (int j = threadIdx.x; j < BQ2; j += THREADS) {
        const bool in = q0 + j < S;
        lse_s[j] = in ? lse_in[stat0 + q0 + j] : INFINITY;
        dr_s[j] = in ? dr_in[stat0 + q0 + j] : 0.f;
      }
      __syncthreads();
      float st[NT][4] = {}, dpt[NT][4] = {};  // S^T and dP^T: this warp's 16 keys x 32 query rows
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, Ks, LD, 16 * warp, 16 * kk, gid, tig);
        load_a(av, Vs, LD, 16 * warp, 16 * kk, gid, tig);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bq[2], bdo[2];
          load_b(bq, Qs, LD, 8 * nt, 16 * kk, gid, tig);
          load_b(bdo, dOs, LD, 8 * nt, 16 * kk, gid, tig);
          mma(st[nt], ak, bq);
          mma(dpt[nt], av, bdo);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 8 * nt + 2 * tig + (i & 1);
          const float p =
              visible(q0 + j, key[i >> 1], S, T_len, causal, window) ? expf(st[nt][i] * scale - lse_s[j]) : 0.f;
          st[nt][i] = p;
          dpt[nt][i] = p * (dpt[nt][i] - dr_s[j]);  // dS^T
        }
#pragma unroll
      for (int kk = 0; kk < BQ2 / 16; ++kk) {
        uint32_t ap[4], ads[4];
        acc_to_a(ap, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(ads, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int nt = 0; nt < DT; ++nt) {
          uint32_t bdo[2], bq[2];
          load_b(bdo, dOTs, LDT, 8 * nt, 16 * kk, gid, tig);
          load_b(bq, QTs, LDT, 8 * nt, 16 * kk, gid, tig);
          mma(acc_v[nt], ap, bdo);
          mma(acc_k[nt], ads, bq);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= T_len) continue;
    bf16* ok = dk + b * dks.b + (int64_t)key[r] * dks.s + hk * dks.h + 2 * tig;
    bf16* ov = dv + b * dvs.b + (int64_t)key[r] * dvs.s + hk * dvs.h + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < DT; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(ok + 8 * nt) =
          __floats2bfloat162_rn(acc_k[nt][2 * r] * scale, acc_k[nt][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(ov + 8 * nt) = __floats2bfloat162_rn(acc_v[nt][2 * r], acc_v[nt][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using M = Smem<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)M::DQ);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)M::DKDV);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k);
  const bf16 *v = static_cast<const bf16*>(a.v), *dout = static_cast<const bf16*>(a.dout);
  dim3 grid_q((a.S + BQ - 1) / BQ, a.Hq, a.B);
  flash_bwd_dq_mma_kernel<D><<<grid_q, THREADS, M::DQ, stream>>>(
      q, k, v, static_cast<const bf16*>(a.o), dout, static_cast<bf16*>(a.dq), a.lse, a.dr, a.S, a.T_len, a.Hq,
      a.Hkv, a.causal, a.window, a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_k((a.T_len + BK - 1) / BK, a.Hkv, a.B);
  flash_bwd_dkdv_mma_kernel<D><<<grid_k, THREADS, M::DKDV, stream>>>(
      q, k, v, dout, a.lse, a.dr, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, a.T_len, a.Hq, a.Hkv,
      a.causal, a.window, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, scale);
  return cudaGetLastError();
}

}  // namespace mma_bwd

}  // namespace

// dq, dk, dv of attention, from q, k, v, the forward's output o and its
// gradient dout; dtype 0 = f32, 1 = bf16 for all eight tensors. Each tensor
// is (B, len, H, D) read or written through its (batch, position, head)
// strides, with unit stride on D. lse and dr are f32 scratch of B * Hq * S
// floats each (the row statistics, passed from the first kernel to the
// second). Launches both kernels on `stream` and returns the cudaError_t of
// the first that fails, or 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                   void* dq, void* dk, void* dv, float* lse, float* dr, int dtype, int B, int S,
                                   int T_len, int Hq, int Hkv, int D, int causal, int window, int64_t q_sb,
                                   int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                   int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                                   int64_t o_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh, int64_t dq_sb,
                                   int64_t dq_ss, int64_t dq_sh, int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                                   int64_t dv_sb, int64_t dv_ss, int64_t dv_sh, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,  o,   dout,   dq,     dk,   dv, lse, dr, B, S, T_len, Hq, Hkv, causal, window,
               {q_sb, q_ss, q_sh},    {k_sb, k_ss, k_sh},    {v_sb, v_ss, v_sh},    {o_sb, o_ss, o_sh},
               {do_sb, do_ss, do_sh}, {dq_sb, dq_ss, dq_sh}, {dk_sb, dk_ss, dk_sh}, {dv_sb, dv_ss, dv_sh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(D, a, st);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(D, a, st);
  return (int)cudaErrorInvalidValue;
}

// The mma variant: bf16 for all eight tensors, D in {16, 64, 128}. Arguments
// as flash_attention_bwd's, without the dtype. Every tensor's base must be
// 16-byte aligned and every stride a multiple of 8 elements (the kernels
// stage tiles with 16-byte loads).
extern "C" int flash_attention_bwd_mma(const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, void* dq, void* dk, void* dv, float* lse, float* dr, int B,
                                       int S, int T_len, int Hq, int Hkv, int D, int causal, int window,
                                       int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                                       int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
                                       int64_t o_ss, int64_t o_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh,
                                       int64_t dq_sb, int64_t dq_ss, int64_t dq_sh, int64_t dk_sb, int64_t dk_ss,
                                       int64_t dk_sh, int64_t dv_sb, int64_t dv_ss, int64_t dv_sh, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,  o,   dout,   dq,     dk,   dv, lse, dr, B, S, T_len, Hq, Hkv, causal, window,
               {q_sb, q_ss, q_sh},    {k_sb, k_ss, k_sh},    {v_sb, v_ss, v_sh},    {o_sb, o_ss, o_sh},
               {do_sb, do_ss, do_sh}, {dq_sb, dq_ss, dq_sh}, {dk_sb, dk_ss, dk_sh}, {dv_sb, dv_ss, dv_sh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)mma_bwd::launch<16>(a, st);
    case 64: return (int)mma_bwd::launch<64>(a, st);
    case 128: return (int)mma_bwd::launch<128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
