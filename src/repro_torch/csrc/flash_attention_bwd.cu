// Flash attention backward for Hopper (sm_90a), CUDA C++: three variants of two kernels.
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
// dK and dV summed over the q-heads of each kv group; a row that sees no key
// has lse = +inf, so P = 0. O is the forward's output as stored.
//
// What bounds it on the H100: operations, as the forward (~2.5 x its work:
// five products of S x T x D per head against the forward's two). Three
// variants, picked by dtype and head dim alone (kernels/flash_attention.py
// bwd_variant; the mma pair is kept as a yardstick that ops never picks),
// each a pair of kernels (the wgmma pair at D = 256 may launch a third that
// adds partial sums), all deterministic (no atomics):
//
// The wgmma variant (bf16 at D in {16, 64, 128, 256}: the models' training
// path) is built for that bound with Hopper's tensor-core pipeline, as the
// forward's wgmma kernel (flash_attention_sm90.cuh holds the building blocks):
// a producer warpgroup of which one thread keeps TMA loads in flight through
// mbarrier rings, two consumer warpgroups running wgmma (setmaxnreg 24/240, so
// dK and dV, 64 f32 a thread each at D = 128, sit beside the two 64 x 64
// score tiles without spills), 128-byte swizzle (32-byte at D = 16) in the
// tensor maps and the descriptors alike. The forward writes the rows' lse, so
// nothing recomputes the row statistics: 7 products where the bound counts 5
// (the mma pair ran 8). No operand is ever transposed by hand: wgmma reads a
// tile whose rows are the reduction axis MN-major (the descriptor's transpose
// bit), and P^T and dS^T enter their products as register fragments, the
// accumulator layout of S^T and dP^T.
//
//   * flash_bwd_dq_wgmma_kernel, one block per (b, q-head, 128 query rows),
//     the last rows first (the longest under a causal mask): Dr for its rows
//     from dO and O (to scratch for the second kernel); Q and dO loaded once;
//     64-key K/V tiles through a 2-stage ring (32-key at D = 256, where Q and
//     dO take 128 KB); per tile S = Q K^T and dP = dO V^T (SS, two commit
//     groups, so P's exponentials run while dP is multiplied), P and dS in
//     registers, dQ += dS K (RS, K MN-major; dQ is 128 f32 a thread at
//     D = 256, one m64n256 product a k16 step);
//   * flash_bwd_dkdv_wgmma_kernel (D <= 128), one block per (b, kv-head,
//     pair of 64-key tiles j and n - 1 - j): under a causal mask a pair sees the same number
//     of q tiles in every block, so 128 equal blocks fill the card at the
//     training shape where one block per key tile would leave the first
//     tiles' blocks running alone. K and V stay in shared memory while a
//     3-stage ring brings each q-head's Q, dO, lse and Dr tiles (TMA, and a
//     bulk copy for the f32 rows); the two consumer warpgroups take alternate
//     q tiles: S^T = K Q^T and dP^T = V dO^T (SS), P^T and dS^T in registers,
//     dV += P^T dO and dK += dS^T Q (RS, dO and Q MN-major). At each key
//     tile's end the warpgroups add their partial sums through shared memory
//     in a fixed order and write dK and dV;
//   * flash_bwd_dkdv_d256_kernel (D = 256), where a warpgroup's dK and dV
//     over all of D would be 256 f32 a thread and the partial-sum buffer
//     alone 128 KB: one block per (64-key tile, b, kv-head, group of the kv
//     group's q-heads), the key tiles in order. Both warpgroups take every
//     q tile: warpgroup 0 runs S^T = K Q^T and hands P^T (f32) over through
//     shared memory, warpgroup 1 runs dP^T = V dO^T and hands dS^T (bf16
//     fragments) back, named barriers between; each then accumulates its
//     own 128 columns of dV += P^T dO and dK += dS^T Q, so no product runs
//     twice and no sum is held twice (64 + 64 f32 a thread). At MQA and
//     batch 1 one block per key tile leaves most SMs idle (64 blocks at
//     T = 4096): the wrapper then splits the q-heads into groups
//     (kernels/flash_attention.py dkdv_splits), each block writes f32 partial
//     sums, and flash_bwd_dkdv_sum_kernel adds them in the groups' order.
//
// The mma variant (bf16 at D in {16, 64, 128}), the first tensor-core pair,
// runs the five products with mma.sync m16n8k16 (bf16 operands, f32 sums),
// four warps a block, each warp 16 rows of the block's own tile; tiles are
// staged in shared memory as they are and, where a product reads them along
// the other axis, transposed, so every fragment is one 32-bit load (rows
// padded by 8 bf16: the 8 rows of a fragment load hit distinct banks). P and
// dS enter the next product from the accumulator registers. Not pipelined:
// no TMA, no wgmma, no overlap of loads with products; it recomputes the row
// statistics:
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
// The FMA variant (f32 at any D, bf16 at D = 8; also built for bf16 at 64,
// 128 and 256 as a yardstick of the wgmma pair, not at 16) is the first kernel
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "flash_attention_sm90.cuh"

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
    case 16:  // bf16 at D = 16 is the wgmma pair's; its FMA instance is not built
      if constexpr (std::is_same<T, __nv_bfloat16>::value) return cudaErrorInvalidValue;
      else return launch<T, 16>(a, stream);
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

// ---------------------------------------------------------------------------
// The wgmma variant: bf16, D in {16, 64, 128, 256}
// ---------------------------------------------------------------------------

namespace wgmma_bwd {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 384;    // warpgroups 0-1 consume, warpgroup 2 produces (one thread issues the copies)
constexpr int CONSUMERS = 256;
constexpr int ROWS = 64;        // rows of a K, V, Q or dO tile that a product reads; one consumer warpgroup's M
constexpr int DQ_ROWS = 128;    // query rows of a dQ block: one 64-row slice per consumer warpgroup
constexpr int DQ_STAGES = 2;    // K/V ring of the dQ kernel
constexpr int DKDV_STAGES = 3;  // Q/dO/lse/Dr ring of the dK/dV kernel (D <= 128)
constexpr int D256_STAGES = 2;  // Q/dO/lse/Dr ring of the D = 256 dK/dV kernel
constexpr int MIN_SMEM = 116 * 1024;  // one block an SM, so setmaxnreg.inc finds what the producer gave up
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int DB = D < 64 ? D : 64;  // columns of a TMA box: one swizzle row
  static constexpr int ROW_BYTES = DB * 2;    // 32 at D = 16, else 128
  static constexpr uint64_t SWIZZLE = D < 64 ? sm90::SWIZZLE_32B : sm90::SWIZZLE_128B;
  static constexpr int ATOM = 8 * ROW_BYTES;  // bytes of 8 swizzled rows: the descriptors' stride offset
  static constexpr int NCB = D / DB;          // column blocks of a tile, each [rows][DB]
  static constexpr int TILE = ROWS * D * 2;   // bytes of a 64-row tile
  // keys of a K/V tile of the dQ kernel: 64 (128 measured slower, and spills);
  // 32 at D = 256, where Q and dO of the block take 128 KB and 64-key tiles
  // in two stages would not fit
  static constexpr int DQ_KEYS = D == 256 ? 32 : 64;
  static constexpr int DQ_KV = DQ_KEYS * D * 2;  // bytes of a K or V tile of the dQ kernel
  // dQ kernel: Q and dO of the block (128 rows each), then the K/V ring
  static constexpr int DQ_BAR = 4 * TILE + DQ_STAGES * 2 * DQ_KV;
  static constexpr int DQ_USED = DQ_BAR + 64 + 1024;
  static constexpr int DQ_SMEM = DQ_USED > MIN_SMEM ? DQ_USED : MIN_SMEM;
  // dK/dV kernel (D <= 128): K, V; the Q ring, the dO ring; lse and Dr of
  // each stage; the two warpgroups' partial sums (64 x D f32 each); the barriers
  static constexpr int KV_Q = 2 * TILE;
  static constexpr int KV_DO = KV_Q + DKDV_STAGES * TILE;
  static constexpr int KV_STATS = KV_DO + DKDV_STAGES * TILE;
  static constexpr int KV_RED = KV_STATS + DKDV_STAGES * 2 * ROWS * 4;
  static constexpr int KV_BAR = KV_RED + 2 * ROWS * D * 4;
  static constexpr int KV_USED = KV_BAR + 128 + 1024;
  static constexpr int KV_SMEM = KV_USED > MIN_SMEM ? KV_USED : MIN_SMEM;
  // D = 256 dK/dV kernel: K, V; the Q ring, the dO ring; lse and Dr of each
  // stage; P^T in f32 (32 accumulators x 128 threads) and dS^T as bf16
  // fragments (16 x 128), passed between the warpgroups; the barriers
  static constexpr int D256_Q = 2 * TILE;
  static constexpr int D256_DO = D256_Q + D256_STAGES * TILE;
  static constexpr int D256_STATS = D256_DO + D256_STAGES * TILE;
  static constexpr int D256_P = D256_STATS + D256_STAGES * 2 * ROWS * 4;
  static constexpr int D256_DS = D256_P + 32 * 128 * 4;
  static constexpr int D256_BAR = D256_DS + 16 * 128 * 4;
  static constexpr int D256_SMEM = D256_BAR + 64 + 1024;  // 223,296 bytes at D = 256
};

// D[64 x N] (+)= A B, A and B K-major in shared memory (N = 32, 64 or 128).
template <int N>
__device__ __forceinline__ void ss_mma(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 32) sm90::wgmma_ss_n32(d, da, db, scale_d);
  else if constexpr (N == 64) sm90::wgmma_ss_n64(d, da, db, scale_d);
  else sm90::wgmma_ss_n128(d, da, db, scale_d);
}

// D[64 x N] += A B, A in registers, B MN-major in shared memory (N = 16, 64, 128, 256).
template <int N>
__device__ __forceinline__ void rs_mma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) sm90::wgmma_rs_n16(d, a, db);
  else if constexpr (N == 64) sm90::wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) sm90::wgmma_rs_n128(d, a, db);
  else sm90::wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc (+)= A B^T over D for one warpgroup: A the 64 rows at `a` of a tile of
// `a_rows` rows, B the N-row tile at `b`, both [NCB][rows][DB] swizzled.
template <int D, int N>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[N / 2], uint32_t a, int a_rows, uint32_t b) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int cb = kk * 16 / C::DB, within = (kk * 16 % C::DB) * 2;
    const uint64_t da = sm90::make_desc(a + cb * a_rows * C::ROW_BYTES + within, 16, C::ATOM, C::SWIZZLE);
    const uint64_t db = sm90::make_desc(b + cb * N * C::ROW_BYTES + within, 16, C::ATOM, C::SWIZZLE);
    ss_mma<N>(acc, da, db, kk > 0);
  }
}

// acc[64 x N] += A[64 x K] T, A as bf16 fragments (K / 16 k16 steps), T the N
// columns from the column block at `t` of a K-row tile of D columns, read
// MN-major (its rows are the reduction axis); N = D takes the whole tile.
template <int D, int K, int N = D>
__device__ __forceinline__ void frags_dot_tile(float (&acc)[N / 2], const uint32_t (&a)[K / 16][4], uint32_t t) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    rs_mma<N>(acc, a[kk], sm90::make_desc(t + kk * 16 * C::ROW_BYTES, K * C::ROW_BYTES, C::ATOM, C::SWIZZLE));
}

__device__ __forceinline__ bool visible(int q, int key, int S, int T_len, int causal, int window) {
  bool ok = q < S && key < T_len;
  if (causal) ok = ok && key <= q;
  if (window > 0) ok = ok && q - key < window;
  return ok;
}

// One block per (b, q-head, 128 query rows), the longest (last) q tiles first:
// Dr = rowsum(dO * O) for the block's rows (to `dr` for the dK/dV kernel),
// then over the visible K/V tiles (64 keys; 32 at D = 256) S = Q K^T and
// dP = dO V^T (SS), P and dS in registers from the forward's lse, dQ += dS K
// (RS, K MN-major; one m64n256 product a k16 step at D = 256).
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ o,
    const bf16* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ dr_out, bf16* __restrict__ dq,
    int64_t ls, int B, int S, int T_len, int Hq, int Hkv, int causal, int window, Strides os, Strides dos,
    Strides dqs, float scale, float scale_log2) {
  using C = Cfg<D>;
  constexpr int DQ_KEYS = C::DQ_KEYS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_tile = smem;                 // [NCB][128 rows][DB]
  uint8_t* do_tile = smem + 2 * C::TILE;  // [NCB][128 rows][DB]
  uint8_t* k_tiles = smem + 4 * C::TILE;  // [STAGES][NCB][DQ_KEYS][DB]
  uint8_t* v_tiles = k_tiles + DQ_STAGES * C::DQ_KV;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::DQ_BAR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + DQ_STAGES;

  const int n_qt = (S + DQ_ROWS - 1) / DQ_ROWS;
  const int per_tile = B * Hq;
  const int m0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / per_tile) * DQ_ROWS;
  const int bh = static_cast<int>(blockIdx.x) % per_tile;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);

  const int m_last = min(m0 + DQ_ROWS, S) - 1;
  const int k_lo = window > 0 ? max(0, m0 - window + 1) : 0;
  const int k_hi = causal ? min(T_len, m_last + 1) : T_len;
  const int kt0 = k_lo / DQ_KEYS;
  const int n_tiles = max(0, (k_hi + DQ_KEYS - 1) / DQ_KEYS - kt0);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");  // the producer needs few
    if (threadIdx.x == 2 * 128) {
      sm90::mbar_arrive_expect_tx(q_full, 4 * C::TILE);
      for (int cb = 0; cb < C::NCB; ++cb) {
        sm90::tma_load_4d(q_tile + cb * DQ_ROWS * C::ROW_BYTES, &tm_q, q_full, cb * C::DB, m0, h, b);
        sm90::tma_load_4d(do_tile + cb * DQ_ROWS * C::ROW_BYTES, &tm_do, q_full, cb * C::DB, m0, h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % DQ_STAGES;
        sm90::mbar_wait(&empty[s], ((i / DQ_STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * C::DQ_KV);
        const int k0 = (kt0 + i) * DQ_KEYS;
        for (int cb = 0; cb < C::NCB; ++cb) {
          const int off = s * C::DQ_KV + cb * DQ_KEYS * C::ROW_BYTES;
          sm90::tma_load_4d(k_tiles + off, &tm_k, &full[s], cb * C::DB, k0, hk, b);
          sm90::tma_load_4d(v_tiles + off, &tm_v, &full[s], cb * C::DB, k0, hk, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");  // 2 x 128 x 240 + 128 x 24 <= 64K
    const int t = threadIdx.x % 128, lane = t % 32;
    const int wrow0 = m0 + wg * 64;
    const int row0 = wrow0 + (t / 32) * 16 + lane / 4;  // this thread's rows: row0 and row0 + 8
    const int col_lane = 2 * (lane % 4);
    const int64_t stat0 = (int64_t)bh * ls;

    // Dr over the stored output, 4 threads a row (a quarter of D each), and
    // the rows' lse in the log2 domain (+inf past S: P = 0 there).
    float dr[2], lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      float acc = 0.f;
      if (row < S) {
        const bf16* orow = o + b * os.b + (int64_t)row * os.s + h * os.h + (lane % 4) * (D / 4);
        const bf16* drow = dout + b * dos.b + (int64_t)row * dos.s + h * dos.h + (lane % 4) * (D / 4);
#pragma unroll
        for (int c = 0; c < D / 4; c += 4) {
          const uint2 ov = *reinterpret_cast<const uint2*>(orow + c);
          const uint2 dv = *reinterpret_cast<const uint2*>(drow + c);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
            acc = fmaf(df.x, of.x, acc);
            acc = fmaf(df.y, of.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      dr[r] = acc;
      if (lane % 4 == 0 && row < ls) dr_out[stat0 + row] = acc;  // 0 on the padding rows
      lse2[r] = row < S ? lse[stat0 + row] * LOG2E : INFINITY;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t q_base = sm90::smem_u32(q_tile) + wg * 64 * C::ROW_BYTES;
    const uint32_t do_base = sm90::smem_u32(do_tile) + wg * 64 * C::ROW_BYTES;
    sm90::mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % DQ_STAGES;
      const int k0 = (kt0 + i) * DQ_KEYS;
      sm90::mbar_wait(&full[s], (i / DQ_STAGES) & 1);
      const uint32_t k_base = sm90::smem_u32(k_tiles + s * C::DQ_KV);
      const uint32_t v_base = sm90::smem_u32(v_tiles + s * C::DQ_KV);

      float sc[DQ_KEYS / 2], dp[DQ_KEYS / 2];
#pragma unroll
      for (int j = 0; j < DQ_KEYS / 2; ++j) sc[j] = dp[j] = 0.f;
      sm90::fence_operands(sc);
      sm90::fence_operands(dp);
      sm90::wgmma_fence();
      rows_dot_rows<D, DQ_KEYS>(sc, q_base, DQ_ROWS, k_base);  // S = Q K^T
      sm90::wgmma_commit();
      rows_dot_rows<D, DQ_KEYS>(dp, do_base, DQ_ROWS, v_base);  // dP = dO V^T
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S has landed; P's exponentials run while dP is multiplied
      sm90::fence_operands(sc);

      // P = exp2(S * scale * log2 e - lse * log2 e), dS = P (dP - Dr); masked
      // only where the tile crosses the diagonal, the window edge or T.
      const bool need_mask = k0 + DQ_KEYS > T_len || (causal && k0 + DQ_KEYS - 1 > wrow0) ||
                             (window > 0 && wrow0 + 63 - k0 >= window);
#pragma unroll
      for (int j = 0; j < DQ_KEYS / 2; ++j) {
        const int r = (j >> 1) & 1;
        sc[j] = exp2f(sc[j] * scale_log2 - lse2[r]);
        if (need_mask && !visible(row0 + r * 8, k0 + (j >> 2) * 8 + col_lane + (j & 1), S, T_len, causal, window))
          sc[j] = 0.f;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_operands(dp);
#pragma unroll
      for (int j = 0; j < DQ_KEYS / 2; ++j) dp[j] = sc[j] * (dp[j] - dr[(j >> 1) & 1]);
      uint32_t ds[DQ_KEYS / 16][4];
#pragma unroll
      for (int kk = 0; kk < DQ_KEYS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) ds[kk][r] = pack(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);

      // dQ += dS K: K's rows are the keys, the reduction axis: MN-major.
      sm90::fence_operands(acc);
      sm90::wgmma_fence();
      frags_dot_tile<D, DQ_KEYS>(acc, ds, k_base);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_operands(acc);
      sm90::mbar_arrive(&empty[s]);
    }

    bf16* qb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int row = row0 + ((j >> 1) & 1) * 8;
      if (row < S)
        *reinterpret_cast<__nv_bfloat162*>(qb + (int64_t)row * dqs.s + (j >> 2) * 8 + col_lane) =
            __floats2bfloat162_rn(acc[j] * scale, acc[j + 1] * scale);
    }
  }
}

// The first key of the n-th key tile (n = 0, 1) of dK/dV block `pair`: tiles j and n_kt - 1 - j.
__device__ __forceinline__ int key_tile_start(int pair, int n, int T_len) {
  const int n_kt = (T_len + ROWS - 1) / ROWS;
  return (n == 0 ? pair : n_kt - 1 - pair) * ROWS;
}
__device__ __forceinline__ int key_tiles_of_pair(int pair, int T_len) {
  return 2 * pair + 1 == (T_len + ROWS - 1) / ROWS ? 1 : 2;
}

// out[key, :] = (mine + theirs) * mult in bf16 for this thread's keys < T_len:
// one warpgroup's partial sum plus the other's, read from shared memory.
template <int D>
__device__ __forceinline__ void write_sum(const float (&mine)[D / 2], const float* theirs, float mult, bf16* out,
                                         int64_t row_stride, int key0, int T_len, int t, int col_lane) {
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int key = key0 + ((j >> 1) & 1) * 8;
    const float x = (mine[j] + theirs[j * 128 + t]) * mult;
    const float y = (mine[j + 1] + theirs[(j + 1) * 128 + t]) * mult;
    if (key < T_len)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)key * row_stride + (j >> 2) * 8 + col_lane) =
          __floats2bfloat162_rn(x, y);
  }
}

__device__ __forceinline__ int q_first(int k0, int causal) { return causal ? k0 : 0; }
__device__ __forceinline__ int q_end(int k0, int S, int window) {
  return window > 0 ? min(S, k0 + ROWS - 1 + window) : S;
}

// One block per (b, kv-head, pair of 64-key tiles j and n - 1 - j): under a
// causal mask the pair sees the same number of q tiles in every block. For
// each key tile, K and V stay in shared memory while a ring brings each
// q-head's 64-row Q, dO, lse and Dr tiles; the two consumer warpgroups take
// alternate tiles: S^T = K Q^T and dP^T = V dO^T (SS), P^T and dS^T in
// registers, dV += P^T dO and dK += dS^T Q (RS, dO and Q MN-major). At the
// key tile's end the warpgroups add their partial sums through shared
// memory in a fixed order (deterministic) and write dK, dV.
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse, const float* __restrict__ dr, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int64_t ls, int B, int S, int T_len, int Hq, int Hkv, int causal, int window, Strides dks, Strides dvs,
    float scale, float scale_log2) {
  static_assert(D <= 128, "D = 256 takes flash_bwd_dkdv_d256_kernel");
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_tile = smem;                  // [NCB][64][DB]
  uint8_t* v_tile = smem + C::TILE;
  uint8_t* q_tiles = smem + C::KV_Q;       // [STAGES][NCB][64][DB]
  uint8_t* do_tiles = smem + C::KV_DO;
  float* lse_s = reinterpret_cast<float*>(smem + C::KV_STATS);  // [STAGES][64]
  float* dr_s = lse_s + DKDV_STAGES * ROWS;
  float* red = reinterpret_cast<float*>(smem + C::KV_RED);  // [2][D / 2][128]: dK from wg 1, dV from wg 0
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::KV_BAR);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = bars + 2 + DKDV_STAGES;

  const int n_pairs = ((T_len + ROWS - 1) / ROWS + 1) / 2;
  const int pair = static_cast<int>(blockIdx.x) % n_pairs;
  const int bk = static_cast<int>(blockIdx.x) / n_pairs;
  const int b = bk / Hkv, hk = bk % Hkv, G = Hq / Hkv;
  const int n_keys = key_tiles_of_pair(pair, T_len);

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    sm90::mbar_init(kv_empty, CONSUMERS);
    for (int s = 0; s < DKDV_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);  // one warpgroup consumes a stage
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");  // the producer needs few
    if (threadIdx.x == 2 * 128) {
      int it = 0;
      for (int n = 0; n < n_keys; ++n) {
        const int k0 = key_tile_start(pair, n, T_len);
        if (n > 0) sm90::mbar_wait(kv_empty, (n - 1) & 1);
        sm90::mbar_arrive_expect_tx(kv_full, 2 * C::TILE);
        for (int cb = 0; cb < C::NCB; ++cb) {
          sm90::tma_load_4d(k_tile + cb * ROWS * C::ROW_BYTES, &tm_k, kv_full, cb * C::DB, k0, hk, b);
          sm90::tma_load_4d(v_tile + cb * ROWS * C::ROW_BYTES, &tm_v, kv_full, cb * C::DB, k0, hk, b);
        }
        const int qf = q_first(k0, causal), qe = q_end(k0, S, window);
        for (int g = 0; g < G; ++g) {
          const int h = hk * G + g;
          const int64_t stat0 = ((int64_t)b * Hq + h) * ls;
          for (int q0 = qf; q0 < qe; q0 += ROWS, ++it) {
            const int s = it % DKDV_STAGES;
            sm90::mbar_wait(&empty[s], ((it / DKDV_STAGES) & 1) ^ 1);
            sm90::mbar_arrive_expect_tx(&full[s], 2 * C::TILE + 2 * ROWS * 4);
            for (int cb = 0; cb < C::NCB; ++cb) {
              const int off = s * C::TILE + cb * ROWS * C::ROW_BYTES;
              sm90::tma_load_4d(q_tiles + off, &tm_q, &full[s], cb * C::DB, q0, h, b);
              sm90::tma_load_4d(do_tiles + off, &tm_do, &full[s], cb * C::DB, q0, h, b);
            }
            sm90::bulk_load(lse_s + s * ROWS, lse + stat0 + q0, ROWS * 4, &full[s]);
            sm90::bulk_load(dr_s + s * ROWS, dr + stat0 + q0, ROWS * 4, &full[s]);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");  // 2 x 128 x 240 + 128 x 24 <= 64K
    const int t = threadIdx.x % 128, lane = t % 32;
    const int col_lane = 2 * (lane % 4);
    const uint32_t k_base = sm90::smem_u32(k_tile), v_base = sm90::smem_u32(v_tile);
    int it = 0;
    for (int n = 0; n < n_keys; ++n) {
      const int k0 = key_tile_start(pair, n, T_len);
      const int key0 = k0 + (t / 32) * 16 + lane / 4;  // this thread's keys: key0 and key0 + 8
      float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
      sm90::mbar_wait(kv_full, n & 1);
      const int qf = q_first(k0, causal), qe = q_end(k0, S, window);
      for (int g = 0; g < G; ++g) {
        for (int q0 = qf; q0 < qe; q0 += ROWS, ++it) {
          if ((it & 1) != wg) continue;  // the other warpgroup's tile
          const int s = it % DKDV_STAGES;
          sm90::mbar_wait(&full[s], (it / DKDV_STAGES) & 1);
          const uint32_t q_base = sm90::smem_u32(q_tiles + s * C::TILE);
          const uint32_t do_base = sm90::smem_u32(do_tiles + s * C::TILE);
          const float* lse_t = lse_s + s * ROWS;
          const float* dr_t = dr_s + s * ROWS;

          float st[32], dpt[32];  // S^T and dP^T: 64 keys x 64 query rows
#pragma unroll
          for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
          sm90::fence_operands(st);
          sm90::fence_operands(dpt);
          sm90::wgmma_fence();
          rows_dot_rows<D, ROWS>(st, k_base, ROWS, q_base);
          sm90::wgmma_commit();
          rows_dot_rows<D, ROWS>(dpt, v_base, ROWS, do_base);
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // S^T has landed; P^T's exponentials run while dP^T is multiplied
          sm90::fence_operands(st);

          const bool need_mask = q0 + ROWS > S || k0 + ROWS > T_len || (causal && k0 + ROWS - 1 > q0) ||
                                 (window > 0 && q0 + ROWS - 1 - k0 >= window);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int qc = (j >> 2) * 8 + col_lane + (j & 1);
            st[j] = exp2f(st[j] * scale_log2 - lse_t[qc] * LOG2E);
            if (need_mask && !visible(q0 + qc, key0 + ((j >> 1) & 1) * 8, S, T_len, causal, window)) st[j] = 0.f;
          }
          sm90::wgmma_wait<0>();
          sm90::fence_operands(dpt);
#pragma unroll
          for (int j = 0; j < 32; ++j) dpt[j] = st[j] * (dpt[j] - dr_t[(j >> 2) * 8 + col_lane + (j & 1)]);
          uint32_t pf[4][4], dsf[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              pf[kk][r] = pack(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
              dsf[kk][r] = pack(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
            }

          // dV += P^T dO and dK += dS^T Q: dO's and Q's rows are the query
          // rows, the reduction axis: MN-major.
          sm90::fence_operands(acc_v);
          sm90::fence_operands(acc_k);
          sm90::wgmma_fence();
          frags_dot_tile<D, ROWS>(acc_v, pf, do_base);
          frags_dot_tile<D, ROWS>(acc_k, dsf, q_base);
          sm90::wgmma_commit();
          sm90::wgmma_wait_all();
          sm90::fence_operands(acc_v);
          sm90::fence_operands(acc_k);
          sm90::mbar_arrive(&empty[s]);
        }
      }

      // The two warpgroups hold partial sums over alternate q tiles of the
      // same keys, in the same fragment layout: warpgroup 1 hands its dK to
      // warpgroup 0 and warpgroup 0 its dV to warpgroup 1, each adds the
      // other's to its own (a fixed order) and writes one of the two.
      float* red_k = red;
      float* red_v = red + (D / 2) * 128;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) {
        if (wg == 1) red_k[j * 128 + t] = acc_k[j];
        else red_v[j * 128 + t] = acc_v[j];
      }
      sm90::mbar_arrive(kv_empty);  // K and V are read for the last time
      sm90::named_sync(1, CONSUMERS);
      if (wg == 0)
        write_sum<D>(acc_k, red_k, scale, dk + b * dks.b + hk * dks.h, dks.s, key0, T_len, t, col_lane);
      else
        write_sum<D>(acc_v, red_v, 1.f, dv + b * dvs.b + hk * dvs.h, dvs.s, key0, T_len, t, col_lane);
      sm90::named_sync(1, CONSUMERS);  // the buffers are free for the next key tile
    }
  }
}

// dK and dV at D = 256, one block per (64-key tile, b, kv-head, group of
// G / splits q-heads), the key tiles in order (under a causal mask the first
// see the most q tiles, so the longest blocks start first). The partial sums
// of a warpgroup at D = 128 (dK and dV, 64 f32 a thread each, the whole of D)
// would be 256 registers at D = 256, and adding the two warpgroups' sums
// needs 128 KB of shared memory: so here the warpgroups split the work of
// each q tile by product and D by column half, and no two hold the same sum.
// Both take every q tile of the ring: warpgroup 0 runs S^T = K Q^T and
// turns it into P^T (f32, to shared memory), warpgroup 1 runs dP^T = V dO^T
// and, once P^T is there, forms dS^T = P^T (dP^T - Dr) (bf16 fragments, to
// shared memory); each then accumulates its 128 columns of dV += P^T dO and
// dK += dS^T Q (RS, dO and Q MN-major). Named barriers order the two
// hand-overs (1: P^T written, 2: dS^T written), and each warpgroup only
// arrives where the other waits. With splits = 1 the block writes dK and dV
// in bf16; otherwise its f32 partial sums go to `part`
// ([2][splits][B][T][Hkv][256]) and flash_bwd_dkdv_sum_kernel adds them.
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_d256_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse, const float* __restrict__ dr, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ part, int64_t ls, int B, int S, int T_len, int Hq, int Hkv, int causal, int window,
    int splits, Strides dks, Strides dvs, float scale, float scale_log2) {
  constexpr int D = 256;
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_tile = smem;  // [NCB][64][DB]
  uint8_t* v_tile = smem + C::TILE;
  uint8_t* q_tiles = smem + C::D256_Q;  // [STAGES][NCB][64][DB]
  uint8_t* do_tiles = smem + C::D256_DO;
  float* lse_s = reinterpret_cast<float*>(smem + C::D256_STATS);  // [STAGES][64]
  float* dr_s = lse_s + D256_STAGES * ROWS;
  float* p_buf = reinterpret_cast<float*>(smem + C::D256_P);        // [32][128]: P^T, accumulator j of thread t
  uint32_t* ds_buf = reinterpret_cast<uint32_t*>(smem + C::D256_DS);  // [16][128]: dS^T fragment (kk, r) of t
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::D256_BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + D256_STAGES;

  const int per_tile = B * Hkv * splits;
  const int k0 = static_cast<int>(blockIdx.x) / per_tile * ROWS;
  const int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int split = rest % splits, bk = rest / splits;
  const int b = bk / Hkv, hk = bk % Hkv;
  const int heads = Hq / Hkv / splits;       // q-heads of this block
  const int h0 = hk * (Hq / Hkv) + split * heads;
  const int qf = q_first(k0, causal), qe = q_end(k0, S, window);

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < D256_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS);  // both warpgroups read every stage
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");  // the producer needs few
    if (threadIdx.x == 2 * 128) {
      sm90::mbar_arrive_expect_tx(kv_full, 2 * C::TILE);
      for (int cb = 0; cb < C::NCB; ++cb) {
        sm90::tma_load_4d(k_tile + cb * ROWS * C::ROW_BYTES, &tm_k, kv_full, cb * C::DB, k0, hk, b);
        sm90::tma_load_4d(v_tile + cb * ROWS * C::ROW_BYTES, &tm_v, kv_full, cb * C::DB, k0, hk, b);
      }
      int it = 0;
      for (int h = h0; h < h0 + heads; ++h) {
        const int64_t stat0 = ((int64_t)b * Hq + h) * ls;
        for (int q0 = qf; q0 < qe; q0 += ROWS, ++it) {
          const int s = it % D256_STAGES;
          sm90::mbar_wait(&empty[s], ((it / D256_STAGES) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&full[s], 2 * C::TILE + 2 * ROWS * 4);
          for (int cb = 0; cb < C::NCB; ++cb) {
            const int off = s * C::TILE + cb * ROWS * C::ROW_BYTES;
            sm90::tma_load_4d(q_tiles + off, &tm_q, &full[s], cb * C::DB, q0, h, b);
            sm90::tma_load_4d(do_tiles + off, &tm_do, &full[s], cb * C::DB, q0, h, b);
          }
          sm90::bulk_load(lse_s + s * ROWS, lse + stat0 + q0, ROWS * 4, &full[s]);
          sm90::bulk_load(dr_s + s * ROWS, dr + stat0 + q0, ROWS * 4, &full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");  // 2 x 128 x 240 + 128 x 24 <= 64K
    const int t = threadIdx.x % 128, lane = t % 32;
    const int col_lane = 2 * (lane % 4);
    const int key0 = k0 + (t / 32) * 16 + lane / 4;  // this thread's keys: key0 and key0 + 8
    const uint32_t half_off = wg * 2 * ROWS * C::ROW_BYTES;  // this warpgroup's 128 columns: 2 column blocks
    float acc_k[64], acc_v[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_k[i] = acc_v[i] = 0.f;
    sm90::mbar_wait(kv_full, 0);
    const uint32_t a_base = sm90::smem_u32(wg == 0 ? k_tile : v_tile);  // K for S^T, V for dP^T
    int it = 0;
    for (int h = h0; h < h0 + heads; ++h) {
      for (int q0 = qf; q0 < qe; q0 += ROWS, ++it) {
        const int s = it % D256_STAGES;
        sm90::mbar_wait(&full[s], (it / D256_STAGES) & 1);
        const uint32_t q_base = sm90::smem_u32(q_tiles + s * C::TILE);
        const uint32_t do_base = sm90::smem_u32(do_tiles + s * C::TILE);

        float sc[32];  // S^T (warpgroup 0) or dP^T (warpgroup 1): 64 keys x 64 query rows
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        sm90::fence_operands(sc);
        sm90::wgmma_fence();
        rows_dot_rows<D, ROWS>(sc, a_base, ROWS, wg == 0 ? q_base : do_base);
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_operands(sc);

        uint32_t pf[4][4], dsf[4][4];
        if (wg == 0) {
          const float* lse_t = lse_s + s * ROWS;
          const bool need_mask = q0 + ROWS > S || k0 + ROWS > T_len || (causal && k0 + ROWS - 1 > q0) ||
                                 (window > 0 && q0 + ROWS - 1 - k0 >= window);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int qc = (j >> 2) * 8 + col_lane + (j & 1);
            sc[j] = exp2f(sc[j] * scale_log2 - lse_t[qc] * LOG2E);
            if (need_mask && !visible(q0 + qc, key0 + ((j >> 1) & 1) * 8, S, T_len, causal, window)) sc[j] = 0.f;
            p_buf[j * 128 + t] = sc[j];
          }
          sm90::named_arrive(1, CONSUMERS);  // P^T is written
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) pf[kk][r] = pack(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
          sm90::named_sync(2, CONSUMERS);  // dS^T is written
#pragma unroll
          for (int i = 0; i < 16; ++i) dsf[i / 4][i % 4] = ds_buf[i * 128 + t];
        } else {
          const float* dr_t = dr_s + s * ROWS;
          sm90::named_sync(1, CONSUMERS);  // P^T is written
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int j = 8 * kk + 2 * r, qc = (j >> 2) * 8 + col_lane;
              const float p0 = p_buf[j * 128 + t], p1 = p_buf[(j + 1) * 128 + t];
              pf[kk][r] = pack(p0, p1);
              dsf[kk][r] = pack(p0 * (sc[j] - dr_t[qc]), p1 * (sc[j + 1] - dr_t[qc + 1]));
              ds_buf[(4 * kk + r) * 128 + t] = dsf[kk][r];
            }
          sm90::named_arrive(2, CONSUMERS);  // dS^T is written
        }

        // dV[:, half] += P^T dO[:, half] and dK[:, half] += dS^T Q[:, half]:
        // dO's and Q's rows are the query rows, the reduction axis: MN-major.
        sm90::fence_operands(acc_v);
        sm90::fence_operands(acc_k);
        sm90::wgmma_fence();
        frags_dot_tile<D, ROWS, 128>(acc_v, pf, do_base + half_off);
        frags_dot_tile<D, ROWS, 128>(acc_k, dsf, q_base + half_off);
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_operands(acc_v);
        sm90::fence_operands(acc_k);
        sm90::mbar_arrive(&empty[s]);
      }
    }

    const int col0 = wg * 128 + col_lane;
    if (splits == 1) {
      bf16* ok = dk + b * dks.b + hk * dks.h + col0;
      bf16* ov = dv + b * dvs.b + hk * dvs.h + col0;
#pragma unroll
      for (int j = 0; j < 64; j += 2) {
        const int key = key0 + ((j >> 1) & 1) * 8;
        if (key < T_len) {
          *reinterpret_cast<__nv_bfloat162*>(ok + (int64_t)key * dks.s + (j >> 2) * 8) =
              __floats2bfloat162_rn(acc_k[j] * scale, acc_k[j + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(ov + (int64_t)key * dvs.s + (j >> 2) * 8) =
              __floats2bfloat162_rn(acc_v[j], acc_v[j + 1]);
        }
      }
    } else {
      const int64_t plane = (int64_t)B * T_len * Hkv * D;
      float* pk = part + split * plane + ((int64_t)b * T_len * Hkv + hk) * D + col0;
      float* pv = pk + splits * plane;
#pragma unroll
      for (int j = 0; j < 64; j += 2) {
        const int key = key0 + ((j >> 1) & 1) * 8;
        if (key < T_len) {
          const int64_t off = (int64_t)key * Hkv * D + (j >> 2) * 8;
          *reinterpret_cast<float2*>(pk + off) = make_float2(acc_k[j], acc_k[j + 1]);
          *reinterpret_cast<float2*>(pv + off) = make_float2(acc_v[j], acc_v[j + 1]);
        }
      }
    }
  }
}

// dK and dV in bf16 from the D = 256 dK/dV kernel's partial sums
// ([2][splits][B][T][Hkv][256] f32), added in the order of the head groups,
// so the result does not depend on which block finished first; dK times the
// softmax scale. Four columns a thread.
__global__ void flash_bwd_dkdv_sum_kernel(const float* __restrict__ part, int splits, int B, int T_len, int Hkv,
                                          bf16* __restrict__ dk, bf16* __restrict__ dv, Strides dks, Strides dvs,
                                          float scale) {
  constexpr int D = 256;
  const int64_t n = (int64_t)B * T_len * Hkv * (D / 4);  // groups of four columns of dK (and of dV)
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n) return;
  const int which = i >= n;  // 0: dK, 1: dV
  const int64_t e = which ? i - n : i;
  const int64_t row = e / (D / 4);  // (b * T + key) * Hkv + hk
  const int col = static_cast<int>(e % (D / 4)) * 4;
  const int hk = static_cast<int>(row % Hkv);
  const int key = static_cast<int>(row / Hkv % T_len);
  const int b = static_cast<int>(row / Hkv / T_len);
  const int64_t plane = (int64_t)B * T_len * Hkv * D;
  const float* p = part + which * splits * plane + row * D + col;
  float4 acc = *reinterpret_cast<const float4*>(p);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 x = *reinterpret_cast<const float4*>(p + sp * plane);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float mult = which ? 1.f : scale;
  bf16* out = which ? dv + b * dvs.b + (int64_t)key * dvs.s + hk * dvs.h + col
                    : dk + b * dks.b + (int64_t)key * dks.s + hk * dks.h + col;
  reinterpret_cast<__nv_bfloat162*>(out)[0] = __floats2bfloat162_rn(acc.x * mult, acc.y * mult);
  reinterpret_cast<__nv_bfloat162*>(out)[1] = __floats2bfloat162_rn(acc.z * mult, acc.w * mult);
}

// Errors of the host side, beside the cudaError_t values of a launch.
constexpr int ERR_NO_ENCODER = -1, ERR_TENSOR_MAP = -2;

template <int D>
int launch(const Args& a, int64_t ls, float* part, int splits, cudaStream_t stream) {
  using C = Cfg<D>;
  if (sm90::encode_fn() == nullptr) return ERR_NO_ENCODER;
  const bool sw32 = D < 64;
  CUtensorMap tq128, tdo128, tk_dq, tv_dq, tq, tdo, tk, tv;
  auto map = [&](CUtensorMap* m, const void* base, int rows, int H, Strides st, int box_rows) {
    return sm90::encode_map(m, base, a.B, rows, H, D, st.b, st.s, st.h, C::DB, box_rows, sw32);
  };
  if (!map(&tq128, a.q, a.S, a.Hq, a.qs, DQ_ROWS) || !map(&tdo128, a.dout, a.S, a.Hq, a.dos, DQ_ROWS) ||
      !map(&tq, a.q, a.S, a.Hq, a.qs, ROWS) || !map(&tdo, a.dout, a.S, a.Hq, a.dos, ROWS) ||
      !map(&tk_dq, a.k, a.T_len, a.Hkv, a.ks, C::DQ_KEYS) || !map(&tv_dq, a.v, a.T_len, a.Hkv, a.vs, C::DQ_KEYS) ||
      !map(&tk, a.k, a.T_len, a.Hkv, a.ks, ROWS) || !map(&tv, a.v, a.T_len, a.Hkv, a.vs, ROWS))
    return ERR_TENSOR_MAP;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)D));  // as the forward
  const float scale_log2 = scale * LOG2E;               // as the forward's wgmma kernel
  const int n_qt = (a.S + DQ_ROWS - 1) / DQ_ROWS;
  flash_bwd_dq_wgmma_kernel<D><<<n_qt * a.B * a.Hq, THREADS, C::DQ_SMEM, stream>>>(
      tq128, tdo128, tk_dq, tv_dq, static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout), a.lse, a.dr,
      static_cast<bf16*>(a.dq), ls, a.B, a.S, a.T_len, a.Hq, a.Hkv, a.causal, a.window, a.os, a.dos, a.dqs, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bf16 *dk = static_cast<bf16*>(a.dk), *dv = static_cast<bf16*>(a.dv);
  if constexpr (D == 256) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_d256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::D256_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int n_kt = (a.T_len + ROWS - 1) / ROWS;
    flash_bwd_dkdv_d256_kernel<<<n_kt * a.B * a.Hkv * splits, THREADS, C::D256_SMEM, stream>>>(
        tq, tdo, tk, tv, a.lse, a.dr, dk, dv, part, ls, a.B, a.S, a.T_len, a.Hq, a.Hkv, a.causal, a.window,
        splits, a.dks, a.dvs, scale, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    const int64_t n = 2 * (int64_t)a.B * a.T_len * a.Hkv * (D / 4);
    flash_bwd_dkdv_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, splits, a.B, a.T_len, a.Hkv,
                                                                             dk, dv, a.dks, a.dvs, scale);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::KV_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int n_pairs = ((a.T_len + ROWS - 1) / ROWS + 1) / 2;
    flash_bwd_dkdv_wgmma_kernel<D><<<n_pairs * a.B * a.Hkv, THREADS, C::KV_SMEM, stream>>>(
        tq, tdo, tk, tv, a.lse, a.dr, dk, dv, ls, a.B, a.S, a.T_len, a.Hq, a.Hkv, a.causal, a.window, a.dks,
        a.dvs, scale, scale_log2);
  }
  return (int)cudaGetLastError();
}

}  // namespace wgmma_bwd

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

// The wgmma variant: bf16 for all eight tensors, D in {16, 64, 128, 256}.
// lse holds the forward's row statistics (flash_attention_fwd_wgmma with an
// lse buffer; +inf past S) and dr is scratch, both B * Hq rows of lse_stride
// floats, a multiple of 64 and at least S, 16-byte aligned. At D = 256 the
// dK/dV grid splits each kv group's q-heads into `splits` groups (a divisor
// of Hq / Hkv) and, when splits > 1, `part` is f32 scratch of
// 2 * splits * B * T_len * Hkv * 256 floats, 16-byte aligned, for their
// partial sums; other head dims take splits = 1 and no scratch. Other
// arguments as flash_attention_bwd's, without the dtype; every tensor's base
// must be 16-byte aligned and every stride a multiple of 8 elements (TMA).
// Returns 0, a launch's cudaError_t, -1 when the driver has no
// cuTensorMapEncodeTiled, or -2 when a tensor map cannot be encoded.
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                                         const void* dout, void* dq, void* dk, void* dv, float* lse, float* dr,
                                         float* part, int64_t lse_stride, int splits, int B, int S, int T_len,
                                         int Hq, int Hkv, int D, int causal, int window, int64_t q_sb,
                                         int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                         int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                                         int64_t o_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh, int64_t dq_sb,
                                         int64_t dq_ss, int64_t dq_sh, int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                                         int64_t dv_sb, int64_t dv_ss, int64_t dv_sh, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (lse_stride < S || lse_stride % wgmma_bwd::ROWS != 0) return (int)cudaErrorInvalidValue;
  if (splits < 1 || (Hq / Hkv) % splits != 0 || (splits > 1 && (D != 256 || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,  o,   dout,   dq,     dk,   dv, lse, dr, B, S, T_len, Hq, Hkv, causal, window,
               {q_sb, q_ss, q_sh},    {k_sb, k_ss, k_sh},    {v_sb, v_ss, v_sh},    {o_sb, o_ss, o_sh},
               {do_sb, do_ss, do_sh}, {dq_sb, dq_ss, dq_sh}, {dk_sb, dk_ss, dk_sh}, {dv_sb, dv_ss, dv_sh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return wgmma_bwd::launch<16>(a, lse_stride, part, splits, st);
    case 64: return wgmma_bwd::launch<64>(a, lse_stride, part, splits, st);
    case 128: return wgmma_bwd::launch<128>(a, lse_stride, part, splits, st);
    case 256: return wgmma_bwd::launch<256>(a, lse_stride, part, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
