// Flash attention forward for Hopper (sm_90a), CUDA C++: two kernels.
//
// Both replace the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, launched by flash_attention_bhsd through pl.pallas_call):
// online-softmax attention with m, l and the output sum in f32, GQA (q-head h
// reads kv-head h / (Hq / Hkv)), the kv-padding mask k < T, the causal mask
// k <= q and the sliding mask q - k < window, all counted from 0 (no
// end-alignment when S < T), NEG_INF = -1e30 (never -inf; a row whose first
// tile is wholly masked takes p = 1 until its first valid key sets alpha to
// exactly 0) and l floored at 1e-30. Output in q's dtype; q, k, v and o are
// read and written in the model's (B, S, H, D) layout through strides, so no
// transpose copy is made. kernels/flash_attention.py picks the kernel by dtype
// and head dim alone.
//
// What bounds it on the H100: operations. At qwen3-4b's prefill shape
// (q 2x2048x32x128, 8 kv heads, causal) it does 4*S*S*D/2 flops per head
// against 2*(S*Hq + S*Hkv)*D*2 bytes per batch row: about 500 operations per
// byte, above the card's ridge of about 295 at which the bf16 tensor cores,
// not the memory, are the limit.
//
// flash_fwd_wgmma_kernel (bf16, D in {16, 64, 128, 256}) is built for that
// bound, with the tensor cores and warp specialisation
// (flash_attention_sm90.cuh holds the PTX building blocks):
//   * one block per (b, q-head, 128 query rows): two consumer warpgroups of
//     64 rows and one producer warpgroup, of which one thread issues TMA; the
//     producer gives up registers (setmaxnreg.dec 40) so the consumers can
//     hold O (up to 128 f32 a thread at D = 256) beside S (setmaxnreg.inc 232);
//   * TMA loads Q once and K/V tiles of 128 keys (64 at D = 256) into a ring
//     of 2 stages guarded by full/empty mbarrier pairs, so the next tile
//     loads while this one is multiplied; the tensor maps are built on the
//     host for every call over the (B, S, H, D) strides, and TMA's zero fill
//     past S and T replaces padding. 128-byte swizzle (32-byte at D = 16,
//     whose rows are 32 bytes) in the maps and the wgmma descriptors alike;
//   * S = Q K^T by wgmma m64nNk16 with both operands K-major in shared
//     memory, f32 sums; the softmax works on the accumulator fragment in
//     registers (row max and sum across the 4 threads of a row, scale*log2 e
//     folded into one multiply and exp2f), and applies the masks only on
//     tiles that cross the diagonal, the window edge or T;
//   * P V by wgmma with P in registers: the accumulator fragment of S is the
//     A-operand fragment of the next product, so P never goes through shared
//     memory; V (keys x D, D contiguous) is read MN-major through the
//     descriptor's transpose bit. P enters as two bf16 terms, hi = bf16(p)
//     and lo = bf16(p - hi): one bf16 term alone puts early causal rows, whose
//     outputs are O(1), up to one bf16 step away (0.17 x the output RMS at
//     the qwen3-4b shape, chip_smoke.py's bf16_p_err_over_rms), past the
//     0.1 x RMS guard the kernel is held to; two terms cost a third more
//     tensor work and keep the output within one bf16 rounding of f32 P;
//   * for training (LSE), each row's statistic lse = ln 2 * (m + log2 l) goes
//     to an f32 buffer for the backward (csrc/flash_attention_bwd.cu), +inf
//     for a row that sees no key and for the padding rows S..lse_stride; the
//     instance without it, which prefill and decode run, is unchanged;
//   * kv tiles wholly masked for the whole block are never loaded; the grid
//     runs the last q tiles first (the longest under a causal mask, so the
//     tail of the grid holds short blocks), and the q-heads that share a
//     kv-head sit on neighbouring blocks so their K/V tiles meet in L2.
//
// flash_fwd_kernel (f32 at any D, and bf16 at D = 8, below one k16 step)
// runs f32 FMAs out of shared memory, so shared-memory bandwidth is its
// limit: one block per (b, q-head, 64 query rows), Q and each 64-key K/V
// tile staged once in shared memory and reused by all 64 rows, the kv loop
// bounded by the diagonal and the window start, shared-memory rows padded by
// one float so the 4 threads of a row and the 8 rows of a warp hit distinct
// banks. The f32 sweep holds it at 2e-5, which no tensor-core path meets.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "flash_attention_sm90.cuh"

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS = 256;  // 4 threads per query row
constexpr int KEYS_PER_THREAD = BLOCK_K / 4;
constexpr float NEG_INF = -1.0e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  int64_t b, s, h;
};

template <int D>
constexpr size_t smem_bytes() {
  // Q and K padded to D + 1 columns, V unpadded, P padded to BLOCK_K + 1.
  return sizeof(float) * (BLOCK_Q * (D + 1) + BLOCK_K * (D + 1) + BLOCK_K * D + BLOCK_Q * (BLOCK_K + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    int S, int T_len, int Hq, int Hkv, int causal, int window,
    Strides qs, Strides ks, Strides vs, Strides os, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                          // [BLOCK_Q][D + 1]
  float* Ks = Qs + BLOCK_Q * (D + 1);        // [BLOCK_K][D + 1]
  float* Vs = Ks + BLOCK_K * (D + 1);        // [BLOCK_K][D]
  float* Ps = Vs + BLOCK_K * D;              // [BLOCK_Q][BLOCK_K + 1]

  const int tid = threadIdx.x;
  const int r = tid >> 2;   // query row within the tile
  const int sub = tid & 3;  // which quarter of the keys / output columns
  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int qi = q0 + r;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int idx = tid; idx < BLOCK_Q * D; idx += THREADS) {
    const int row = idx / D, d = idx % D;
    const int qq = q0 + row;
    Qs[row * (D + 1) + d] = qq < S ? to_float(qb[qq * qs.s + d]) : 0.f;
  }

  // kv range that any row of this tile can see.
  const int q_last = min(q0 + BLOCK_Q, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;

  float m = NEG_INF, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  for (int k0 = (k_begin / BLOCK_K) * BLOCK_K; k0 < k_end; k0 += BLOCK_K) {
    __syncthreads();  // Q is staged; the previous tile's K, V and P are consumed
    for (int idx = tid; idx < BLOCK_K * D; idx += THREADS) {
      const int row = idx / D, d = idx % D;
      const int kk = k0 + row;
      const bool in = kk < T_len;
      Ks[row * (D + 1) + d] = in ? to_float(kb[kk * ks.s + d]) : 0.f;
      Vs[row * D + d] = in ? to_float(vb[kk * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[KEYS_PER_THREAD];
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) s[i] = 0.f;
    const float* qrow = Qs + r * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int i = 0; i < KEYS_PER_THREAD; ++i) s[i] = fmaf(qd, Ks[(sub + 4 * i) * (D + 1) + d], s[i]);
    }

    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) {
      const int kk = k0 + sub + 4 * i;
      bool valid = kk < T_len;
      if (causal) valid = valid && kk <= qi;
      if (window > 0) valid = valid && (qi - kk) < window;
      s[i] = valid ? s[i] * scale : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KEYS_PER_THREAD; ++i) {
      const float p = expf(s[i] - m_new);
      Ps[r * (BLOCK_K + 1) + sub + 4 * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] *= alpha;
    __syncthreads();  // P of every row is written

    const float* prow = Ps + r * (BLOCK_K + 1);
#pragma unroll 2
    for (int j = 0; j < BLOCK_K; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * D + sub;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) acc[i] = fmaf(p, vrow[4 * i], acc[i]);
    }
  }

  if (qi < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) from_float(orow + sub + 4 * i, acc[i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len, int Hq,
                   int Hkv, int causal, int window, Strides qs, Strides ks, Strides vs, Strides os,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, Hq, B);
  const float scale = (float)(1.0 / sqrt((double)D));  // as the TPU kernel: 1 / sqrt(d) in double, then f32
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), S, T_len, Hq, Hkv,
                                        causal, window, qs, ks, vs, os, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
                       int Hq, int Hkv, int causal, int window, Strides qs, Strides ks, Strides vs, Strides os,
                       cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, qs, ks, vs, os, stream);
    case 16: return launch<T, 16>(q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, qs, ks, vs, os, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, qs, ks, vs, os, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, qs, ks, vs, os, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, qs, ks, vs, os, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// The wgmma kernel: bf16, D in {16, 64, 128, 256}
// ---------------------------------------------------------------------------

namespace wgmma_flash {

constexpr int BLOCK_M = 128;  // query rows of a block: two consumer warpgroups of 64
constexpr int THREADS = 384;  // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int STAGES = 2;     // K/V ring
constexpr int CONSUMERS = 256;
// Shared memory asked of every launch, at least: above half of the SM's, so
// one block holds an SM alone and the consumers' setmaxnreg.inc always finds
// the registers the producer gave up.
constexpr int MIN_SMEM = 116 * 1024;

template <int D>
struct Cfg {
  static constexpr int BLOCK_N = D == 256 ? 64 : 128;  // keys of a K/V tile
  static constexpr int DB = D < 64 ? D : 64;           // columns of a TMA box: one swizzle row
  static constexpr int ROW_BYTES = DB * 2;             // 32 at D = 16, else 128
  static constexpr int NCB = D / DB;                   // column blocks of a tile
  static constexpr uint64_t SWIZZLE = D < 64 ? sm90::SWIZZLE_32B : sm90::SWIZZLE_128B;
  static constexpr int ATOM = 8 * ROW_BYTES;  // bytes of 8 swizzled rows: the descriptors' stride offset
  static constexpr int Q_BYTES = BLOCK_M * D * 2;
  static constexpr int KV_BYTES = BLOCK_N * D * 2;  // one K or V tile
  static constexpr int BAR_OFFSET = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int USED = BAR_OFFSET + 64 + 1024;  // barriers, and room to align the base to 1024
  static constexpr int SMEM = USED > MIN_SMEM ? USED : MIN_SMEM;
  static constexpr int PV_N = D < 128 ? D : 128;  // N of one P V wgmma
  static constexpr int PV_SPLIT = D / PV_N;       // 2 at D = 256
};

template <int N>
__device__ __forceinline__ void qk_mma(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64) sm90::wgmma_ss_n64(d, da, db, scale_d);
  else sm90::wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void pv_mma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) sm90::wgmma_rs_n16(d, a, db);
  else if constexpr (N == 64) sm90::wgmma_rs_n64(d, a, db);
  else sm90::wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }

template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, Strides os, float* __restrict__ lse,
    int64_t lse_stride, int B, int S, int T_len, int Hq, int Hkv, int causal, int window, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BLOCK_N = C::BLOCK_N;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms need 1024
  uint8_t* q_tile = smem;                                                           // [NCB][BLOCK_M rows]
  uint8_t* k_tiles = smem + C::Q_BYTES;                                             // [STAGES][NCB][BLOCK_N]
  uint8_t* v_tiles = k_tiles + STAGES * C::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFFSET);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;               // [STAGES]: K and V of a stage have landed
  uint64_t* empty = bars + 1 + STAGES;     // [STAGES]: every consumer is done with a stage

  // Longest q tiles first; within a q tile, the heads of one kv-head side by side.
  const int n_qt = (S + BLOCK_M - 1) / BLOCK_M;
  const int per_tile = B * Hq;
  const int m0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / per_tile) * BLOCK_M;
  const int bh = static_cast<int>(blockIdx.x) % per_tile;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);

  // The kv tiles any row of the block can see.
  const int m_last = min(m0 + BLOCK_M, S) - 1;
  const int k_lo = window > 0 ? max(0, m0 - window + 1) : 0;
  const int k_hi = causal ? min(T_len, m_last + 1) : T_len;
  const int kt0 = k_lo / BLOCK_N;
  const int n_tiles = max(0, (k_hi + BLOCK_N - 1) / BLOCK_N - kt0);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the K/V ring full --------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      sm90::mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int cb = 0; cb < C::NCB; ++cb)
        sm90::tma_load_4d(q_tile + cb * BLOCK_M * C::ROW_BYTES, &tm_q, q_full, cb * C::DB, m0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        sm90::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);  // the first round passes at once
        sm90::mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
        const int k0 = (kt0 + i) * BLOCK_N;
        for (int cb = 0; cb < C::NCB; ++cb) {
          const int off = s * C::KV_BYTES + cb * BLOCK_N * C::ROW_BYTES;
          sm90::tma_load_4d(k_tiles + off, &tm_k, &full[s], cb * C::DB, k0, hk, b);
          sm90::tma_load_4d(v_tiles + off, &tm_v, &full[s], cb * C::DB, k0, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each -------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int wrow0 = m0 + wg * 64;               // this warpgroup's first row
    const int row0 = wrow0 + (t / 32) * 16 + lane / 4;  // this thread's rows: row0 and row0 + 8
    const int col_lane = 2 * (lane % 4);

    float acc[C::PV_SPLIT][C::PV_N / 2];
#pragma unroll
    for (int sp = 0; sp < C::PV_SPLIT; ++sp)
#pragma unroll
      for (int i = 0; i < C::PV_N / 2; ++i) acc[sp][i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // l: this thread's share of the row sum

    const uint32_t q_base = sm90::smem_u32(q_tile) + wg * 64 * C::ROW_BYTES;
    sm90::mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const int k0 = (kt0 + i) * BLOCK_N;
      sm90::mbar_wait(&full[s], (i / STAGES) & 1);

      // S = Q K^T, f32 accumulators.
      float sc[BLOCK_N / 2];
#pragma unroll
      for (int j = 0; j < BLOCK_N / 2; ++j) sc[j] = 0.f;
      const uint32_t k_base = sm90::smem_u32(k_tiles + s * C::KV_BYTES);
      sm90::fence_operands(sc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int cb = kk * 16 / C::DB;            // column block
        const int within = (kk * 16 % C::DB) * 2;  // bytes into the swizzled row
        const uint64_t da =
            sm90::make_desc(q_base + cb * BLOCK_M * C::ROW_BYTES + within, 16, C::ATOM, C::SWIZZLE);
        const uint64_t db =
            sm90::make_desc(k_base + cb * BLOCK_N * C::ROW_BYTES + within, 16, C::ATOM, C::SWIZZLE);
        qk_mma<BLOCK_N>(sc, da, db, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_operands(sc);

      // Scale into the log2 domain; mask only where the tile crosses the
      // diagonal, the window edge or T for some row of this warpgroup.
      const bool need_mask = k0 + BLOCK_N > T_len || (causal && k0 + BLOCK_N - 1 > wrow0) ||
                             (window > 0 && wrow0 + 63 - k0 >= window);
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < BLOCK_N / 2; ++j) {
          const int row = row0 + ((j >> 1) & 1) * 8;
          const int col = k0 + (j >> 2) * 8 + col_lane + (j & 1);
          bool valid = col < T_len;
          if (causal) valid = valid && col <= row;
          if (window > 0) valid = valid && row - col < window;
          sc[j] = valid ? sc[j] * scale_log2 : NEG_INF;
        }
      } else {
#pragma unroll
        for (int j = 0; j < BLOCK_N / 2; ++j) sc[j] *= scale_log2;
      }

      // Online softmax on the fragment: each thread holds 2 rows, a row spans 4 threads.
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < BLOCK_N / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < BLOCK_N / 2; ++j) {
        sc[j] = exp2f(sc[j] - m_run[(j >> 1) & 1]);
        l_run[(j >> 1) & 1] += sc[j];
      }
#pragma unroll
      for (int sp = 0; sp < C::PV_SPLIT; ++sp)
#pragma unroll
        for (int j = 0; j < C::PV_N / 2; ++j) acc[sp][j] *= alpha[(j >> 1) & 1];

      // P as A fragments of the k16 steps over this tile's keys: the f32
      // accumulator pairs of S, as hi = bf16(p) and lo = bf16(p - hi).
      uint32_t p_hi[BLOCK_N / 16][4], p_lo[BLOCK_N / 16][4];
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = sc[8 * kk + 2 * r], y = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          p_hi[kk][r] = as_u32(hi);
          p_lo[kk][r] = as_u32(__floats2bfloat162_rn(x - __low2float(hi), y - __high2float(hi)));
        }

      // O += P V. V's rows are keys with D contiguous: MN-major for this product.
      const uint32_t v_base = sm90::smem_u32(v_tiles + s * C::KV_BYTES);
#pragma unroll
      for (int sp = 0; sp < C::PV_SPLIT; ++sp) sm90::fence_operands(acc[sp]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk)
#pragma unroll
        for (int sp = 0; sp < C::PV_SPLIT; ++sp) {
          const uint32_t addr = v_base + sp * (C::PV_N / C::DB) * BLOCK_N * C::ROW_BYTES + kk * 16 * C::ROW_BYTES;
          const uint64_t dv = sm90::make_desc(addr, BLOCK_N * C::ROW_BYTES, C::ATOM, C::SWIZZLE);
          pv_mma<C::PV_N>(acc[sp], p_hi[kk], dv);
          pv_mma<C::PV_N>(acc[sp], p_lo[kk], dv);
        }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
#pragma unroll
      for (int sp = 0; sp < C::PV_SPLIT; ++sp) sm90::fence_operands(acc[sp]);
      sm90::mbar_arrive(&empty[s]);
    }

    // Epilogue: O / max(l, 1e-30) in bf16; rows >= S are dropped.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / fmaxf(l, 1e-30f);
      if constexpr (LSE) {
        const int row = row0 + r * 8;
        if (lane % 4 == 0 && row < lse_stride) {
          const bool seen = row < S && m_run[r] > 0.5f * NEG_INF;  // some key was visible
          lse[((int64_t)b * Hq + h) * lse_stride + row] =
              seen ? (m_run[r] + log2f(l)) * 0.6931471805599453f : INFINITY;
        }
      }
    }
    __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int sp = 0; sp < C::PV_SPLIT; ++sp)
#pragma unroll
      for (int j = 0; j < C::PV_N / 2; j += 2) {
        const int r = (j >> 1) & 1;
        const int row = row0 + r * 8;
        if (row < S) {
          const int col = sp * C::PV_N + (j >> 2) * 8 + col_lane;
          *reinterpret_cast<__nv_bfloat162*>(ob + row * os.s + col) =
              __floats2bfloat162_rn(acc[sp][j] * inv[r], acc[sp][j + 1] * inv[r]);
        }
      }
  }
}

using sm90::encode_fn;

// A tiled map over a (B, rows, H, D) bf16 tensor with element strides `st`,
// boxes of (box_cols x box_rows) at one (b, h).
bool encode(CUtensorMap* map, const void* base, int B, int rows, int H, int D, Strides st, int box_cols,
            int box_rows, bool swizzle32) {
  return sm90::encode_map(map, base, B, rows, H, D, st.b, st.s, st.h, box_cols, box_rows, swizzle32);
}

// Errors of the host side, apart from the cudaError_t values of a launch.
constexpr int ERR_NO_ENCODER = -1, ERR_TENSOR_MAP = -2;

template <int D, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int64_t lse_stride, int B, int S,
           int T_len, int Hq, int Hkv, int causal, int window, Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  using C = Cfg<D>;
  if (encode_fn() == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, S, Hq, D, qs, C::DB, BLOCK_M, D < 64) ||
      !encode(&tk, k, B, T_len, Hkv, D, ks, C::DB, C::BLOCK_N, D < 64) ||
      !encode(&tv, v, B, T_len, Hkv, D, vs, C::DB, C::BLOCK_N, D < 64))
    return ERR_TENSOR_MAP;
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + BLOCK_M - 1) / BLOCK_M;
  // 1 / sqrt(d) in double then f32, as the TPU kernel, times log2 e for exp2f.
  const float scale_log2 = (float)(1.0 / sqrt((double)D)) * 1.4426950408889634f;
  flash_fwd_wgmma_kernel<D, LSE><<<n_qt * B * Hq, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), os, lse, lse_stride, B, S, T_len, Hq, Hkv, causal, window,
      scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int64_t lse_stride, int B, int S,
           int T_len, int Hq, int Hkv, int causal, int window, Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  if (lse != nullptr)
    return launch<D, true>(q, k, v, o, lse, lse_stride, B, S, T_len, Hq, Hkv, causal, window, qs, ks, vs, os, stream);
  return launch<D, false>(q, k, v, o, nullptr, 0, B, S, T_len, Hq, Hkv, causal, window, qs, ks, vs, os, stream);
}

}  // namespace wgmma_flash

// The FMA kernel. dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window. Strides are
// in elements for the (B, S, H, D) layout; the last axis has stride 1.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                                   int S, int T_len, int Hq, int Hkv, int D, int causal, int window,
                                   int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                                   int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
                                   int64_t o_ss, int64_t o_sh, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(D, q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, qs, ks, vs, os, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, S, T_len, Hq, Hkv, causal, window, qs, ks, vs, os, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// The wgmma kernel: bf16 q, k, v and o, D in {16, 64, 128, 256}. Arguments as
// flash_attention_fwd's, with lse: null, or an f32 buffer of B * Hq rows of
// lse_stride >= S floats (a multiple of 64) for the rows' statistics. TMA
// reads through the strides, so the base pointers must be 16-byte aligned and
// every stride a multiple of 8 elements. Returns 0, a launch's cudaError_t, -1
// when the driver has no cuTensorMapEncodeTiled, or -2 when a tensor map
// cannot be encoded.
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                                         int64_t lse_stride, int B, int S, int T_len, int Hq, int Hkv, int D,
                                         int causal, int window, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                         int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                         int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (lse != nullptr && lse_stride < S) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_WGMMA_CASE(DIM)                                                                                       \
  case DIM:                                                                                                         \
    return wgmma_flash::launch<DIM>(q, k, v, o, lse, lse_stride, B, S, T_len, Hq, Hkv, causal, window, qs, ks, vs, \
                                    os, st);
  switch (D) {
    FLASH_WGMMA_CASE(16)
    FLASH_WGMMA_CASE(64)
    FLASH_WGMMA_CASE(128)
    FLASH_WGMMA_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_WGMMA_CASE
}
