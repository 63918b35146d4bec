// Flash attention forward for Hopper (sm_90a), CUDA C++ with plain FMAs.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, launched by flash_attention_bhsd): online-softmax attention
// with m, l and acc in f32, GQA (q-head h reads kv-head h / (Hq / Hkv)), the
// kv-padding mask k < T, the causal mask k <= q and the sliding mask
// q - k < window, all counted from 0 (no end-alignment when S < T),
// NEG_INF = -1e30 and l floored at 1e-30. Output in q's dtype.
//
// What bounds it on the H100: operations. At the prefill shape
// (S = T = 2048, D = 128) it does ~4*S*T*D/2 flops per head against
// ~4*(S+T)*D bytes, some 500 operations per byte, above the ~295 at which the
// bf16 tensor cores, not the memory, are the limit. This first version is
// deliberately simple and does not reach the tensor cores: it runs f32 FMAs
// out of shared memory, so shared-memory bandwidth is its real limit. What the
// design does about the bound it can reach:
//   * one thread block per (b, q-head, tile of 64 query rows); the tile of Q
//     and each 64-key tile of K and V are staged once in shared memory and
//     reused by all 64 rows, so device memory is read ~S/64 times less than a
//     row-by-row kernel would;
//   * the kv loop is bounded by the causal diagonal and the window start, so
//     tiles that lie wholly masked are never loaded (the TPU kernel's TODO);
//   * q, k, v and o are read and written in the model's (B, S, H, D) layout
//     through strides, so no transpose copy is made;
//   * shared-memory rows are padded by one float so the 4 threads of a row and
//     the 8 rows of a warp hit distinct banks.
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

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

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window. Strides are
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
