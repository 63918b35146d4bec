// RG-LRU linear scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py:33
// (_rglru_kernel, launched by rglru_scan_pallas): h_t = a_t * h_{t-1} + b_t
// along the sequence axis for every (batch, feature), h_{-1} = 0, arithmetic
// and h in f32, output in the inputs' dtype. The TPU kernel pads S with
// a = b = 0 and W with zeros and slices the result; this kernel masks the
// ragged W edge instead and loops over exactly S steps, which gives the same
// values.
//
// What bounds it on the H100: bytes. Three streams (a and b read, h written),
// one FMA per element. At the prefill shape (B = 2, S = 4096, W = 4096, f32)
// that is 403 MB, 0.120 ms at 3.35 TB/s, against ~67 M operations.
//
// The design, deliberately simple: one thread per (batch, feature) carries h
// in a register and walks the sequence; neighbouring threads take
// neighbouring features, so each time step's loads and stores are coalesced
// (a warp moves 128 contiguous bytes of f32). The time loop goes in chunks of
// CHUNK steps, and the next chunk's a and b are loaded into registers before
// the current chunk's dependent FMA chain runs, so two chunks' loads are in
// flight behind the chain. 64 threads a block put 128 blocks on the 132 SMs at
// B * W = 8192. Only 8192 sequential chains exist at that shape, 2 warps per
// SM, so the kernel is expected to be bound by memory latency, not by the
// memory rate: the bytes in flight (8192 threads x 2 x CHUNK loads) stay below
// what 3.35 TB/s needs at ~1 us of latency. Splitting the sequence into
// chunks scanned in parallel and joined by a carry pass is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int CHUNK = 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ a, const T* __restrict__ b, int64_t t0, int64_t W,
                                           float (&av)[CHUNK], float (&bv)[CHUNK]) {
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    av[i] = to_float(a[(t0 + i) * W]);
    bv[i] = to_float(b[(t0 + i) * W]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                                             T* __restrict__ h_out, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;  // the ragged feature edge
  const int64_t base = (int64_t)blockIdx.y * S * W + w;
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h_out + base;
  const int64_t Wl = W;
  const int full = S / CHUNK * CHUNK;

  float h = 0.f;
  float av[CHUNK], bv[CHUNK];
  if (full > 0) load_chunk(ap, bp, 0, Wl, av, bv);
  for (int t0 = 0; t0 < full; t0 += CHUNK) {
    float an[CHUNK] = {}, bn[CHUNK] = {};
    if (t0 + CHUNK < full) load_chunk(ap, bp, t0 + CHUNK, Wl, an, bn);  // next chunk, ahead of the chain
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      h = fmaf(av[i], h, bv[i]);
      from_float(hp + (t0 + i) * Wl, h);
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      av[i] = an[i];
      bv[i] = bn[i];
    }
  }
  for (int t = full; t < S; ++t) {
    h = fmaf(to_float(ap[t * Wl]), h, to_float(bp[t * Wl]));
    from_float(hp + t * Wl, h);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* h, int B, int S, int W, cudaStream_t stream) {
  dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                                     static_cast<T*>(h), S, W);
  return cudaGetLastError();
}

}  // namespace

// a, b, h: contiguous (B, S, W) arrays of one dtype, 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t (0 on success).
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int dtype, int B, int S, int W, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, b, h, B, S, W, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, b, h, B, S, W, st);
  return (int)cudaErrorInvalidValue;
}
