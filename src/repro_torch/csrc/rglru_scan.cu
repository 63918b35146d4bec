// RG-LRU linear scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py:33
// (_rglru_kernel, launched by rglru_scan_pallas): h_t = a_t * h_{t-1} + b_t
// along the sequence axis for every (batch, feature), h_{-1} = 0, arithmetic
// and the carried state in f32, output in the inputs' dtype. The TPU kernel
// pads S with a = b = 0 and W with zeros and slices the result; these kernels
// mask the ragged edges instead, which gives the same values.
//
// What bounds it on the H100: bytes. Three streams, a and b read once and h
// written once: 3 * B * S * W * sizeof(element). At the prefill shape
// (B = 2, S = 4096, W = 4096, f32) that is 403 MB, 0.120 ms at 3.35 TB/s,
// against ~67 M FMAs.
//
// Two kernels. rglru_chunked_kernel is the one the port runs, forward and
// backward; the sequential kernel it replaced stays as a yardstick
// (rglru_scan_sequential_fwd).
//
// The backward (rglru_scan_bwd; the TPU kernel has none, JAX differentiates
// its XLA scan) reads a, the forward's output h and the output's gradient dh,
// and writes da and db: g_t = dh_t + a_{t+1} g_{t+1} with g_S = 0, then
// db_t = g_t and da_t = g_t h_{t-1} with h_{-1} = 0. Over reversed time,
// u = S-1-t, that is the forward's recurrence g'_u = c_u g'_{u-1} + dh_{S-1-u}
// with the coefficient shifted by one step, c_u = a_{S-u} (0 at u = 0: there
// is no a_S). So the backward is the chunked kernel below with other loads
// and another epilogue (BWD): a thread loads, for each step t of its
// sub-chunk, a_{t+1}, dh_t and h_{t-1} (the shifted rows are the next or the
// previous row of the same array: a thread's last step reads the first row of
// the next sub-chunk's a, its first step the last row of the previous
// sub-chunk's h, each row still read once in all), and writes db_t = g_t and
// da_t = bf16-or-f32(g_t * h_{t-1}) with g in f32. The ragged edges take the
// identity (c = 1, dh = 0) past the start of time, which is the end of the
// reversed scan, and store nothing there; the edge t = S-1 loads c = 0. Bound:
// bytes, 5 * B * S * W * sizeof(element), 0.100 ms at (1, 4096, 4096) f32.
//
// The chunked kernel: a single pass, parallel in time.
// - A block owns (batch, tile of FT features, one chunk of BLOCK_STEPS steps
//   a round). Its WARPS warps split the chunk into sub-chunks of SUB steps,
//   one warp each; a lane owns V neighbouring features, so a warp's row of one
//   time step is one contiguous 16-byte load a lane where W and the pointers
//   allow (V = 4 in f32, 8 in bf16) and one element a lane elsewhere (V = 1,
//   e.g. W = 70). Ragged edges, in W and in S, load the identity a = 1, b = 0
//   and store nothing.
// - Each thread loads its whole sub-chunk of a and b into registers before
//   the dependent chain starts: 2 * SUB independent loads a thread. So the
//   chains per launch are B * W * S / SUB (4.2 M at the prefill shape, against
//   B * W = 8,192 for the sequential kernel), and the bytes in flight scale
//   with the threads resident: 256 B a thread in f32, 32 KB a block. At 96
//   registers (f32) an SM holds 5 blocks of 128 threads, the card 77 clusters
//   of 8, so the prefill shape's 64 clusters run in one wave with up to
//   ~16 MB in flight, where 3.35 TB/s at ~1 us of latency needs ~3.4 MB.
//   Memory is read once: the same registers serve the aggregate and the
//   output pass. (8 warps a block need more registers a thread, so fewer
//   clusters fit and the prefill shape's take more than one wave; 16 steps a
//   thread spill registers.)
// - Each thread scans its sub-chunk from 0 for its aggregate (A, H), A the
//   product of a, H the local scan's last value, so that x -> A * x + H is
//   the sub-chunk's effect on the state. In shared memory one thread per
//   feature folds the warps' aggregates into the block's, in order.
// - The carry travels between blocks inside a thread-block cluster along
//   time, of up to MAX_CLUSTER blocks (the portable size), co-scheduled, so
//   nothing spins on global memory. Each block publishes its aggregate in its
//   own shared memory; after one cluster barrier, every block reads all of
//   the cluster's aggregates through distributed shared memory and applies
//   them to the state in time order itself: its own carry-in is the state
//   after its predecessors, the next round's is the state after all of them.
//   No serial chain runs between blocks. Where S is longer than a cluster's
//   span (MAX_CLUSTER * BLOCK_STEPS steps), the cluster loops in rounds and
//   carries that state on; the published aggregates are double-buffered, so
//   one cluster barrier a round suffices.
// - The state entering each warp's sub-chunk is the block's carry-in with the
//   earlier warps' aggregates applied in order; each thread then runs the
//   recurrence h = fma(a, h, b) from it over the registers and writes h.
// - The carried state stays f32 for bf16 inputs too; only the output is
//   rounded. Every combine runs in a fixed order and no value goes through an
//   atomic, so two launches give the same bits. No workspace, no memset.
// ref.rglru_chunked_ref repeats this order of arithmetic in PyTorch (for the
// backward, on the reversed, shifted inputs).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// the chunked kernel
// ---------------------------------------------------------------------------

// The tiling; kernels/rglru_scan.py holds the same numbers for its plain model
// of this arithmetic and checks them against rglru_scan_tiling at load. The
// defines let chip_smoke.py --scan-tilings build other tilings.
#ifndef RGLRU_SUB
#define RGLRU_SUB 8
#endif
#ifndef RGLRU_WARPS
#define RGLRU_WARPS 4
#endif
constexpr int SUB = RGLRU_SUB;      // steps a thread scans
constexpr int WARPS = RGLRU_WARPS;  // sub-chunks a block scans side by side
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCK_STEPS = SUB * WARPS;
constexpr int MAX_CLUSTER = 8;
constexpr int VEC_BYTES = 16;

// V elements of T, moved as one load or store
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

// The streams of one launch. Forward: a, x = b; writes y = h. Backward: a,
// x = dh, h; writes y = db and da.
template <typename T>
struct Streams {
  const T* a;
  const T* x;
  const T* h;
  T* y;
  T* da;
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> fill(T value) {
  Pack<T, V> p;
#pragma unroll
  for (int v = 0; v < V; ++v) p.x[v] = value;
  return p;
}

template <typename T, int V, bool BWD>
__global__ void __launch_bounds__(THREADS) rglru_chunked_kernel(Streams<T> s, int S, int W, int rounds) {
  constexpr int FT = 32 * V;  // features a block owns; slot p = v * 32 + lane holds feature lane * V + v
  __shared__ float2 part[WARPS][FT];   // each sub-chunk's aggregate (A, H)
  __shared__ float carry[WARPS][FT];   // the state entering each sub-chunk
  __shared__ float2 pub[2][FT];        // the block's aggregate, read by the whole cluster

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t f0 = (int64_t)(blockIdx.x / csize) * FT + lane * V;
  const bool in_w = f0 < W;  // V divides W on the vector path: a lane's group lies wholly inside or outside
  const int64_t Wl = W;
  const int64_t base = (int64_t)blockIdx.y * S * Wl + f0;
  const T one = from_float<T>(1.f), zero = from_float<T>(0.f);
  // row t of a stream, for this thread's features
  auto row = [&](const T* p, int t) { return *reinterpret_cast<const Pack<T, V>*>(p + base + (int64_t)t * Wl); };
  constexpr int SLOTS = (FT + THREADS - 1) / THREADS;  // slots a thread folds: p = threadIdx.x + k * THREADS
  float state[SLOTS] = {};  // the scan's state before this round, for each slot p < FT the thread folds

  for (int r = 0; r < rounds; ++r) {
    // the sub-chunk's first step of the scan: t in the forward, u = S-1-t in the backward
    const int t0 = ((r * csize + rank) * WARPS + warp) * SUB;
    Pack<T, V> pa[SUB], pb[SUB];  // the coefficient and the input of each step
    [[maybe_unused]] Pack<T, V> ph[BWD ? SUB : 1];  // the backward's h_{t-1}
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int u = t0 + i;
      if (in_w && u < S) {
        if constexpr (BWD) {
          const int t = S - 1 - u;
          pa[i] = t + 1 < S ? row(s.a, t + 1) : fill<T, V>(zero);
          pb[i] = row(s.x, t);
          ph[i] = t > 0 ? row(s.h, t - 1) : fill<T, V>(zero);
        } else {
          pa[i] = row(s.a, u);
          pb[i] = row(s.x, u);
        }
      } else {
        pa[i] = fill<T, V>(one);
        pb[i] = fill<T, V>(zero);
        if constexpr (BWD) ph[i] = fill<T, V>(zero);
      }
    }
    // the sub-chunk's aggregate: x -> A * x + H
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float A = 1.f, H = 0.f;
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const float av = to_float(pa[i].x[v]);
        H = fmaf(av, H, to_float(pb[i].x[v]));
        A *= av;
      }
      part[warp][v * 32 + lane] = make_float2(A, H);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {  // the block's aggregate, the warps' folded in order
      const int p = threadIdx.x + k * THREADS;
      if (p < FT) {
        float2 agg = make_float2(1.f, 0.f);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const float2 q = part[w][p];
          agg.y = fmaf(q.x, agg.y, q.y);
          agg.x *= q.x;
        }
        pub[r & 1][p] = agg;
      }
    }
    cluster.sync();  // release the aggregates to the cluster, acquire the others'
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int p = threadIdx.x + k * THREADS;
      if (p < FT) {
        float2 q[MAX_CLUSTER];
#pragma unroll
        for (int j = 0; j < MAX_CLUSTER; ++j)
          q[j] = j < csize ? *cluster.map_shared_rank(&pub[r & 1][p], j) : make_float2(1.f, 0.f);
        float c = state[k], in = 0.f;
#pragma unroll
        for (int j = 0; j < MAX_CLUSTER; ++j) {
          if (j < csize) {
            if (j == rank) in = c;
            c = fmaf(q[j].x, c, q[j].y);
          }
        }
        state[k] = c;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          carry[w][p] = in;
          const float2 e = part[w][p];
          in = fmaf(e.x, in, e.y);
        }
      }
    }
    __syncthreads();
    // the output pass: the recurrence from the sub-chunk's carry-in, over the registers
    float x[V];
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = carry[warp][v * 32 + lane];
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      Pack<T, V> o;
      [[maybe_unused]] Pack<T, V> od;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        x[v] = fmaf(to_float(pa[i].x[v]), x[v], to_float(pb[i].x[v]));
        o.x[v] = from_float<T>(x[v]);
        if constexpr (BWD) od.x[v] = from_float<T>(x[v] * to_float(ph[i].x[v]));
      }
      const int u = t0 + i;
      if (in_w && u < S) {
        const int64_t at = base + (int64_t)(BWD ? S - 1 - u : u) * Wl;
        *reinterpret_cast<Pack<T, V>*>(s.y + at) = o;
        if constexpr (BWD) *reinterpret_cast<Pack<T, V>*>(s.da + at) = od;
      }
    }
  }
  cluster.sync();  // no block leaves while another may still read its pub
}

template <typename T, int V, bool BWD>
cudaLaunchConfig_t chunked_config(int B, int W, int cluster, cudaStream_t stream, cudaLaunchAttribute* attr) {
  constexpr int FT = 32 * V;
  const int tiles = (W + FT - 1) / FT;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * tiles, B);  // the cluster's blocks are neighbours along x: one tile, one batch
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `cluster` blocks that the card holds at once, queried once per
// instantiation and size (cluster 1, 2, 4, 8 -> index 0..3).
template <typename T, int V, bool BWD>
int max_active_clusters(int cluster) {
  static int cached[4] = {-1, -1, -1, -1};
  const int k = cluster == 1 ? 0 : cluster == 2 ? 1 : cluster == 4 ? 2 : 3;
  if (cached[k] < 0) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = chunked_config<T, V, BWD>(1, 32 * V, cluster, nullptr, &attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, rglru_chunked_kernel<T, V, BWD>, &cfg) != cudaSuccess) {
      cudaGetLastError();
      n = 0;
    }
    cached[k] = n;
  }
  return cached[k];
}

template <typename T, int V, bool BWD>
int launch_chunked(const Streams<T>& s, int B, int S, int W, int cluster, cudaStream_t stream) {
  if (max_active_clusters<T, V, BWD>(cluster) < 1) return -1;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = chunked_config<T, V, BWD>(B, W, cluster, stream, &attr);
  const int rounds = (S + cluster * BLOCK_STEPS - 1) / (cluster * BLOCK_STEPS);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, rglru_chunked_kernel<T, V, BWD>, s, S, W, rounds);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % VEC_BYTES == 0; }

// The chunked kernel on one launch's streams (unused ones null): 16-byte
// loads and stores where W and every pointer allow, one element a lane else.
template <typename T, bool BWD>
int launch_streams(const void* a, const void* x, const void* h, void* y, void* da, int B, int S, int W, int cluster,
                   cudaStream_t stream) {
  constexpr int VEC = VEC_BYTES / (int)sizeof(T);
  const Streams<T> s{static_cast<const T*>(a), static_cast<const T*>(x), static_cast<const T*>(h), static_cast<T*>(y),
                     static_cast<T*>(da)};
  const bool vec = W % VEC == 0 && aligned(a) && aligned(x) && aligned(h) && aligned(y) && aligned(da);
  return vec ? launch_chunked<T, VEC, BWD>(s, B, S, W, cluster, stream)
             : launch_chunked<T, 1, BWD>(s, B, S, W, cluster, stream);
}

// ---------------------------------------------------------------------------
// the sequential kernel (the port's first scan, kept as a yardstick)
// ---------------------------------------------------------------------------
//
// One thread per (batch, feature) carries h in a register and walks all S
// steps; neighbouring threads take neighbouring features, so each step's
// loads are coalesced. The next CHUNK steps' a and b are loaded before the
// current chunk's FMA chain. Only B * W chains exist (8,192 at the prefill
// shape, 2 warps an SM), so it is bound by memory latency, not by the rate.

constexpr int SEQ_THREADS = 64;
constexpr int CHUNK = 16;

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
__global__ void __launch_bounds__(SEQ_THREADS) rglru_sequential_kernel(const T* __restrict__ a,
                                                                      const T* __restrict__ b,
                                                                      T* __restrict__ h_out, int S, int W) {
  const int w = blockIdx.x * SEQ_THREADS + threadIdx.x;
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
      hp[(t0 + i) * Wl] = from_float<T>(h);
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      av[i] = an[i];
      bv[i] = bn[i];
    }
  }
  for (int t = full; t < S; ++t) {
    h = fmaf(to_float(ap[t * Wl]), h, to_float(bp[t * Wl]));
    hp[t * Wl] = from_float<T>(h);
  }
}

template <typename T>
int launch_sequential(const void* a, const void* b, void* h, int B, int S, int W, cudaStream_t stream) {
  dim3 grid((W + SEQ_THREADS - 1) / SEQ_THREADS, B);
  rglru_sequential_kernel<T><<<grid, SEQ_THREADS, 0, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                                               static_cast<T*>(h), S, W);
  return (int)cudaGetLastError();
}

bool valid(int B, int S, int W) { return B > 0 && B <= 65535 && S > 0 && W > 0; }

bool valid_cluster(int cluster) { return cluster == 1 || cluster == 2 || cluster == 4 || cluster == MAX_CLUSTER; }

}  // namespace

// a, b, h: contiguous (B, S, W) arrays of one dtype, 0 = float32, 1 = bfloat16;
// cluster: blocks along time in a cluster, 1, 2, 4 or 8. Returns the launch's
// cudaError_t (0 on success), or -1 if the card cannot hold one such cluster.
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int dtype, int B, int S, int W, int cluster,
                              void* stream) {
  if (!valid(B, S, W) || !valid_cluster(cluster)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_streams<float, false>(a, b, nullptr, h, nullptr, B, S, W, cluster, st);
  if (dtype == 1) return launch_streams<__nv_bfloat16, false>(a, b, nullptr, h, nullptr, B, S, W, cluster, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: a, the forward's output h and its gradient dh in; da, db out;
// all contiguous (B, S, W) arrays of one dtype. Arguments and return as
// rglru_scan_fwd's.
extern "C" int rglru_scan_bwd(const void* a, const void* h, const void* dh, void* da, void* db, int dtype, int B,
                              int S, int W, int cluster, void* stream) {
  if (!valid(B, S, W) || !valid_cluster(cluster)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_streams<float, true>(a, dh, h, db, da, B, S, W, cluster, st);
  if (dtype == 1) return launch_streams<__nv_bfloat16, true>(a, dh, h, db, da, B, S, W, cluster, st);
  return (int)cudaErrorInvalidValue;
}

// The clusters of `cluster` blocks the card holds at once for the kernel that
// rglru_scan_fwd (backward = 0) or rglru_scan_bwd (1) would pick for
// (dtype, W, vector) (vector: 16-byte aligned pointers); 0 if none.
extern "C" int rglru_scan_max_active_clusters(int dtype, int W, int vector, int cluster, int backward) {
  if (!valid_cluster(cluster)) return 0;
  if (dtype == 0) {
    if (vector && W % 4 == 0)
      return backward ? max_active_clusters<float, 4, true>(cluster) : max_active_clusters<float, 4, false>(cluster);
    return backward ? max_active_clusters<float, 1, true>(cluster) : max_active_clusters<float, 1, false>(cluster);
  }
  if (dtype == 1) {
    if (vector && W % 8 == 0)
      return backward ? max_active_clusters<__nv_bfloat16, 8, true>(cluster)
                      : max_active_clusters<__nv_bfloat16, 8, false>(cluster);
    return backward ? max_active_clusters<__nv_bfloat16, 1, true>(cluster)
                    : max_active_clusters<__nv_bfloat16, 1, false>(cluster);
  }
  return 0;
}

// The chunked kernel's tiling: out[0] = SUB, out[1] = WARPS, out[2] = MAX_CLUSTER.
extern "C" void rglru_scan_tiling(int* out) {
  out[0] = SUB;
  out[1] = WARPS;
  out[2] = MAX_CLUSTER;
}

// The sequential kernel: same arguments and return as rglru_scan_fwd, no cluster.
extern "C" int rglru_scan_sequential_fwd(const void* a, const void* b, void* h, int dtype, int B, int S, int W,
                                         void* stream) {
  if (!valid(B, S, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_sequential<float>(a, b, h, B, S, W, st);
  if (dtype == 1) return launch_sequential<__nv_bfloat16>(a, b, h, B, S, W, st);
  return (int)cudaErrorInvalidValue;
}
