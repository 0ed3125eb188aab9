// Sherman-Morrison DP step of FedPA as two CUDA kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fedpa_dp.py:
//   dp_reduce  (_reduce_kernel, pass A): for every client c and history row k,
//              <V[c,k], u[c]>, plus <u[c], u[c]> and <u[c], delta[c]>;
//   dp_map     (_map_kernel, pass B):    v[c] = u[c] - sum_k w[c,k] V[c,k],
//              delta'[c] = delta[c] - s[c] v[c].
// The TPU kernels ran one client per call (vmapped); these take the whole
// cohort with a leading client axis: u, delta (C, d), V (C, lp, d), w (C, lp),
// s (C,). Inputs are fp32 or bf16 (one dtype for u, delta, V); math is fp32.
//
// Bound: both passes do ~2 flops per value read, far below the card's
// flop:byte balance, so each is bound by HBM bandwidth.
//   dp_reduce reads C (lp+2) d values and writes C (lp+2) floats;
//   dp_map    reads C (lp+2) d values and writes 2 C d.
// Design: one read of every input, coalesced (neighbouring threads on
// neighbouring elements), nothing staged through shared memory.
//   dp_reduce: pass 1 has a grid of (d-tiles x C); each thread strides over
//     its tile and keeps up to kChunk history dots (+ <u,u>, <u,delta>) in
//     registers, sweeping the history in chunks of kChunk rows so any lp >= 1
//     is taken. Warp shuffles, then shared memory, reduce each block in a
//     fixed order into per-tile partials (C, n_tiles, lp+2). Pass 2 has one
//     block per client and sums the tiles in a fixed order. No atomics: the
//     result is the same from run to run. The ragged tail of d is masked.
//   dp_map: one thread per (client, element); the combine loops over k in
//     registers, with w read through the read-only cache (one address per
//     warp).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                    // elements per thread per tile
constexpr int kTile = kThreads * kItems;      // elements per reduce block
constexpr int kChunk = 8;                     // history rows per register sweep
constexpr int kAcc = kChunk + 2;              // + <u,u> and <u,delta>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// Sums acc[j] over the block for every j < kAcc, in a fixed order; the totals
// land in tot[0..kAcc). red holds kWarps * kAcc floats.
__device__ __forceinline__ void block_sum(float (&acc)[kAcc], float* red, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const float s = warp_sum(acc[j]);
    if (lane == 0) red[warp * kAcc + j] = s;
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * kAcc + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_partials(const T* __restrict__ u, const T* __restrict__ delta,
                const T* __restrict__ V, float* __restrict__ partials,
                int lp, int64_t d, int n_tiles) {
  __shared__ float red[kWarps * kAcc];
  __shared__ float tot[kAcc];
  const int tile = blockIdx.x, c = blockIdx.y;
  const int64_t base = (int64_t)tile * kTile + threadIdx.x;
  const T* uc = u + (int64_t)c * d;
  const T* dc = delta + (int64_t)c * d;
  const T* Vc = V + (int64_t)c * lp * d;
  float* out = partials + ((int64_t)c * n_tiles + tile) * (lp + 2);

  for (int k0 = 0; k0 < lp; k0 += kChunk) {
    float acc[kAcc];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
    for (int i = 0; i < kItems; ++i) {
      const int64_t e = base + (int64_t)i * kThreads;
      if (e < d) {
        const float ue = to_f32(uc[e]);
        if (k0 == 0) {
          acc[kChunk] += ue * ue;
          acc[kChunk + 1] += ue * to_f32(dc[e]);
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          if (k0 + k < lp) acc[k] += to_f32(Vc[(int64_t)(k0 + k) * d + e]) * ue;
      }
    }
    block_sum(acc, red, tot);
    if (threadIdx.x < kChunk && k0 + (int)threadIdx.x < lp)
      out[k0 + threadIdx.x] = tot[threadIdx.x];
    if (k0 == 0 && threadIdx.x == 0) {
      out[lp] = tot[kChunk];
      out[lp + 1] = tot[kChunk + 1];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
reduce_tiles(const float* __restrict__ partials, float* __restrict__ out,
             int lp, int n_tiles) {
  __shared__ float red[kWarps];
  const int c = blockIdx.x, W = lp + 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* p = partials + (int64_t)c * n_tiles * W;
  for (int j = 0; j < W; ++j) {
    float s = 0.f;
    for (int t = threadIdx.x; t < n_tiles; t += kThreads) s += p[(int64_t)t * W + j];
    s = warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float tot = 0.f;
      for (int w = 0; w < kWarps; ++w) tot += red[w];
      out[(int64_t)c * W + j] = tot;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
map_kernel(const float* __restrict__ w, const float* __restrict__ s,
           const T* __restrict__ u, const T* __restrict__ delta,
           const T* __restrict__ V, T* __restrict__ vout, T* __restrict__ dout,
           int lp, int64_t d) {
  const int c = blockIdx.y;
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= d) return;
  const float* wc = w + (int64_t)c * lp;
  const T* Vc = V + (int64_t)c * lp * d + e;
  float comb = 0.f;
  for (int k = 0; k < lp; ++k) comb += __ldg(wc + k) * to_f32(Vc[(int64_t)k * d]);
  const int64_t i = (int64_t)c * d + e;
  const float v = to_f32(u[i]) - comb;
  vout[i] = from_f32<T>(v);
  dout[i] = from_f32<T>(to_f32(delta[i]) - __ldg(s + c) * v);
}

template <typename T>
int launch_reduce(const void* u, const void* delta, const void* V, void* partials,
                  void* out, int C, int lp, int64_t d, cudaStream_t stream) {
  const int n_tiles = (int)((d + kTile - 1) / kTile);
  reduce_partials<T><<<dim3(n_tiles, C), kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), static_cast<const T*>(V),
      static_cast<float*>(partials), lp, d, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_tiles<<<C, kThreads, 0, stream>>>(static_cast<const float*>(partials),
                                           static_cast<float*>(out), lp, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_map(const void* w, const void* s, const void* u, const void* delta,
               const void* V, void* vout, void* dout, int C, int lp, int64_t d,
               cudaStream_t stream) {
  const int64_t blocks = (d + kThreads - 1) / kThreads;
  map_kernel<T><<<dim3((unsigned)blocks, C), kThreads, 0, stream>>>(
      static_cast<const float*>(w), static_cast<const float*>(s),
      static_cast<const T*>(u), static_cast<const T*>(delta), static_cast<const T*>(V),
      static_cast<T*>(vout), static_cast<T*>(dout), lp, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of d-tiles of one dp_reduce row: the partials scratch holds
// C * fedpa_dp_reduce_tiles(d) * (lp + 2) floats.
int fedpa_dp_reduce_tiles(long long d) { return (int)((d + kTile - 1) / kTile); }

// out (C, lp+2) fp32: [dots_0..dots_{lp-1}, <u,u>, <u,delta>] per client.
// bf16 != 0 selects bfloat16 inputs, else fp32. Returns cudaGetLastError().
int fedpa_dp_reduce(const void* u, const void* delta, const void* V, void* partials,
                    void* out, int C, int lp, long long d, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_reduce<__nv_bfloat16>(u, delta, V, partials, out, C, lp, d, st)
              : launch_reduce<float>(u, delta, V, partials, out, C, lp, d, st);
}

// vout, dout (C, d) in the input dtype; w (C, lp) and s (C,) fp32.
int fedpa_dp_map(const void* w, const void* s, const void* u, const void* delta,
                 const void* V, void* vout, void* dout, int C, int lp, long long d,
                 int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_map<__nv_bfloat16>(w, s, u, delta, V, vout, dout, C, lp, d, st)
              : launch_map<float>(w, s, u, delta, V, vout, dout, C, lp, d, st);
}

const char* fedpa_dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
