// Sherman-Morrison DP step of FedPA as two CUDA kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fedpa_dp.py:
//   dp_reduce  (_reduce_kernel, pass A, and the sum over its tiles): for every
//              client c and history row k, <V[c,k], u[c]>, plus <u[c], u[c]>
//              and <u[c], delta[c]>;
//   dp_map     (_map_kernel, pass B):    v[c] = u[c] - sum_k w[c,k] V[c,k],
//              delta'[c] = delta[c] - s[c] v[c];
// and the scalar glue between them in src/repro/kernels/ops.py::dp_step
// (w, a, the scale and c_new), which runs here in the reduce's last block of
// each client. The TPU kernels ran one client per call (vmapped); these take
// the whole cohort with a leading client axis: u, delta (C, d), V (C, lp, d),
// w (C, lp), s (C,). Inputs are fp32 or bf16 (one dtype for u, delta, V);
// math is fp32.
//
// Bound: both passes do ~2 flops per value read, far below the card's
// flop:byte balance, so each is bound by HBM bandwidth.
//   dp_reduce reads C (rows+2) d values and writes C (lp+2) floats;
//   dp_map    reads C (rows+2) d values and writes 2 C d.
// (rows = lp for the public calls; the DP step reads only the live history
// rows, rows = min(lp, t-1): rows k >= t-1 are masked and hold zeros.)
//
// Design: one launch per pass for any cohort size C, nothing between them.
//   Work items are (client, tile) pairs, one CTA each, a tile being
//   kThreads * 32 bytes of each row in the reduce (2048 fp32 or 4096 bf16
//   elements: 210 CTAs at C = 1 and the EMNIST d = 428,350, 3,360 at C = 16)
//   and kThreads * 16 bytes in the map; the hardware schedules them as
//   earlier ones retire. (A persistent grid of occupancy x SMs CTAs walking
//   a strided list of items was slower at C = 6 and 16 when tried: its CTAs
//   move in lockstep through each item's barriers.)
//   Loads are vectors of 16, 8, 4 (or, bf16, 2) bytes: the widest that every
//   row start is aligned to, picked by the wrapper from d, the dtype and the
//   base pointers and passed as a template argument. At d = 428,350 fp32 rows
//   start on 8-byte boundaries only, so 8-byte loads. A row's length is a
//   whole number of vectors, so only the ragged last tile is masked, per
//   vector. Each thread issues all its loads of an item (u, delta and up to
//   KC history rows) before its first multiply-add: ~49 KB in flight per
//   reduce CTA at lp = 4. KC is 4 when at most 4 history rows are read (the
//   FedPA path; fewer registers), else 8 (more rows are swept KC at a time).
//   TMA bulk copies need 16-byte aligned addresses
//   and sizes, which half the rows at that d do not have, and the data is
//   used once, so nothing is staged through shared memory.
//   dp_reduce: each item's rows + 2 sums are reduced in a fixed order (warp
//     shuffles, then the warps in order through shared memory) into per-tile
//     partials in a scratch buffer (C, n_tiles, rows + 2), written by thread
//     0. Thread 0 then fences and draws a ticket from the client's counter
//     (an atomicAdd on an int: no atomic touches a value). The CTA that draws
//     a client's last ticket sums the client's partials in tile order (each
//     thread a fixed set of tiles, then the same fixed tree), writes its sums
//     and sets the counter back to 0. Per-tile partials and the combine do
//     not depend on which CTA ran them or on C, so a client's result is the
//     same bits alone as in any stack (at the same d, dtype and load width),
//     and from run to run.
//   dp_step's reduce: the same, and the CTA that finishes a client then turns
//     its sums into w_k = c_hist_k dots_k (k < t-1, else 0), a = <u,u> -
//     sum_k w_k dots_k (k ascending), scale = (1 + g (t <u,delta> - a) /
//     (1 + g a)) / t and c_new = g / (1 + g a), g = (t-1) rho / t, the
//     formulas of ref.dp_coeffs; w and scale go to scratch, where the map
//     reads them.
//   dp_map: the same items and vector loads; each thread combines its live
//     history rows in registers (k ascending) and stores v and delta' as
//     vectors in the input dtype.
//   The partials, w, scale and counters are scratch that the wrapper keeps
//   per device: they assume that one stream at a time launches these
//   kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Bytes of each row a thread takes per item: 32 in the reduce, 16 in the
// map (whose v and delta' registers would otherwise crowd out its loads).
constexpr int kReduceBytes = 32;
constexpr int kMapBytes = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int VB> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

// A vector of N = VB / sizeof(T) elements, loaded and stored as one access;
// a thread takes kVecs of them (BYTES bytes) per row per item.
template <typename T, int VB, int BYTES>
struct Vec {
  static constexpr int N = VB / (int)sizeof(T);
  static constexpr int kVecs = BYTES / VB;
  using Raw = typename RawOf<VB>::type;

  __device__ static __forceinline__ Raw load(const T* p) {
    return __ldg(reinterpret_cast<const Raw*>(p));
  }
  __device__ static __forceinline__ void unpack(const Raw& r, float (&f)[N]) {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(e[i]);
  }
  __device__ static __forceinline__ void store(T* p, const float (&f)[N]) {
    Raw r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f32<T>(f[i]);
    *reinterpret_cast<Raw*>(p) = r;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// Sums acc[j] over the block for every j < NA, in a fixed order (each
// warp's shuffle tree, then the warps in order); the totals land in
// tot[0..NA). red holds kWarps * NA floats.
template <int NA>
__device__ __forceinline__ void block_sum(float (&acc)[NA], float* red, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const float s = warp_sum(acc[j]);
    if (lane == 0) red[warp * NA + j] = s;
  }
  __syncthreads();
  if (threadIdx.x < NA) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * NA + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

struct ReduceArgs {
  const void* u;
  const void* delta;
  const void* V;
  float* partials;        // scratch (C, n_tiles, rows + 2)
  int* tickets;           // scratch (C,), 0 between launches
  float* vec;             // (C, lp): the dots, or the step's w
  float* s0;              // (C,): <u,u>, or the step's scale
  float* s1;              // (C,): <u,delta>, or the step's a
  float* s2;              // (C,): the step's c_new
  const float* c_hist;    // (C, lp) for the step, else null
  int C, lp, rows, n_tiles;
  int64_t d;
  float g, t;             // the step's (t-1) rho / t and t
};

// The CTA that drew client c's last ticket: sums the client's partials in
// tile order into vec[c] (dots), s0[c] (<u,u>), s1[c] (<u,delta>); for the
// step, thread 0 then turns them into w, scale, a and c_new. Sets the
// client's counter back to 0.
template <int KC>
__device__ __forceinline__ void finish_client(const ReduceArgs& a, int c, float* red,
                                              float* tot) {
  constexpr int NA = KC + 2;
  const int W = a.rows + 2;
  const float* p = a.partials + (int64_t)c * a.n_tiles * W;
  float* vec = a.vec + (int64_t)c * a.lp;
  for (int j0 = 0; j0 < W; j0 += NA) {
    float acc[NA];
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[j] = 0.f;
    for (int t = threadIdx.x; t < a.n_tiles; t += kThreads) {
#pragma unroll
      for (int j = 0; j < NA; ++j)
        if (j0 + j < W) acc[j] += __ldcg(p + (int64_t)t * W + j0 + j);
    }
    block_sum(acc, red, tot);
    const int j = j0 + threadIdx.x;
    if (threadIdx.x < NA && j < W) {
      if (j < a.rows) vec[j] = tot[threadIdx.x];
      else (j == a.rows ? a.s0 : a.s1)[c] = tot[threadIdx.x];
    }
  }
  __syncthreads();  // the sums, written by threads < NA, for thread 0
  if (threadIdx.x != 0) return;
  if (a.c_hist != nullptr) {
    // the step: rows = min(lp, t-1) live rows, the rest weigh 0
    const float uu = a.s0[c], ud = a.s1[c];
    const float* ch = a.c_hist + (int64_t)c * a.lp;
    float wd = 0.f;
    for (int k = 0; k < a.rows; ++k) {
      const float dk = vec[k];
      const float wk = __ldg(ch + k) * dk;
      vec[k] = wk;
      wd += wk * dk;
    }
    for (int k = a.rows; k < a.lp; ++k) vec[k] = 0.f;
    const float an = uu - wd;
    const float den = 1.f + a.g * an;
    a.s0[c] = (1.f + a.g * (a.t * ud - an) / den) / a.t;
    a.s1[c] = an;
    a.s2[c] = a.g / den;
  }
  a.tickets[c] = 0;
}

// One CTA per item (client, tile). KC history rows per register sweep: 4
// when rows <= 4 (the FedPA path; fewer registers, 3 CTAs per SM), else 8.
template <typename T, int VB, int KC>
__global__ void __launch_bounds__(kThreads, KC == 4 ? 3 : 2)
reduce_kernel(const ReduceArgs a) {
  using Vt = Vec<T, VB, kReduceBytes>;
  constexpr int N = Vt::N, kVecs = Vt::kVecs, NA = KC + 2;
  __shared__ float red[kWarps * NA];
  __shared__ float tot[NA];
  __shared__ bool last;
  const int W = a.rows + 2;
  const int64_t nv = a.d / N;                 // vectors per row
  const int c = blockIdx.x / a.n_tiles, tile = blockIdx.x - c * a.n_tiles;
  const T* uc = static_cast<const T*>(a.u) + (int64_t)c * a.d;
  const T* dc = static_cast<const T*>(a.delta) + (int64_t)c * a.d;
  const T* Vc = static_cast<const T*>(a.V) + (int64_t)c * a.lp * a.d;
  float* part = a.partials + ((int64_t)c * a.n_tiles + tile) * W;
  const int64_t v0 = (int64_t)tile * kThreads * kVecs + threadIdx.x;

  for (int k0 = 0; k0 < a.rows; k0 += KC) {
    typename Vt::Raw ru[kVecs], rd[kVecs], rv[KC][kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int64_t v = v0 + (int64_t)i * kThreads;
      const bool in = v < nv;
      ru[i] = in ? Vt::load(uc + v * N) : typename Vt::Raw{};
      rd[i] = (in && k0 == 0) ? Vt::load(dc + v * N) : typename Vt::Raw{};
#pragma unroll
      for (int k = 0; k < KC; ++k)
        rv[k][i] = (in && k0 + k < a.rows)
                       ? Vt::load(Vc + (int64_t)(k0 + k) * a.d + v * N)
                       : typename Vt::Raw{};
    }
    float acc[NA];
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      float fu[N], fx[N];
      Vt::unpack(ru[i], fu);
      Vt::unpack(rd[i], fx);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        acc[KC] += fu[e] * fu[e];
        acc[KC + 1] += fu[e] * fx[e];
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        Vt::unpack(rv[k][i], fx);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[k] += fx[e] * fu[e];
      }
    }
    block_sum(acc, red, tot);
    if (threadIdx.x == 0) {
      for (int k = 0; k < KC && k0 + k < a.rows; ++k) part[k0 + k] = tot[k];
      if (k0 == 0) {
        part[a.rows] = tot[KC];
        part[a.rows + 1] = tot[KC + 1];
      }
    }
  }
  // publish this tile's partials, then draw the client's ticket
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(a.tickets + c, 1) == a.n_tiles - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    finish_client<KC>(a, c, red, tot);
  }
}

struct MapArgs {
  const float* w;         // (C, lp)
  const float* s;         // (C,)
  const void* u;
  const void* delta;
  const void* V;
  void* vout;
  void* dout;
  int C, lp, rows, n_tiles;
  int64_t d;
};

// One CTA per item (client, tile), KC as in reduce_kernel.
template <typename T, int VB, int KC>
__global__ void __launch_bounds__(kThreads)
map_kernel(const MapArgs a) {
  using Vt = Vec<T, VB, kMapBytes>;
  constexpr int N = Vt::N, kVecs = Vt::kVecs;
  const int64_t nv = a.d / N;
  const int c = blockIdx.x / a.n_tiles, tile = blockIdx.x - c * a.n_tiles;
  const int64_t off = (int64_t)c * a.d;
  const T* uc = static_cast<const T*>(a.u) + off;
  const T* dc = static_cast<const T*>(a.delta) + off;
  const T* Vc = static_cast<const T*>(a.V) + (int64_t)c * a.lp * a.d;
  const float* wc = a.w + (int64_t)c * a.lp;
  const int64_t v0 = (int64_t)tile * kThreads * kVecs + threadIdx.x;

  const float sc = __ldg(a.s + c);
  typename Vt::Raw ru[kVecs], rd[kVecs];
  float comb[kVecs][N];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int64_t v = v0 + (int64_t)i * kThreads;
    const bool in = v < nv;
    ru[i] = in ? Vt::load(uc + v * N) : typename Vt::Raw{};
    rd[i] = in ? Vt::load(dc + v * N) : typename Vt::Raw{};
#pragma unroll
    for (int e = 0; e < N; ++e) comb[i][e] = 0.f;
  }
  for (int k0 = 0; k0 < a.rows; k0 += KC) {
    typename Vt::Raw rv[KC][kVecs];
    float wk[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const bool live = k0 + k < a.rows;
      wk[k] = live ? __ldg(wc + k0 + k) : 0.f;
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int64_t v = v0 + (int64_t)i * kThreads;
        rv[k][i] = (live && v < nv) ? Vt::load(Vc + (int64_t)(k0 + k) * a.d + v * N)
                                    : typename Vt::Raw{};
      }
    }
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      if (k0 + k >= a.rows) continue;
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        float fv[N];
        Vt::unpack(rv[k][i], fv);
#pragma unroll
        for (int e = 0; e < N; ++e) comb[i][e] += wk[k] * fv[e];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int64_t v = v0 + (int64_t)i * kThreads;
    if (v >= nv) continue;
    float fu[N], fd[N], fo[N];
    Vt::unpack(ru[i], fu);
    Vt::unpack(rd[i], fd);
#pragma unroll
    for (int e = 0; e < N; ++e) fu[e] -= comb[i][e];
    Vt::store(static_cast<T*>(a.vout) + off + v * N, fu);
#pragma unroll
    for (int e = 0; e < N; ++e) fo[e] = fd[e] - sc * fu[e];
    Vt::store(static_cast<T*>(a.dout) + off + v * N, fo);
  }
}

enum { kReduce = 0, kMap = 1 };

template <typename T, int VB>
const void* kernel_of(int which, int rows) {
  if (rows <= 4)
    return which == kReduce ? reinterpret_cast<const void*>(reduce_kernel<T, VB, 4>)
                            : reinterpret_cast<const void*>(map_kernel<T, VB, 4>);
  return which == kReduce ? reinterpret_cast<const void*>(reduce_kernel<T, VB, 8>)
                          : reinterpret_cast<const void*>(map_kernel<T, VB, 8>);
}

// The instantiation for (kernel, dtype, vector bytes, history rows); null
// for a width the dtype does not have.
const void* pick(int which, int bf16, int vb, int rows) {
  if (bf16) {
    switch (vb) {
      case 16: return kernel_of<__nv_bfloat16, 16>(which, rows);
      case 8: return kernel_of<__nv_bfloat16, 8>(which, rows);
      case 4: return kernel_of<__nv_bfloat16, 4>(which, rows);
      case 2: return kernel_of<__nv_bfloat16, 2>(which, rows);
    }
  } else {
    switch (vb) {
      case 16: return kernel_of<float, 16>(which, rows);
      case 8: return kernel_of<float, 8>(which, rows);
      case 4: return kernel_of<float, 4>(which, rows);
    }
  }
  return nullptr;
}

// Tiles of a row of d elements when each of the kThreads threads takes
// `bytes` bytes of it.
int tiles(long long d, int bf16, int bytes) {
  const int tile = kThreads * bytes / (bf16 ? 2 : 4);
  return (int)((d + tile - 1) / tile);
}

// One CTA per (client, tile) item.
int launch(int which, int bf16, int vb, int rows, void* args, long long items,
           cudaStream_t stream) {
  const void* kernel = pick(which, bf16, vb, rows);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  void* params[] = {args};
  return (int)cudaLaunchKernel(kernel, dim3(items), dim3(kThreads), params, 0, stream);
}

}  // namespace

extern "C" {

// Elements of one tile of the reduce (the same for every vector width of a
// dtype): a row has ceil(d / fedpa_dp_tile(bf16)) tiles.
int fedpa_dp_tile(int bf16) { return kThreads * kReduceBytes / (bf16 ? 2 : 4); }

// dp_reduce over the first `rows` history rows: dots into vec (C, lp) fp32,
// <u,u> into s0 and <u,delta> into s1 (C,). With c_hist != null, the DP
// step's reduce: rows = min(lp, t-1), g = (t-1) rho / t, and vec, s0, s1,
// s2 end as w (0 beyond rows), scale, a and c_new. partials holds C *
// tiles * (rows+2) floats and tickets C ints, all 0. bf16 != 0 selects
// bfloat16 inputs; vb is the vector width in bytes. Returns the launch's
// CUDA error.
int fedpa_dp_reduce(const void* u, const void* delta, const void* V, void* partials,
                    void* tickets, void* vec, void* s0, void* s1, void* s2,
                    const void* c_hist, int C, int lp, int rows, long long d, float g,
                    float t, int bf16, int vb, void* stream) {
  ReduceArgs a{u, delta, V, static_cast<float*>(partials), static_cast<int*>(tickets),
               static_cast<float*>(vec), static_cast<float*>(s0), static_cast<float*>(s1),
               static_cast<float*>(s2), static_cast<const float*>(c_hist), C, lp, rows,
               tiles(d, bf16, kReduceBytes), (int64_t)d, g, t};
  return launch(kReduce, bf16, vb, rows, &a, (long long)C * a.n_tiles,
                static_cast<cudaStream_t>(stream));
}

// dp_map over the first `rows` history rows: vout, dout (C, d) in the input
// dtype; w (C, lp) and s (C,) fp32.
int fedpa_dp_map(const void* w, const void* s, const void* u, const void* delta,
                 const void* V, void* vout, void* dout, int C, int lp, int rows,
                 long long d, int bf16, int vb, void* stream) {
  MapArgs a{static_cast<const float*>(w), static_cast<const float*>(s), u, delta, V, vout,
            dout, C, lp, rows, tiles(d, bf16, kMapBytes), (int64_t)d};
  return launch(kMap, bf16, vb, rows, &a, (long long)C * a.n_tiles,
                static_cast<cudaStream_t>(stream));
}

const char* fedpa_dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
