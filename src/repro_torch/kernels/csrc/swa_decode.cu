// Decode attention over a linear or ring KV cache, as CUDA kernels for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/swa_decode.py
// (swa_decode_attention, body _swa_decode_kernel): one query token per
// request, grouped-query heads (G query heads share one KV head), a masked
// softmax over the cache with fp32 accumulators. Slot j of the cache holds
// the token at position slot_pos[j] (-1: empty); it is visible when
//   0 <= slot_pos[j] <= pos  and, if window > 0,  slot_pos[j] > pos - window,
// so one rule covers linear caches (window = 0) and ring caches (window > 0).
//   q     (B, KV, G, dh)  in T (fp32 or bf16)
//   k, v  (B, L, KV, dh)  in T, read in place: row stride KV * dh
//   out   (B, KV, G, dh)  in T
// Masked scores are the finite -2e38 of the TPU kernel, not -inf: a row
// that is masked everywhere gets the mean of V over the L slots, as there.
//
// Bound: ~4 flops per K/V value read (G = 2 at gemma3's 32/16 heads), far
// below the card's flop:byte balance, so the kernel is bound by HBM: every
// slot of K and V is read once.
//
// Design: the TPU kernel carries (max, sum, acc) across the L-tile grid
// axis, which is only right because a TPU grid runs in order. Here the
// cache is split into chunks of kChunk slots (split-K flash decoding):
//   pass 1, grid (chunks, KV, B): q goes to shared memory in fp32; one warp
//     per slot computes the G scores (lanes over dh, a warp sum per head),
//     writing -2e38 for a masked slot without reading its K row; one warp
//     per head takes the chunk's max m and p = exp(s - m), sum s; then one
//     thread per (head, feature) sums p * v over the chunk, skipping the V
//     rows whose p is 0. The chunk's fp32 (m, s, acc) go to a scratch.
//   pass 2, grid (KV, B): rescales the chunks by exp(m_c - max_c m_c) and
//     sums them in chunk order. No atomics: the result repeats run to run.
//   A chunk that is masked everywhere has m = -2e38 and p = 1 on its slots;
//   beside any chunk with a visible slot its weight is exp(-2e38 - M) = 0,
//   and if every chunk is masked all weights are 1 (the mean of V). Slots
//   past L in the last chunk are never read and add nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;            // cache slots per pass-1 block
constexpr int kMaxPerLane = 8;        // dh / 32 for dh <= 256
constexpr float kNegInf = -2.0e38f;   // NEG_INF of the TPU kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Dynamic shared memory of pass 1: q (G, dh) and the chunk's scores (G, kChunk).
__host__ __device__ __forceinline__ size_t smem_bytes(int G, int dh) {
  return sizeof(float) * (size_t)G * (size_t)(dh + kChunk);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_chunks(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ slot_pos, float* __restrict__ part_m,
              float* __restrict__ part_s, float* __restrict__ part_acc, int L, int KV,
              int G, int dh, int pos, int window, int n_chunks) {
  extern __shared__ float smem[];
  float* qs = smem;                    // (G, dh) fp32
  float* ps = smem + (size_t)G * dh;   // (G, kChunk): scores, then p
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = chunk * kChunk;
  const int n_t = min(kChunk, L - t0);
  const int per = dh >> 5;
  const int64_t row = (int64_t)KV * dh;
  const int64_t bh = (int64_t)b * KV + h;
  const T* qb = q + bh * G * dh;
  const T* kb = k + (int64_t)b * L * row + (int64_t)h * dh;
  const T* vb = v + (int64_t)b * L * row + (int64_t)h * dh;
  const float sqrt_dh = sqrtf((float)dh);

  for (int i = threadIdx.x; i < G * dh; i += kThreads) qs[i] = to_f32(qb[i]);
  __syncthreads();

  // scores: one warp per slot, lane l holds features l, l+32, ...
  for (int t = warp; t < n_t; t += kWarps) {
    const int sp = slot_pos[t0 + t];
    const bool ok = sp >= 0 && sp <= pos && (window <= 0 || sp > pos - window);
    if (!ok) {
      for (int g = lane; g < G; g += 32) ps[g * kChunk + t] = kNegInf;
      continue;
    }
    const T* kt = kb + (int64_t)(t0 + t) * row;
    float kr[kMaxPerLane];
#pragma unroll
    for (int e = 0; e < kMaxPerLane; ++e) kr[e] = e < per ? to_f32(kt[e * 32 + lane]) : 0.f;
    for (int g = 0; g < G; ++g) {
      const float* qg = qs + g * dh;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxPerLane; ++e)
        if (e < per) dot += qg[e * 32 + lane] * kr[e];
      dot = warp_sum(dot);
      if (lane == 0) ps[g * kChunk + t] = dot / sqrt_dh;
    }
  }
  __syncthreads();

  // the chunk's max and sum per head; ps becomes p = exp(score - m)
  for (int g = warp; g < G; g += kWarps) {
    float* pg = ps + g * kChunk;
    float m = kNegInf;
    for (int t = lane; t < n_t; t += 32) m = fmaxf(m, pg[t]);
    m = warp_max(m);
    float s = 0.f;
    for (int t = lane; t < n_t; t += 32) {
      const float p = expf(pg[t] - m);
      pg[t] = p;
      s += p;
    }
    s = warp_sum(s);
    if (lane == 0) {
      part_m[(bh * n_chunks + chunk) * G + g] = m;
      part_s[(bh * n_chunks + chunk) * G + g] = s;
    }
  }
  __syncthreads();

  // acc[g, d] = sum_t p[g, t] v[t, d]; a warp shares one g (dh % 32 == 0)
  float* acc_out = part_acc + (bh * n_chunks + chunk) * G * dh;
  for (int i = threadIdx.x; i < G * dh; i += kThreads) {
    const int g = i / dh, d = i - g * dh;
    const float* pg = ps + g * kChunk;
    float acc = 0.f;
    for (int t = 0; t < n_t; ++t) {
      const float p = pg[t];
      if (p != 0.f) acc += p * to_f32(vb[(int64_t)(t0 + t) * row + d]);
    }
    acc_out[i] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_chunks(const float* __restrict__ part_m, const float* __restrict__ part_s,
               const float* __restrict__ part_acc, T* __restrict__ out, int KV, int G,
               int dh, int n_chunks) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t bh = (int64_t)b * KV + h;
  const float* pm = part_m + bh * n_chunks * G;
  const float* psum = part_s + bh * n_chunks * G;
  const float* pa = part_acc + bh * n_chunks * G * dh;
  for (int i = threadIdx.x; i < G * dh; i += kThreads) {
    const int g = i / dh;
    float M = kNegInf;
    for (int c = 0; c < n_chunks; ++c) M = fmaxf(M, pm[c * G + g]);
    float S = 0.f, A = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float w = expf(pm[c * G + g] - M);
      S += w * psum[c * G + g];
      A += w * pa[(int64_t)c * G * dh + i];
    }
    out[bh * G * dh + i] = from_f32<T>(A / fmaxf(S, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* slot_pos,
           void* scratch, void* out, int B, int L, int KV, int G, int dh, int pos,
           int window, cudaStream_t stream) {
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const size_t smem = smem_bytes(G, dh);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_chunks<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t n_stat = (size_t)B * KV * n_chunks * G;
  float* part_m = static_cast<float*>(scratch);
  float* part_s = part_m + n_stat;
  float* part_acc = part_s + n_stat;
  decode_chunks<T><<<dim3(n_chunks, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(slot_pos), part_m, part_s, part_acc, L, KV, G, dh, pos,
      window, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_chunks<T><<<dim3(KV, B), kThreads, 0, stream>>>(
      part_m, part_s, part_acc, static_cast<T*>(out), KV, G, dh, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Cache slots per chunk: the scratch holds B * KV * ceil(L / chunk) * G *
// (dh + 2) floats.
int swa_decode_chunk() { return kChunk; }

// Largest dynamic shared memory pass 1 may take (bytes), and what (G, dh) need.
int swa_decode_smem_limit() { return 227 * 1024; }
long long swa_decode_smem_bytes(int G, int dh) { return (long long)smem_bytes(G, dh); }

// out (B, KV, G, dh) in the input dtype; bf16 != 0 selects bfloat16 q, k, v,
// else fp32. Returns cudaGetLastError() (0 on success).
int swa_decode(const void* q, const void* k, const void* v, const void* slot_pos,
               void* scratch, void* out, int B, int L, int KV, int G, int dh, int pos,
               int window, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, slot_pos, scratch, out, B, L, KV, G, dh,
                                      pos, window, st)
              : launch<float>(q, k, v, slot_pos, scratch, out, B, L, KV, G, dh, pos,
                              window, st);
}

const char* swa_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
