// Decode attention over a linear or ring KV cache, as one CUDA kernel for
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
// Bound: ~4 flops per K/V value read per query head (G = 2 at gemma3's 32/16
// heads, 8 at qwen3's 64/8), far below the card's flop:byte balance, so
// the work is bound by HBM: every slot of K and V is read once. The kernel
// is not, unless its arithmetic is cheap per byte: a first version with
// the dots and the PV sums on the fp32 pipes was instruction-bound (with
// the copies taken out it took nearly as long as with them, several times
// the copies' own time; PERF.md). So bf16 runs QK^T and PV on the
// tensor cores (mma.sync m16n8k16, fp32 accumulators; up to 16 query heads
// per CTA, the rows past G zero; G > 16 takes more clusters), with K, V, q
// and p read by ldmatrix; p is rounded to bf16 for PV, and its sum is taken
// over the rounded values. fp32 keeps the fp32 pipes (TF32 would not hold
// the fp32 tolerance): q in registers kHeadChunk heads at a time, a K row
// read as 16-byte vectors by a group of lanes whose partial dots meet in
// shuffles, and a PV pass with no branch per slot.
//
// Design: one launch per call, a thread-block cluster of kCluster CTAs per
// (request, KV head, and in bf16 group of up to 16 query heads); grid
// (kCluster * KV * groups, B).
//   - The cluster's CTAs split the L slots into kCluster contiguous ranges
//     (ceil(L / kCluster) slots each; the last ones may be short or empty).
//   - A CTA walks its range in tiles of kTile slots through a ring of
//     `stages` buffers in shared memory. K and V rows arrive by TMA bulk
//     copies (one cp.async.bulk per row, dh * sizeof(T) bytes, 16-byte
//     aligned since dh % 32 == 0) that complete on an mbarrier per stage,
//     one for K and one for V, so the scores start while V is still on its
//     way. The next tiles' copies stay in flight while the CTA computes on
//     the current one; a stage's K is refilled once the tile's scores are
//     done, its V once its PV is.
//   - An online (m, s, acc) in fp32 runs across the tiles in order, as the
//     Pallas kernel's does across its sequential grid axis: per tile the
//     scores (a warp per 8 slots), the softmax (a warp per head, a lane per
//     slot), then PV (a warp per quarter of the features). K/V rows sit in
//     shared memory 16 bytes apart beyond dh, so ldmatrix and the vector
//     loads meet no bank conflicts.
//   - The CTAs leave their partials (m[G], s[G], acc[G, dh]) in their own
//     shared memory; after a cluster barrier CTA rank r combines feature
//     slice r of every head by reading the kCluster partials through
//     distributed shared memory, in rank order 0..kCluster-1, and writes the
//     output. A last cluster barrier keeps each CTA's shared memory alive
//     until its peers have read it. No global scratch, no atomics, no second
//     pass: the result repeats bit for bit.
//   - A CTA whose range is empty has m = -FLT_MAX, s = acc = 0: it weighs 0
//     in the combine. A range whose slots are all masked has m = -2e38 and
//     p = 1 on its slots; beside any range with a visible slot its weight is
//     exp(-2e38 - M) = 0, and if every range is masked all weights are 1:
//     the mean of V over all L slots.
// Shared memory: stages x 2 x kTile x (dh + 16 bytes) for the ring (stages
// from 2 to kMaxStages, about kRingBytes in all) plus q, p, the scores, acc
// (heads x dh, fp32) and m, s, alpha: ~37 KB at gemma3's shapes in bf16, so
// that with <= 96 registers 5 CTAs share an SM and a gemma3 call's 512 CTAs
// run in one wave. Measured on the H100 (PERF.md), bf16 reaches ~40% of the
// HBM bound at gemma3's shapes: a CTA's time follows its count of tiles, not
// the depth of its ring, and its first tiles wait on the copies that all
// CTAs ask for at once; deeper rings, smaller tiles, other cluster sizes
// and a software-pipelined loop were no faster.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;           // CTAs per (request, KV head): portable size
constexpr int kTile = 32;             // cache slots per tile, one per lane in the softmax
constexpr int kHeadChunk = 4;         // fp32: query heads whose q a lane holds at once
constexpr int kMmaRows = 16;          // bf16: query heads per CTA (the mma's M)
constexpr int kPPitch = kTile + 8;    // bf16: row pitch of p in shared memory
constexpr int kMaxNt = 256 / 32;      // bf16: n-tiles of 8 features per warp in PV
constexpr int kRingBytes = 36 * 1024; // aim of the K/V ring's size per CTA
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 227 * 1024;
constexpr float kNegInf = -2.0e38f;   // NEG_INF of the TPU kernel
constexpr float kEmpty = -FLT_MAX;    // m of a CTA with no slot: weighs 0

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte vector of fp32 from shared memory.
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}

// Two neighbouring fp32 values from shared memory.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
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

// --- mbarriers and TMA bulk copies (PTX) ------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects `bytes` more to land on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Orders this thread's earlier shared-memory accesses before the bulk
// copies it issues next (the copies run in the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// --- tensor cores (PTX) ----------------------------------------------------

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c (16x8, fp32) += a (16x16, bf16, row-major) b (16x8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- sizes ------------------------------------------------------------------

// Query heads per CTA: bf16 takes up to the mma's 16 rows (more heads take
// more clusters), fp32 all G.
__host__ __device__ __forceinline__ int heads_per_cta(int G, int elt) {
  return elt == 2 ? (G < kMmaRows ? G : kMmaRows) : G;
}

// Dynamic shared memory, in byte offsets: the ring of K/V stages (rows
// `ld` elements apart), 2 mbarriers per stage, q (bf16 (gc + 1, dh + 8), the
// last row zero: the mma's rows past gc read it; fp32 (gc, dh)), p (bf16
// only, (gc + 1, kPPitch), the same way), the scores (gc, kTile), acc
// (gc, dh) and m, s, alpha (16 rows on the mma path, else gc).
struct Layout {
  int stages, ld;
  size_t bar, q, p, ps, acc, stat, total;
};

__host__ __device__ __forceinline__ Layout smem_layout(int gc, int dh, int elt) {
  Layout m;
  const bool mma = elt == 2;
  const int rows = mma ? kMmaRows : gc;
  m.ld = dh + 16 / elt;
  const size_t stage = (size_t)2 * kTile * m.ld * elt;
  const int s = (int)(kRingBytes / stage);
  m.stages = s < 2 ? 2 : (s > kMaxStages ? kMaxStages : s);
  size_t o = m.stages * stage;
  m.bar = o;
  o += (size_t)2 * m.stages * sizeof(uint64_t);
  m.q = o;
  o += mma ? (size_t)(gc + 1) * (dh + 8) * 2 : (size_t)gc * dh * sizeof(float);
  m.p = o;
  o += mma ? (size_t)(gc + 1) * kPPitch * 2 : 0;
  o = (o + 15) / 16 * 16;
  m.ps = o;
  o += (size_t)gc * kTile * sizeof(float);
  m.acc = o;
  o += (size_t)gc * dh * sizeof(float);
  m.stat = o;
  o += (size_t)3 * rows * sizeof(float);
  m.total = o;
  return m;
}

// --- the kernel -------------------------------------------------------------

// 5 bf16 CTAs per SM (<= 96 registers, ~37 KB of shared memory at gemma3's
// shapes) hold all 512 CTAs of a gemma3 call at once; fp32 needs more of both.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 5 : 4)
swa_decode_cluster(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ slot_pos, T* __restrict__ out, int L, int KV, int G,
                   int dh, int pos, int window) {
  constexpr bool kMma = sizeof(T) == 2;  // bf16: tensor cores
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int kPerLane = 8;            // fp32: features of a row one lane holds
  constexpr int kNV = kPerLane / kVec;   // fp32: 16-byte vectors per lane and row
  extern __shared__ __align__(128) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int gc = heads_per_cta(G, (int)sizeof(T));
  const int chunks = (G + gc - 1) / gc;
  const int cl = blockIdx.x / kCluster, b = blockIdx.y;
  const int h = cl / chunks, g0 = (cl - h * chunks) * gc;
  const int gq = min(gc, G - g0);  // this CTA's query heads g0 .. g0 + gq - 1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Layout lay = smem_layout(gc, dh, (int)sizeof(T));
  const int stages = lay.stages, ld = lay.ld;
  const int64_t row = (int64_t)KV * dh;
  const int64_t bh = (int64_t)b * KV + h;
  const T* kb = k + (int64_t)b * L * row + (int64_t)h * dh;
  const T* vb = v + (int64_t)b * L * row + (int64_t)h * dh;
  const uint32_t row_bytes = (uint32_t)(dh * sizeof(T));
  const int tile_elems = kTile * ld;

  T* ring = reinterpret_cast<T*>(smem);  // stage s: K at 2s, V at 2s + 1
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  float* ps = reinterpret_cast<float*>(smem + lay.ps);    // (gc, kTile)
  float* acc_s = reinterpret_cast<float*>(smem + lay.acc);  // (gc, dh)
  float* m_s = reinterpret_cast<float*>(smem + lay.stat);   // (rows) each
  const int rows = kMma ? kMmaRows : gc;
  float* s_s = m_s + rows;
  float* al_s = s_s + rows;

  // this CTA's slots [r0, r1)
  const int per = (L + kCluster - 1) / kCluster;
  const int r0 = min(L, rank * per), r1 = min(L, r0 + per);
  const int n_tiles = (r1 - r0 + kTile - 1) / kTile;

  // warp 0 asks for tile i's K (half 0) or V (half 1) rows in stage
  // i % stages, completing on that half's mbarrier
  auto issue = [&](int i, int half) {
    const int s = i % stages;
    const int t0 = r0 + i * kTile;
    const int nt = min(kTile, r1 - t0);
    uint64_t* hb = &bar[half * stages + s];
    if (lane == 0) mbar_expect_tx(hb, nt * row_bytes);
    __syncwarp();
    if (lane < nt)
      bulk_load(ring + (2 * s + half) * tile_elems + lane * ld,
                (half ? vb : kb) + (t0 + lane) * row, row_bytes, hb);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * stages; ++s) mbar_init(&bar[s], 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (warp == 0)
    for (int i = 0; i < min(stages, n_tiles); ++i) {
      issue(i, 0);
      issue(i, 1);
    }
  const T* qb = q + (bh * G + g0) * dh;
  if constexpr (kMma) {
    // q as the mma's A: (gq + 1, dh + 8) bf16, row gq zero; p starts at 0
    T* q_s = reinterpret_cast<T*>(smem + lay.q);
    for (int i = threadIdx.x; i < (gq + 1) * dh; i += kThreads) {
      const int g = i / dh, d = i - g * dh;
      q_s[g * (dh + 8) + d] = g < gq ? qb[i] : from_f32<T>(0.f);
    }
    T* p_s = reinterpret_cast<T*>(smem + lay.p);
    for (int i = threadIdx.x; i < (gq + 1) * kPPitch; i += kThreads) p_s[i] = from_f32<T>(0.f);
  } else {
    float* q_s = reinterpret_cast<float*>(smem + lay.q);
    for (int i = threadIdx.x; i < gq * dh; i += kThreads) {
      q_s[i] = to_f32(qb[i]);
      acc_s[i] = 0.f;
    }
  }
  for (int g = threadIdx.x; g < rows; g += kThreads) {
    m_s[g] = kEmpty;
    s_s[g] = 0.f;
    al_s[g] = 0.f;  // rows past gq keep alpha 0: their acc stays 0
  }
  __syncthreads();

  // fp32 score mapping: `lpr` lanes (a power of two) per K row, `spw` rows
  // per warp
  const int nvr = dh / kVec;  // 16-byte vectors per row
  int lpr = 1;
  while (lpr < nvr && lpr < 32) lpr <<= 1;
  const int spw = 32 / lpr;
  const int sub = lane / lpr, li = lane % lpr;
  const float sqrt_dh = sqrtf((float)dh);
  // bf16 mma fragments: row gid (and gid + 8), columns 2 * tig, 2 * tig + 1
  const int gid = lane >> 2, tig = lane & 3;
  const int ntw = dh / 32;  // PV n-tiles of 8 features per warp
  float o[kMaxNt][4];
#pragma unroll
  for (int j = 0; j < kMaxNt; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % stages;
    const uint32_t parity = (uint32_t)((i / stages) & 1);
    const int t0 = r0 + i * kTile;
    const int nt = min(kTile, r1 - t0);
    T* ks = ring + (2 * s) * tile_elems;
    T* vs = ks + tile_elems;
    // the visibility of slot t0 + lane, loaded before the wait
    bool visible = false;
    if (lane < nt) {
      const int sp = slot_pos[t0 + lane];
      visible = sp >= 0 && sp <= pos && (window <= 0 || sp > pos - window);
    }
    if (kMma && nt < kTile) {
      // V rows past nt are not copied; p = 0 there, and 0 x NaN would
      // still be NaN in the mma, so they must hold finite values
      for (int n = threadIdx.x; n < (kTile - nt) * dh; n += kThreads)
        vs[(nt + n / dh) * ld + n % dh] = from_f32<T>(0.f);
    }
    mbar_wait(&bar[s], parity);

    // scores ps[g, t] = q_g . k_t / sqrt(dh)
    if constexpr (kMma) {
      // warp w: slots 8w .. 8w + 7, all 16 rows; two k-steps per round
      const T* q_s = reinterpret_cast<const T*>(smem + lay.q);
      const T* qa = q_s + min(lane & 15, gq) * (dh + 8) + 8 * (lane >> 4);
      const T* kw = ks + (8 * warp + (lane & 7)) * ld + 8 * (lane >> 3);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < dh; k0 += 32) {
        uint32_t a0[4], a1[4], bk[4];
        ldsm_x4(bk, kw + k0);
        ldsm_x4(a0, qa + k0);
        ldsm_x4(a1, qa + k0 + 16);
        mma_bf16(c, a0, bk[0], bk[1]);
        mma_bf16(c, a1, bk[2], bk[3]);
      }
      const int t = 8 * warp + 2 * tig;
      if (gid < gq) {
        ps[gid * kTile + t] = c[0] / sqrt_dh;
        ps[gid * kTile + t + 1] = c[1] / sqrt_dh;
      }
      if (gid + 8 < gq) {
        ps[(gid + 8) * kTile + t] = c[2] / sqrt_dh;
        ps[(gid + 8) * kTile + t + 1] = c[3] / sqrt_dh;
      }
    } else {
      const float* q_s = reinterpret_cast<const float*>(smem + lay.q);
      for (int c0 = 0; c0 < gq; c0 += kHeadChunk) {
        float qr[kHeadChunk][kPerLane];
#pragma unroll
        for (int c = 0; c < kHeadChunk; ++c)
#pragma unroll
          for (int w = 0; w < kNV; ++w) {
            const int j = li + w * lpr;
            if (c0 + c < gq && j < nvr) {
              const float* qg = q_s + (c0 + c) * dh + j * kVec;
#pragma unroll
              for (int e = 0; e < kVec; e += 4) {
                const float4 u = *reinterpret_cast<const float4*>(qg + e);
                qr[c][w * kVec + e] = u.x;
                qr[c][w * kVec + e + 1] = u.y;
                qr[c][w * kVec + e + 2] = u.z;
                qr[c][w * kVec + e + 3] = u.w;
              }
            } else {
#pragma unroll
              for (int e = 0; e < kVec; ++e) qr[c][w * kVec + e] = 0.f;
            }
          }
        for (int t = warp * spw + sub; t < kTile; t += kWarps * spw) {
          float dot[kHeadChunk];
#pragma unroll
          for (int c = 0; c < kHeadChunk; ++c) dot[c] = 0.f;
          if (t < nt) {
#pragma unroll
            for (int w = 0; w < kNV; ++w) {
              const int j = li + w * lpr;
              if (j < nvr) {
                float x[kVec];
                load16(ks + t * ld + j * kVec, x);
#pragma unroll
                for (int c = 0; c < kHeadChunk; ++c)
#pragma unroll
                  for (int e = 0; e < kVec; ++e) dot[c] += qr[c][w * kVec + e] * x[e];
              }
            }
          }
#pragma unroll
          for (int c = 0; c < kHeadChunk; ++c) {
            if (c0 + c < gq) {  // the same for the whole warp
              for (int off = lpr >> 1; off > 0; off >>= 1)
                dot[c] += __shfl_xor_sync(0xffffffffu, dot[c], off);
              if (li == 0 && t < nt) ps[(c0 + c) * kTile + t] = dot[c] / sqrt_dh;
            }
          }
        }
      }
    }
    __syncthreads();  // K of stage s is free again
    if (warp == 0 && i + stages < n_tiles) {
      fence_proxy_async();
      issue(i + stages, 0);
    }

    // online softmax across tiles: a warp per head, a lane per slot
    for (int g = warp; g < gq; g += kWarps) {
      const float sc = lane < nt ? (visible ? ps[g * kTile + lane] : kNegInf) : kEmpty;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(sc));
      float p = lane < nt ? expf(sc - m_new) : 0.f;
      if constexpr (kMma) {
        // PV takes p in bf16: sum what it takes
        const T pb = from_f32<T>(p);
        p = to_f32(pb);
        reinterpret_cast<T*>(smem + lay.p)[g * kPPitch + lane] = pb;
      } else {
        ps[g * kTile + lane] = p;
      }
      const float psum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        al_s[g] = alpha;
        s_s[g] = s_s[g] * alpha + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    mbar_wait(&bar[stages + s], parity);
    if constexpr (kMma) {
      // o (16, features of warp w) = alpha o + p (16, kTile) v (kTile, features)
      const T* p_s = reinterpret_cast<const T*>(smem + lay.p);
      const T* pp = p_s + min(lane & 15, gq) * kPPitch + 8 * (lane >> 4);
      uint32_t pa[2][4];  // p's slots 0-15 and 16-31
      ldsm_x4(pa[0], pp);
      ldsm_x4(pa[1], pp + 16);
      const float a_lo = al_s[gid], a_hi = al_s[gid + 8];
      const T* vl = vs + lane * ld + warp * (dh / 4);
#pragma unroll
      for (int j = 0; j < kMaxNt; ++j) {
        if (j < ntw) {
          o[j][0] *= a_lo;
          o[j][1] *= a_lo;
          o[j][2] *= a_hi;
          o[j][3] *= a_hi;
          uint32_t bv[4];  // slots 0-7, 8-15, 16-23, 24-31 of features d .. d + 7
          ldsm_x4_trans(bv, vl + 8 * j);
          mma_bf16(o[j], pa[0], bv[0], bv[1]);
          mma_bf16(o[j], pa[1], bv[2], bv[3]);
        }
      }
    } else {
      // acc[g, d:d+2] = alpha_g acc[g, d:d+2] + sum_t p[g, t] v[t, d:d+2]
      const int half = dh >> 1;
      for (int n = threadIdx.x; n < gq * half; n += kThreads) {
        const int g = n / half, d = 2 * (n - g * half);
        const float alpha = al_s[g];
        float2 acc = *reinterpret_cast<const float2*>(acc_s + g * dh + d);
        acc.x *= alpha;
        acc.y *= alpha;
        const float* pg = ps + g * kTile;
        const T* vcol = vs + d;
#pragma unroll 4
        for (int t = 0; t < nt; ++t) {
          const float p = pg[t];
          const float2 x = load2(vcol + t * ld);
          acc.x += p * x.x;
          acc.y += p * x.y;
        }
        *reinterpret_cast<float2*>(acc_s + g * dh + d) = acc;
      }
    }
    __syncthreads();  // V of stage s, the scores and p are free again
    if (warp == 0 && i + stages < n_tiles) {
      fence_proxy_async();
      issue(i + stages, 1);
    }
  }
  if constexpr (kMma) {
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j) {
      if (j < ntw) {
        const int d = warp * (dh / 4) + 8 * j + 2 * tig;
        if (gid < gq) *reinterpret_cast<float2*>(acc_s + gid * dh + d) = make_float2(o[j][0], o[j][1]);
        if (gid + 8 < gq)
          *reinterpret_cast<float2*>(acc_s + (gid + 8) * dh + d) = make_float2(o[j][2], o[j][3]);
      }
    }
  }

  // combine the cluster's partials: rank r writes features [r*fs, (r+1)*fs)
  cluster.sync();
  const int fs = dh / kCluster;
  T* ob = out + (bh * G + g0) * dh;
  for (int n = threadIdx.x; n < gq * fs; n += kThreads) {
    const int g = n / fs, d = rank * fs + (n - g * fs);
    float mr[kCluster];
    float M = kEmpty;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      mr[r] = *cluster.map_shared_rank(m_s + g, r);
      M = fmaxf(M, mr[r]);
    }
    float S = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float w = expf(mr[r] - M);
      S += w * *cluster.map_shared_rank(s_s + g, r);
      A += w * *cluster.map_shared_rank(acc_s + g * dh + d, r);
    }
    ob[g * dh + d] = from_f32<T>(A / fmaxf(S, 1e-30f));
  }
  cluster.sync();  // peers may still read this CTA's shared memory until here
}

template <typename T>
cudaLaunchConfig_t launch_config(int B, int KV, int G, int dh, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  const int gc = heads_per_cta(G, (int)sizeof(T));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * KV * ((G + gc - 1) / gc), B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_layout(gc, dh, (int)sizeof(T)).total;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int prepare(int G, int dh) {
  cudaError_t err = cudaFuncSetAttribute(
      swa_decode_cluster<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return -(int)err;
  err = cudaFuncSetAttribute(swa_decode_cluster<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config<T>(1, 1, G, dh, 0, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, swa_decode_cluster<T>, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return clusters;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* slot_pos, void* out, int B,
           int L, int KV, int G, int dh, int pos, int window, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config<T>(B, KV, G, dh, stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, swa_decode_cluster<T>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(slot_pos), static_cast<T*>(out), L, KV,
      G, dh, pos, window);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most dynamic shared memory a CTA may take (bytes).
int swa_decode_smem_limit() { return kSmemLimit; }

// Dynamic shared memory of one CTA for (G, dh) and the dtype (bytes).
long long swa_decode_smem_bytes(int G, int dh, int bf16) {
  const int elt = bf16 ? 2 : 4;
  return (long long)smem_layout(heads_per_cta(G, elt), dh, elt).total;
}

// Sets the kernel's shared-memory attributes and returns how many clusters
// of it fit on the card at once (0: none), or minus a CUDA error.
int swa_decode_prepare(int G, int dh, int bf16) {
  return bf16 ? prepare<__nv_bfloat16>(G, dh) : prepare<float>(G, dh);
}

// out (B, KV, G, dh) in the input dtype; bf16 != 0 selects bfloat16 q, k, v,
// else fp32. One launch; returns cudaGetLastError() (0 on success).
int swa_decode(const void* q, const void* k, const void* v, const void* slot_pos, void* out,
               int B, int L, int KV, int G, int dh, int pos, int window, int bf16,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, slot_pos, out, B, L, KV, G, dh, pos, window, st)
              : launch<float>(q, k, v, slot_pos, out, B, L, KV, G, dh, pos, window, st);
}

const char* swa_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
