// Fused bottom-layer beam search over the packed neighbour layout, bf16
// blocks (`fused_search_kernel`, K1) or centered s8 code blocks
// (`fused_search_s8_kernel`, K1-s8).
//
// Replaces expann_tpu/ops/pallas_fused.py:_fused_kernel (launcher
// `fused_search` :665, call :717), its "topt" merge only, and its s8 branch
// (:101, :258-262).
//
// What it computes, per query (one thread block each): starting from the
// seeded beam of EF (distance, id) entries, of which the first `ef` are
// live, repeat until done or `max_iters` iterations:
//   * select the E best unexpanded live entries by (d, lane) and mark them
//     expanded; the query is done when the best one is worse than the
//     beam's worst live entry or nothing finite is left (the reference's
//     break rule, src/antitopo_engine.h:588-590; an unfilled beam has a
//     worst of +inf and keeps going);
//   * score the RS packed neighbours of each selected node,
//     d = (|x|^2 + |q|^2) - 2 q.x with q rounded to bf16, f32 sums; on s8
//     blocks q arrives in code space (integer-valued f32, truncated to s8
//     as the TPU kernel's cast does), |q|^2 is taken from the f32 input and
//     q.x is an exact s32 sum of s8 products (__dp4a), so every distance is
//     an exact integer (|code| <= 127, D <= 512 keeps them below 2^24);
//   * per selected node in order: extract its best TOPT by (d, row),
//     flag those whose id is already in the beam (checked against the beam
//     as it stands when that node's turn starts), then offer them in
//     ascending order: each replaces the live worst (d, lane) if strictly
//     smaller.
// ncomp counts RS per selected (non-sentinel) node, padding rows included.
// Unlike the TPU kernel, distances and lanes are kept as separate
// (d, lane) pairs (no low-mantissa lane keys), the expanded flag is its own
// byte (not ~id), and termination is per query (a done query in a TPU
// tile is inert, so the results are the same).
//
// What bounds it on this card: device-memory latency and bandwidth.  One
// expansion reads an RS x D block (128 x 128 x 2 = 32 KB in bf16, 16 KB in
// s8) at a data-dependent address; at the canonical 56k config the packed
// array is 1.84 GB (s8: 0.92 GB) and the 50 MB L2 holds ~3% (~5%) of it,
// so nearly every block comes from HBM.  The merge is a few warp
// reductions over <= 512 entries.
//
// Design: 128 threads per query.  All four warps score: a group of LPR
// lanes (16 for bf16, 8 for s8: one 16-byte load per lane covers a
// 128-element row either way) owns one packed row at a time and reads it
// with coalesced 16-byte loads (a warp covers two bf16 or four s8
// contiguous rows), four rows in flight per group, then reduces its LPR
// partial dots by shuffles.  Warp 0 alone
// runs selection and merge on the beam in shared memory with shuffle
// argmin / argmax over (d, lane) pairs.  Many blocks per SM (up to 16)
// keep enough loads in flight to cover the latency.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_LANE = 8;  // RS <= 256
constexpr int UNROLL = 4;         // packed rows in flight per lane group
constexpr unsigned FULL = 0xffffffffu;
constexpr float FINTH = 1.0e38f;  // "finite": real distances are far below

struct DL {
  float d;
  int l;
};

__device__ __forceinline__ bool dl_less(float ad, int al, float bd, int bl) {
  return ad < bd || (ad == bd && al < bl);
}

__device__ __forceinline__ DL warp_min(DL v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float od = __shfl_xor_sync(FULL, v.d, off);
    const int ol = __shfl_xor_sync(FULL, v.l, off);
    if (dl_less(od, ol, v.d, v.l)) v = DL{od, ol};
  }
  return v;
}

__device__ __forceinline__ DL warp_max(DL v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float od = __shfl_xor_sync(FULL, v.d, off);
    const int ol = __shfl_xor_sync(FULL, v.l, off);
    if (dl_less(v.d, v.l, od, ol)) v = DL{od, ol};
  }
  return v;
}

// best unexpanded live entry by (d, lane); (+inf, INT_MAX) when none
__device__ __forceinline__ DL best_unexpanded(const float* bd, const unsigned char* bx,
                                              int ef, int lane) {
  DL v{INFINITY, INT_MAX};
  for (int j = lane; j < ef; j += 32)
    if (!bx[j] && dl_less(bd[j], j, v.d, v.l)) v = DL{bd[j], j};
  return warp_min(v);
}

// worst live entry by (d, lane)
__device__ __forceinline__ DL worst_live(const float* bd, int ef, int lane) {
  DL v{-INFINITY, -1};
  for (int j = lane; j < ef; j += 32)
    if (dl_less(v.d, v.l, bd[j], j)) v = DL{bd[j], j};
  return warp_max(v);
}

// Block element types: the query as the scorer holds it in shared memory,
// and the partial dot of one 16-byte load against it.
template <typename T>
struct Blk;

template <>
struct Blk<__nv_bfloat16> {
  static constexpr int PER16 = 8;   // elements per 16-byte load
  static constexpr int LPR = 16;    // lanes per 128-element row
  // qs[i]: the query rounded to bf16, as f32
  __device__ __forceinline__ static void stage(float* qs, int i, float v) {
    qs[i] = __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static float dot(const uint4& v, const float* qs, int c, float acc) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      acc = fmaf(f.x, qs[c + 2 * j], acc);
      acc = fmaf(f.y, qs[c + 2 * j + 1], acc);
    }
    return acc;
  }
};

template <>
struct Blk<int8_t> {
  static constexpr int PER16 = 16;
  static constexpr int LPR = 8;
  // the qs region holds the query's s8 codes, packed 4 to a word
  __device__ __forceinline__ static void stage(float* qs, int i, float v) {
    reinterpret_cast<int8_t*>(qs)[i] = (int8_t)(int)v;
  }
  __device__ __forceinline__ static float dot(const uint4& v, const float* qs, int c, float acc) {
    const int* qw = reinterpret_cast<const int*>(qs) + c / 4;
    int s = __dp4a((int)v.x, qw[0], 0);
    s = __dp4a((int)v.y, qw[1], s);
    s = __dp4a((int)v.z, qw[2], s);
    s = __dp4a((int)v.w, qw[3], s);
    return acc + (float)s;  // exact: |partial sums| < 2^24
  }
};

template <typename T>
__device__ __forceinline__ void fused_body(const T* __restrict__ packed,      // (N+1, RS, D)
                                           const float* __restrict__ pnorms,  // (N+1, Rt)
                                           const int* __restrict__ pids,      // (N+1, Rt)
                                           const float* __restrict__ q,       // (B, D)
                                           const float* __restrict__ bd0,     // (B, EF)
                                           const int* __restrict__ bi0,       // (B, EF)
                                           int* __restrict__ obi,
                                           float* __restrict__ obd,  // (B, EF)
                                           int* __restrict__ oncomp,
                                           int* __restrict__ oiters,  // (B,)
                                           int D, int RS, int Rt, int EF, int ef, int max_iters,
                                           int E, int topt, int sentinel) {
  constexpr int PER16 = Blk<T>::PER16;
  constexpr int LPR = Blk<T>::LPR;
  constexpr int GROUPS = THREADS / LPR;
  extern __shared__ float4 smem4[];
  const int NS = E * RS;
  float* qs = reinterpret_cast<float*>(smem4);  // [D] the query as the scorer reads it
  float* sd = qs + D;                           // [NS] scored distances
  int* sid = reinterpret_cast<int*>(sd + NS);   // [NS] their ids
  float* bd = reinterpret_cast<float*>(sid + NS);  // [EF] beam distances
  int* bi = reinterpret_cast<int*>(bd + EF);    // [EF] beam ids
  float* cd = reinterpret_cast<float*>(bi + EF);  // [topt] extracted candidates
  int* ci = reinterpret_cast<int*>(cd + topt);  // [topt]
  int* sel = ci + topt;                         // [E] selected nodes
  int* ctl = sel + E;                           // [1] stop flag
  float* red = reinterpret_cast<float*>(ctl + 1);  // [WARPS] |q|^2 partials
  unsigned char* bx = reinterpret_cast<unsigned char*>(red + WARPS);  // [EF]
  unsigned char* dup = bx + EF;                 // [topt]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = tid / LPR, gl = tid % LPR;

  float part = 0.f;
  for (int i = tid; i < D; i += THREADS) {
    const float v = q[(size_t)b * D + i];
    part = fmaf(v, v, part);
    Blk<T>::stage(qs, i, v);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
  if (lane == 0) red[warp] = part;
  for (int j = tid; j < EF; j += THREADS) {
    bd[j] = fmaxf(bd0[(size_t)b * EF + j], 0.f);
    bi[j] = bi0[(size_t)b * EF + j];
    bx[j] = 0;
  }
  __syncthreads();
  float qn = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) qn += red[w];

  int it = 0, ncomp = 0;
  while (it < max_iters) {
    // ---- selection (warp 0) ----
    if (warp == 0) {
      const DL worst = worst_live(bd, ef, lane);
      bool stop = false;
      for (int e = 0; e < E; ++e) {
        const DL m = best_unexpanded(bd, bx, ef, lane);
        const bool fin = m.d < FINTH;
        if (e == 0) stop = (m.d > worst.d) || !fin;
        const int s = (fin && !stop) ? bi[m.l] : sentinel;
        __syncwarp();
        if (lane == 0) {
          sel[e] = s;
          if (fin) bx[m.l] = 1;
        }
        __syncwarp();
      }
      if (lane == 0) ctl[0] = stop ? 1 : 0;
    }
    __syncthreads();
    ++it;
    if (ctl[0]) break;
    for (int e = 0; e < E; ++e) ncomp += (sel[e] != sentinel) ? RS : 0;

    // ---- scoring (all warps): one packed row per lane group at a time ----
    const int per_g = NS / GROUPS;  // NS is a multiple of GROUPS
    for (int i0 = 0; i0 < per_g; i0 += UNROLL) {
      uint4 raw[UNROLL];
      int node[UNROLL], row[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = grp + GROUPS * (i0 + u);
        node[u] = sentinel;
        row[u] = 0;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i0 + u < per_g) {
          const int e = r / RS;
          row[u] = r - e * RS;
          node[u] = sel[e];
          if (node[u] != sentinel && gl * PER16 < D)
            raw[u] = __ldg(reinterpret_cast<const uint4*>(
                packed + ((size_t)node[u] * RS + row[u]) * D + gl * PER16));
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float acc = 0.f;
        if (node[u] != sentinel) {
          for (int c = gl * PER16; c < D; c += LPR * PER16) {
            const uint4 v = (c == gl * PER16)
                                ? raw[u]
                                : __ldg(reinterpret_cast<const uint4*>(
                                      packed + ((size_t)node[u] * RS + row[u]) * D + c));
            acc = Blk<T>::dot(v, qs, c, acc);
          }
        }
#pragma unroll
        for (int off = LPR / 2; off; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
        if (gl == 0 && i0 + u < per_g) {
          const int r = grp + GROUPS * (i0 + u);
          if (node[u] != sentinel) {
            const size_t a = (size_t)node[u] * Rt + row[u];
            sd[r] = fmaxf((pnorms[a] + qn) - 2.f * acc, 0.f);
            sid[r] = pids[a];
          } else {
            sd[r] = INFINITY;
            sid[r] = sentinel;
          }
        }
      }
    }
    __syncthreads();

    // ---- merge (warp 0): per segment, top-TOPT extraction + insertion ----
    if (warp == 0) {
      for (int e = 0; e < E; ++e) {
        const float* segd = sd + e * RS;
        const int* segi = sid + e * RS;
        unsigned taken = 0u;
        for (int t = 0; t < topt; ++t) {
          DL v{INFINITY, INT_MAX};
#pragma unroll
          for (int s = 0; s < ROWS_PER_LANE; ++s) {
            const int r = lane + 32 * s;
            if (r < RS && !((taken >> s) & 1u) && dl_less(segd[r], r, v.d, v.l))
              v = DL{segd[r], r};
          }
          v = warp_min(v);
          if (v.l != INT_MAX && (v.l & 31) == lane) taken |= 1u << (v.l >> 5);
          if (lane == 0) {
            cd[t] = v.d;
            ci[t] = (v.l == INT_MAX) ? sentinel : segi[v.l];
          }
        }
        __syncwarp();
        for (int t = 0; t < topt; ++t) {
          const int c = ci[t];
          bool hit = false;
          for (int j = lane; j < EF; j += 32) hit |= (bi[j] == c) && (c != sentinel);
          const unsigned any = __ballot_sync(FULL, hit);
          if (lane == 0) dup[t] = any ? 1 : 0;
        }
        __syncwarp();
        DL w = worst_live(bd, ef, lane);
        for (int t = 0; t < topt; ++t) {
          if (dup[t] || !(cd[t] < w.d)) continue;
          __syncwarp();
          if (lane == 0) {
            bd[w.l] = cd[t];
            bi[w.l] = ci[t];
            bx[w.l] = 0;
          }
          __syncwarp();
          w = worst_live(bd, ef, lane);
        }
        __syncwarp();
      }
    }
    // the next selection is warp 0's own work; the other warps wait for it
    // at the barrier after selection, so no barrier is needed here
  }
  __syncthreads();
  for (int j = tid; j < EF; j += THREADS) {
    const bool live = j < ef;
    obd[(size_t)b * EF + j] = live ? bd[j] : INFINITY;
    obi[(size_t)b * EF + j] = live ? bi[j] : sentinel;
  }
  if (tid == 0) {
    oncomp[b] = ncomp;
    oiters[b] = it;
  }
}

// Dynamic shared memory of one block (the layout at the top of fused_body).
int smem_bytes(int D, int RS, int EF, int E, int topt) {
  const int NS = E * RS;
  return 4 * (D + 2 * NS + 2 * EF + 2 * topt + E + 1 + WARPS) + EF + topt;
}

// One named kernel per block type (the build report lists each by name).
#define FUSED_KERNEL(NAME, T)                                                            \
  __global__ void __launch_bounds__(THREADS)                                             \
      NAME(const T* __restrict__ packed, const float* __restrict__ pnorms,               \
           const int* __restrict__ pids, const float* __restrict__ q,                    \
           const float* __restrict__ bd0, const int* __restrict__ bi0,                   \
           int* __restrict__ obi, float* __restrict__ obd, int* __restrict__ oncomp,     \
           int* __restrict__ oiters, int D, int RS, int Rt, int EF, int ef, int max_iters, \
           int E, int topt, int sentinel) {                                              \
    fused_body<T>(packed, pnorms, pids, q, bd0, bi0, obi, obd, oncomp, oiters, D, RS, Rt, EF, \
                  ef, max_iters, E, topt, sentinel);                                     \
  }
FUSED_KERNEL(fused_search_kernel, __nv_bfloat16)
FUSED_KERNEL(fused_search_s8_kernel, int8_t)
#undef FUSED_KERNEL

template <typename T>
int launch(void (*kernel)(const T*, const float*, const int*, const float*, const float*,
                          const int*, int*, float*, int*, int*, int, int, int, int, int, int,
                          int, int, int),
           const void* packed, const void* pnorms, const void* pids, const void* q,
           const void* bd0, const void* bi0, void* obi, void* obd, void* oncomp, void* oiters,
           int B, int D, int RS, int Rt, int EF, int ef, int max_iters, int E, int topt,
           int sentinel, void* stream) {
  if (RS % 16 != 0 || RS > 32 * ROWS_PER_LANE || RS > Rt || ef < 1 || ef > EF || topt < 1 ||
      topt > RS || E < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int smem = smem_bytes(D, RS, EF, E, topt);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)packed, (const float*)pnorms, (const int*)pids, (const float*)q,
      (const float*)bd0, (const int*)bi0, (int*)obi, (float*)obd, (int*)oncomp, (int*)oiters, D,
      RS, Rt, EF, ef, max_iters, E, topt, sentinel);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int expann_fused_search_smem_bytes(int D, int RS, int EF, int E, int topt) {
  return smem_bytes(D, RS, EF, E, topt);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller guarantees: D % 8 == 0, RS % 16 == 0, RS <= 256, RS <= Rt,
// 1 <= ef <= EF, 1 <= topt <= RS, E >= 1.
int expann_fused_search_bf16(const void* packed, const void* pnorms, const void* pids,
                             const void* q, const void* bd0, const void* bi0, void* obi,
                             void* obd, void* oncomp, void* oiters, int B, int D, int RS,
                             int Rt, int EF, int ef, int max_iters, int E, int topt,
                             int sentinel, void* stream) {
  if (D % 8 != 0) return (int)cudaErrorInvalidValue;
  return launch(fused_search_kernel, packed, pnorms, pids, q, bd0, bi0, obi, obd, oncomp,
                oiters, B, D, RS, Rt, EF, ef, max_iters, E, topt, sentinel, stream);
}

// K1-s8: int8 code blocks and a code-space query (integer-valued f32 in
// [-127, 127]); the same contract with D % 16 == 0.
int expann_fused_search_s8(const void* packed, const void* pnorms, const void* pids,
                           const void* q, const void* bd0, const void* bi0, void* obi, void* obd,
                           void* oncomp, void* oiters, int B, int D, int RS, int Rt, int EF,
                           int ef, int max_iters, int E, int topt, int sentinel, void* stream) {
  if (D % 16 != 0) return (int)cudaErrorInvalidValue;
  return launch(fused_search_s8_kernel, packed, pnorms, pids, q, bd0, bi0, obi, obd, oncomp,
                oiters, B, D, RS, Rt, EF, ef, max_iters, E, topt, sentinel, stream);
}

}  // extern "C"
