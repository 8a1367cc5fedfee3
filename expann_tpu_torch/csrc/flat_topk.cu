// Flat exact k-NN over a bf16 or s8 corpus: streamed distances + running
// top-k.
//
// Four kernels share the tile code.  `flat_topk_kernel` (K2, bf16) and
// `flat_topk_s8_kernel` (K2-s8) replace
// expann_tpu/ops/pallas_topk.py:_topk_merge_kernel_count (the
// `flat_topk(mode="count")` Pallas kernel, launcher :286, call :325; its s8
// branch :211-220); `flat_topk_fixed_kernel` (K3) and
// `flat_topk_fixed_s8_kernel` (K3-s8) replace :_topk_merge_kernel (:39, the
// `mode="fixed"` branch of the same call; its s8 branch :65-79).  Count and
// fixed compute the same function.
//
// What it computes: for every query q (bf16-rounded, or s8 codes against an
// s8 corpus) the k nearest corpus rows by squared L2,
// d = (|q|^2 + |x|^2) - 2 q.x clamped at 0, with all products and sums in
// f32, ordered by (d, id).  On s8 codes every product and partial sum is an
// integer below 2^24 (|code| <= 127, D <= 512), so the f32 sums are exact
// in any order and d is the exact integer distance rounded once to f32:
// the TPU kernel's s8 x s8 -> s32 product, computed here by staging the
// codes to f32 (exact) in the same tile code; int8 tensor-core `mma` is a
// later redesign.  Selection is EXACT per
// row: the TPU kernel's 128-lane pooling (pallas_topk.py:95-101) and its
// packed (distance | lane) keys are not carried over, so the plain
// reference for this kernel is the exact oracle.  The (B, N) distance
// matrix is never written to device memory.
//
// What bounds it on this card: f32 FMA issue.  B x N x D multiply-adds
// (65536 x 56000 x 128 = 470 G) against ~67 TFLOP/s of non-tensor f32; the
// corpus (56000 x 128 bf16 = 14 MB, s8 7 MB) stays in the 50 MB L2, so
// device memory is not the limit.  Tensor cores (bf16 wgmma, int8 mma)
// would lift the bound ~15x / ~30x; that is later work — these kernels are
// the simple, right ones.
//
// Design: one block of 256 threads per tile of QB=64 queries.  The query
// tile sits in shared memory as f32, transposed (feature-major).  The
// block streams the corpus in tiles of CT=64 rows, each staged in DK=64
// feature chunks, transposed, so that every thread computes a 4x4 register
// micro-tile (4 queries x 4 rows) from two 16-byte shared loads per
// feature.  The 64x64 tile distances go to shared memory; then each warp
// merges 8 queries into a sorted running list in shared memory.  K2: a
// ballot finds the candidates below the query's current k-th (d, id), and
// only those are inserted, warp-cooperatively — the count-then-insert idea
// of the TPU kernel, exact; late tiles rarely insert anything.  K3: exactly
// k passes per tile, each a warp argmin by (d, id), an insertion if it
// beats the list's last entry, and the winner knocked out — the TPU fixed
// kernel's k extract+insert passes, exact (its (d, id) tie-break, :132-134).
// K3 pays k passes on every tile whatever the data, so it is the slower of
// the two; it exists to keep the TPU package's `topk_mode="fixed"`.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;        // queries per block
constexpr int CT = 64;        // corpus rows per tile
constexpr int DK = 64;        // features staged per chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int KMAX = 128;     // largest k (4 list slots per lane)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool pair_less(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// Insert (vd, vi) into the ascending list (Ld, Li) of length k if it beats
// the last entry.  Called by a whole warp with the same (vd, vi).
__device__ void warp_insert(float* Ld, int* Li, int k, float vd, int vi, int lane) {
  if (!pair_less(vd, vi, Ld[k - 1], Li[k - 1])) return;
  int pos = 0;
  for (int s0 = 0; s0 < k; s0 += 32) {
    const int s = s0 + lane;
    const bool before = s < k && pair_less(Ld[s], Li[s], vd, vi);
    pos += __popc(__ballot_sync(FULL, before));
  }
  float nd[KMAX / 32];
  int ni[KMAX / 32];
#pragma unroll
  for (int t = 0; t < KMAX / 32; ++t) {
    const int s = lane + 32 * t;
    nd[t] = 0.f;
    ni[t] = 0;
    if (s < k && s >= pos) {
      if (s == pos) {
        nd[t] = vd;
        ni[t] = vi;
      } else {
        nd[t] = Ld[s - 1];
        ni[t] = Li[s - 1];
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KMAX / 32; ++t) {
    const int s = lane + 32 * t;
    if (s < k && s >= pos) {
      Ld[s] = nd[t];
      Li[s] = ni[t];
    }
  }
  __syncwarp();
}

// Corpus / query element types: how many fit in 16 bytes, and their f32
// values (exact for both).
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int PER16 = 8;
  __device__ __forceinline__ static float value(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ __forceinline__ static void unpack(const uint4& raw, float* f) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(h2[j]);
      f[2 * j] = v.x;
      f[2 * j + 1] = v.y;
    }
  }
};

template <>
struct Elem<int8_t> {
  static constexpr int PER16 = 16;
  __device__ __forceinline__ static float value(int8_t v) { return (float)v; }
  __device__ __forceinline__ static void unpack(const uint4& raw, float* f) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 16; ++j) f[j] = (float)b[j];
  }
};

// The block's shared-memory layout.
struct Tile {
  float* qs;  // [D][QB] query tile, transposed
  float* xs;  // [DK][CT] corpus chunk, transposed
  float* ds;  // [QB][CT] tile distances
  float* qn;  // [QB]
  float* xn;  // [CT]
  float* ld;  // [QB][k] running top-k, ascending
  int* li;
};

__device__ __forceinline__ Tile tile_layout(float* base, int D, int k) {
  Tile s;
  s.qs = base;
  s.xs = s.qs + D * QB;
  s.ds = s.xs + DK * CT;
  s.qn = s.ds + QB * CT;
  s.xn = s.qn + QB;
  s.ld = s.xn + CT;
  s.li = reinterpret_cast<int*>(s.ld + QB * k);
  return s;
}

// Stage the block's QB queries (-> f32, transposed), their squared norms,
// and empty running lists.
template <typename T>
__device__ void load_queries(const Tile& s, const T* __restrict__ q, int q0, int B, int D, int k,
                             int tid) {
  for (int i = tid; i < QB * D; i += THREADS) {
    const int qi = i / D, c = i - qi * D;
    s.qs[c * QB + qi] = (q0 + qi < B) ? Elem<T>::value(q[(size_t)(q0 + qi) * D + c]) : 0.f;
  }
  for (int i = tid; i < QB * k; i += THREADS) {
    s.ld[i] = INFINITY;
    s.li[i] = -1;
  }
  __syncthreads();
  if (tid < QB) {
    float acc = 0.f;
    for (int c = 0; c < D; ++c) {
      const float v = s.qs[c * QB + tid];
      acc = fmaf(v, v, acc);
    }
    s.qn[tid] = acc;
  }
}

// Distances of the QB queries to corpus rows r0 .. r0+CT into s.ds, clamped
// at 0, rows >= n at +inf.  Ends with a barrier: s.ds is complete.
template <typename T>
__device__ void tile_distances(const Tile& s, const T* __restrict__ x, int n, int D, int r0,
                               int tid) {
  constexpr int PER16 = Elem<T>::PER16;
  const int tx = tid & 15, ty = tid >> 4;  // rows 4tx.., queries 4ty..
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float xnorm = 0.f;

  for (int c0 = 0; c0 < D; c0 += DK) {
    __syncthreads();  // the previous chunk (and tile merge) is consumed
    // stage rows r0..r0+CT, features c0..c0+DK: 16-byte loads, one row
    // per thread, conflict-free transposed stores
    for (int i = tid; i < CT * (DK / PER16); i += THREADS) {
      const int row = i % CT, cc = (i / CT) * PER16;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + row < n)
        raw = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(r0 + row) * D + c0 + cc));
      float f[PER16];
      Elem<T>::unpack(raw, f);
#pragma unroll
      for (int j = 0; j < PER16; ++j) s.xs[(cc + j) * CT + row] = f[j];
    }
    __syncthreads();
    if (tid < CT) {
      for (int c = 0; c < DK; ++c) {
        const float v = s.xs[c * CT + tid];
        xnorm = fmaf(v, v, xnorm);
      }
    }
#pragma unroll 8
    for (int c = 0; c < DK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&s.qs[(c0 + c) * QB + 4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&s.xs[c * CT + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  if (tid < CT) s.xn[tid] = xnorm;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 4 * tx + j;
      float d = fmaxf((s.qn[qi] + s.xn[row]) - 2.f * acc[i][j], 0.f);
      if (r0 + row >= n) d = INFINITY;
      s.ds[qi * CT + row] = d;
    }
  }
  __syncthreads();
}

__device__ void store_lists(const Tile& s, int q0, int B, int k, int tid,
                            int* __restrict__ out_ids, float* __restrict__ out_d) {
  __syncthreads();
  for (int i = tid; i < QB * k; i += THREADS) {
    const int qi = i / k;
    if (q0 + qi < B) {
      out_ids[(size_t)q0 * k + i] = s.li[i];
      out_d[(size_t)q0 * k + i] = s.ld[i];
    }
  }
}

// Count mode (K2): a ballot finds the tile's candidates below the query's
// current k-th (d, id); only those are inserted.
template <typename T>
__device__ __forceinline__ void count_body(const T* __restrict__ q,  // (B, D)
                                           const T* __restrict__ x,  // (n, D)
                                           int n, int B, int D, int k,
                                           int* __restrict__ out_ids,    // (B, k)
                                           float* __restrict__ out_d) {  // (B, k)
  extern __shared__ float4 smem4[];
  const Tile s = tile_layout(reinterpret_cast<float*>(smem4), D, k);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * QB;
  load_queries(s, q, q0, B, D, k, tid);

  for (int r0 = 0; r0 < n; r0 += CT) {
    tile_distances(s, x, n, D, r0, tid);
    for (int qi = warp; qi < QB; qi += THREADS / 32) {
      float* Ld = s.ld + qi * k;
      int* Li = s.li + qi * k;
#pragma unroll
      for (int j = 0; j < CT / 32; ++j) {
        const int row = lane + 32 * j;
        const float cd = s.ds[qi * CT + row];
        const int ci = r0 + row;
        const bool cand = r0 + row < n && pair_less(cd, ci, Ld[k - 1], Li[k - 1]);
        unsigned mask = __ballot_sync(FULL, cand);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float vd = __shfl_sync(FULL, cd, src);
          const int vi = __shfl_sync(FULL, ci, src);
          warp_insert(Ld, Li, k, vd, vi, lane);
        }
      }
    }
  }
  store_lists(s, q0, B, k, tid, out_ids, out_d);
}

// Fixed mode (K3): per tile and per query exactly k passes, each a warp
// argmin by (d, id) over the tile's CT candidates, an insertion when it
// beats the list's last entry, and the winner knocked out.  No pre-count.
template <typename T>
__device__ __forceinline__ void fixed_body(const T* __restrict__ q,  // (B, D)
                                           const T* __restrict__ x,  // (n, D)
                                           int n, int B, int D, int k,
                                           int* __restrict__ out_ids,    // (B, k)
                                           float* __restrict__ out_d) {  // (B, k)
  extern __shared__ float4 smem4[];
  const Tile s = tile_layout(reinterpret_cast<float*>(smem4), D, k);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * QB;
  load_queries(s, q, q0, B, D, k, tid);

  for (int r0 = 0; r0 < n; r0 += CT) {
    tile_distances(s, x, n, D, r0, tid);
    for (int qi = warp; qi < QB; qi += THREADS / 32) {
      float* Ld = s.ld + qi * k;
      int* Li = s.li + qi * k;
      float cd[CT / 32];
      int ci[CT / 32];
#pragma unroll
      for (int j = 0; j < CT / 32; ++j) {
        const int row = lane + 32 * j;
        const bool valid = r0 + row < n;
        cd[j] = valid ? s.ds[qi * CT + row] : INFINITY;
        ci[j] = valid ? r0 + row : INT_MAX;
      }
      for (int p = 0; p < k; ++p) {
        float vd = cd[0];
        int vi = ci[0];
#pragma unroll
        for (int j = 1; j < CT / 32; ++j)
          if (pair_less(cd[j], ci[j], vd, vi)) {
            vd = cd[j];
            vi = ci[j];
          }
#pragma unroll
        for (int off = 16; off; off >>= 1) {
          const float od = __shfl_xor_sync(FULL, vd, off);
          const int oi = __shfl_xor_sync(FULL, vi, off);
          if (pair_less(od, oi, vd, vi)) {
            vd = od;
            vi = oi;
          }
        }
        warp_insert(Ld, Li, k, vd, vi, lane);
#pragma unroll
        for (int j = 0; j < CT / 32; ++j)
          if (ci[j] == vi) {
            cd[j] = INFINITY;
            ci[j] = INT_MAX;
          }
      }
    }
  }
  store_lists(s, q0, B, k, tid, out_ids, out_d);
}

// One named kernel per mode and element type (the build report lists
// each by name).
#define FLAT_KERNEL(NAME, BODY, T)                                                   \
  __global__ void __launch_bounds__(THREADS)                                         \
      NAME(const T* __restrict__ q, const T* __restrict__ x, int n, int B, int D, int k, \
           int* __restrict__ out_ids, float* __restrict__ out_d) {                   \
    BODY<T>(q, x, n, B, D, k, out_ids, out_d);                                       \
  }
FLAT_KERNEL(flat_topk_kernel, count_body, __nv_bfloat16)
FLAT_KERNEL(flat_topk_s8_kernel, count_body, int8_t)
FLAT_KERNEL(flat_topk_fixed_kernel, fixed_body, __nv_bfloat16)
FLAT_KERNEL(flat_topk_fixed_s8_kernel, fixed_body, int8_t)
#undef FLAT_KERNEL

int smem_bytes(int D, int k) {
  return (int)sizeof(float) * (D * QB + DK * CT + QB * CT + QB + CT + QB * k) +
         (int)sizeof(int) * QB * k;
}

template <typename T>
int launch(void (*kernel)(const T*, const T*, int, int, int, int, int*, float*), const void* q,
           const void* x, int n, int B, int D, int k, void* out_ids, void* out_d, void* stream) {
  if (k < 1 || k > KMAX || D % DK != 0) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(D, k);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + QB - 1) / QB);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>((const T*)q, (const T*)x, n, B, D, k,
                                                        (int*)out_ids, (float*)out_d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int expann_flat_topk_smem_bytes(int D, int k) { return smem_bytes(D, k); }

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller guarantees: D % 64 == 0, 1 <= k <= 128, rows 16-byte aligned.
int expann_flat_topk_bf16(const void* q, const void* x, int n, int B, int D, int k,
                          void* out_ids, void* out_d, void* stream) {
  return launch(flat_topk_kernel, q, x, n, B, D, k, out_ids, out_d, stream);
}

// The fixed-pass kernel (K3); same contract.
int expann_flat_topk_fixed_bf16(const void* q, const void* x, int n, int B, int D, int k,
                                void* out_ids, void* out_d, void* stream) {
  return launch(flat_topk_fixed_kernel, q, x, n, B, D, k, out_ids, out_d, stream);
}

// K2-s8 and K3-s8: int8 codes for q and x; same contract (D % 64 == 0
// keeps every row 16-byte aligned).
int expann_flat_topk_s8(const void* q, const void* x, int n, int B, int D, int k, void* out_ids,
                        void* out_d, void* stream) {
  return launch(flat_topk_s8_kernel, q, x, n, B, D, k, out_ids, out_d, stream);
}

int expann_flat_topk_fixed_s8(const void* q, const void* x, int n, int B, int D, int k,
                              void* out_ids, void* out_d, void* stream) {
  return launch(flat_topk_fixed_s8_kernel, q, x, n, B, D, k, out_ids, out_d, stream);
}

const char* expann_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
