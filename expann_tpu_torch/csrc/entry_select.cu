// Entry seeds of the fused route (K5): the S nearest entry members of each
// query, written straight into the seed beams.
//
// Replaces no TPU kernel.  The JAX package seeds its beams with
// jax.lax.approx_max_k over the members' distances
// (expann_tpu/models/search.py:574), which XLA lowers to an exact sort off
// the TPU.  A stable sort of the whole (queries x members) matrix on this
// card (torch.sort: two cub segmented radix sorts and an index fill) orders
// up to 65,536 columns a row to keep S = 8; this kernel keeps the S alone.
//
// What it computes, for query row i and member position j < n:
//   d[i, j] = (xn[j] + qn[i]) - 2 G[i, j]
// with round-to-nearest intrinsics, so that no contraction changes a bit:
// the same f32 operations, in the same order, as the plain version's
// elementwise passes.  It keeps the S smallest by (orderable(d), j) (the
// stable sort's order: equal distances keep member order, -0 counts as +0)
// and writes their distances into bd[i, 0:S] and members[j] into
// bi[i, 0:S], through the beams' row stride ld: no intermediate tensors.
//
// What bounds it on this card: the bytes of G, read once (8192 x 20,864 f32
// at the million-row chunk: 684 MB, 0.204 ms at 3.35 TB/s).  xn is read by
// every row but is at most 256 KB, so it stays in L1 / L2.
//
// Design.  A warp owns a row.  Each lane reads
// four columns at a time in 16-byte loads (UNROLL loads in flight, G read
// with the streaming hint), neighbouring lanes on neighbouring addresses,
// and keeps a sorted list of CAP (key, position) pairs in registers, CAP
// the least power of two >= S.  A lane visits its columns in increasing
// order, so a candidate that ties a held key comes after it, and the list
// compares keys alone.  A candidate is dropped at once when its key is not
// below the lane's CAP-th or is above the warp's bound T, the least CAP-th
// key of any lane (that lane holds CAP pairs below the candidate), which
// one `redux.sync` refreshes after each pass.  Then S rounds of a warp
// minimum on (key, position), two `redux.sync`, each pop the winning
// lane's head.  The distances written out are recomputed from G, xn and qn
// at the winning positions: the very bits the selection compared.
//
// One warp a row whatever the batch: on the fused route a chunk's
// traversal takes milliseconds, while a lone warp reads even the widest row
// the dense scan takes (65,536 columns) in 0.13 ms on an H100, so few rows
// need no other mapping.
//
// Contract (the wrapper checks it): 1 <= S <= min(n, S_MAX), B >= 0,
// ld >= S, G (B, n) row-major f32, xn (n,) f32, qn (B,) f32, members (n,)
// int32, 16-byte aligned pointers.  Distances are never NaN (a norm is
// +inf only on the sentinel, whose row is zero).

#include <cuda_runtime.h>
#include <stdint.h>

#include "keys.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int S_MAX = 32;
constexpr int UNROLL = 4;            // 16-byte loads of G in flight a lane
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t PAD = 0xffffffffu;  // an empty slot: above every key

__device__ __forceinline__ float entry_dist(float xn, float qn, float g) {
  return __fsub_rn(__fadd_rn(xn, qn), __fmul_rn(2.0f, g));
}

// A sorted list of CAP (key, position) pairs in registers, ascending by
// key; among equal keys, earlier positions first.
template <int CAP>
struct List {
  uint32_t k[CAP];
  uint32_t p[CAP];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < CAP; ++i) k[i] = p[i] = PAD;
  }

  // (key, pos) with pos above every held position of an equal key
  __device__ __forceinline__ void insert(uint32_t key, uint32_t pos) {
#pragma unroll
    for (int i = CAP - 1; i > 0; --i) {
      const bool shift = key < k[i - 1];
      const bool here = !shift && key < k[i];
      k[i] = shift ? k[i - 1] : (here ? key : k[i]);
      p[i] = shift ? p[i - 1] : (here ? pos : p[i]);
    }
    if (key < k[0]) {
      k[0] = key;
      p[0] = pos;
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int i = 0; i < CAP - 1; ++i) {
      k[i] = k[i + 1];
      p[i] = p[i + 1];
    }
    k[CAP - 1] = p[CAP - 1] = PAD;
  }
};

template <int CAP>
__global__ void __launch_bounds__(THREADS) entry_select_kernel(
    const float* __restrict__ G, const float* __restrict__ xn, const float* __restrict__ qn,
    const int* __restrict__ members, int B, int n, int S, float* __restrict__ bd, int* __restrict__ bi, int ld) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= B) return;
  const float* g = G + (size_t)row * n;
  const float qv = qn[row];
  const bool vec = (n & 3) == 0;  // rows 16-byte aligned

  List<CAP> L;
  L.clear();
  uint32_t T = PAD;  // the warp's bound: no candidate above it can place
  for (int base = 0; base < n; base += 128 * UNROLL) {
    float4 gv[UNROLL], xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = base + 128 * u + 4 * lane;
      if (vec && c + 4 <= n) {
        gv[u] = __ldcs(reinterpret_cast<const float4*>(g + c));
        xv[u] = __ldg(reinterpret_cast<const float4*>(xn + c));
      } else {
        gv[u].x = c < n ? g[c] : 0.0f;
        gv[u].y = c + 1 < n ? g[c + 1] : 0.0f;
        gv[u].z = c + 2 < n ? g[c + 2] : 0.0f;
        gv[u].w = c + 3 < n ? g[c + 3] : 0.0f;
        xv[u].x = c < n ? xn[c] : 0.0f;
        xv[u].y = c + 1 < n ? xn[c + 1] : 0.0f;
        xv[u].z = c + 2 < n ? xn[c + 2] : 0.0f;
        xv[u].w = c + 3 < n ? xn[c + 3] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = base + 128 * u + 4 * lane;
      const float gs[4] = {gv[u].x, gv[u].y, gv[u].z, gv[u].w};
      const float xs[4] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t key = orderable(entry_dist(xs[e], qv, gs[e]));
        if (c + e < n && key <= T && key < L.k[CAP - 1]) L.insert(key, (uint32_t)(c + e));
      }
    }
    T = __reduce_min_sync(FULL, L.k[CAP - 1]);
  }

  // S rounds of the warp's minimum on (key, position): lane r keeps round
  // r's winner, the winning lane pops its head
  uint32_t op = 0;
  for (int r = 0; r < S; ++r) {
    const uint32_t mk = __reduce_min_sync(FULL, L.k[0]);
    const uint32_t mp = __reduce_min_sync(FULL, L.k[0] == mk ? L.p[0] : PAD);
    if (L.k[0] == mk && L.p[0] == mp) L.pop();
    if (lane == r) op = mp;
  }
  if (lane < S) {
    bd[(size_t)row * ld + lane] = entry_dist(xn[op], qv, g[op]);
    bi[(size_t)row * ld + lane] = members[op];
  }
}

template <int CAP>
int launch(const float* G, const float* xn, const float* qn, const int* members, int B, int n, int S, float* bd,
           int* bi, int ld, cudaStream_t stream) {
  entry_select_kernel<CAP><<<(B + WARPS - 1) / WARPS, THREADS, 0, stream>>>(G, xn, qn, members, B, n, S, bd, bi,
                                                                            ld);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller guarantees the contract above.
int expann_entry_select(const void* G, const void* xn, const void* qn, const void* members, int B, int n, int S,
                        void* bd, void* bi, int ld, void* stream) {
  if (B < 0 || n < 1 || S < 1 || S > S_MAX || S > n || ld < S) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const float* g = (const float*)G;
  const float* x = (const float*)xn;
  const float* q = (const float*)qn;
  const int* m = (const int*)members;
  float* d = (float*)bd;
  int* i = (int*)bi;
  cudaStream_t s = (cudaStream_t)stream;
  if (S <= 1) return launch<1>(g, x, q, m, B, n, S, d, i, ld, s);
  if (S <= 2) return launch<2>(g, x, q, m, B, n, S, d, i, ld, s);
  if (S <= 4) return launch<4>(g, x, q, m, B, n, S, d, i, ld, s);
  if (S <= 8) return launch<8>(g, x, q, m, B, n, S, d, i, ld, s);
  if (S <= 16) return launch<16>(g, x, q, m, B, n, S, d, i, ld, s);
  return launch<32>(g, x, q, m, B, n, S, d, i, ld, s);
}

}  // extern "C"
