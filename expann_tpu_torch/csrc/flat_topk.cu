// Flat exact k-NN over a bf16 or s8 corpus: streamed distances + running
// top-k.
//
// Which TPU kernels.  `flat_topk_kernel` (K2, bf16) and `flat_topk_s8_kernel`
// (K2-s8) replace expann_tpu/ops/pallas_topk.py:_topk_merge_kernel_count
// (the `flat_topk(mode="count")` Pallas kernel, launcher :286, call :325; its
// s8 branch :211-220).  `flat_topk_fixed_kernel` (K3) and
// `flat_topk_fixed_s8_kernel` (K3-s8) replace :_topk_merge_kernel (:39, the
// `mode="fixed"` branch of the same call; its s8 branch :65-79).  Count and
// fixed compute the same function.
//
// What it computes: for every query q (bf16-rounded, or s8 codes against an
// s8 corpus) the k nearest corpus rows by squared L2,
// d = (|q|^2 + |x|^2) - 2 q.x clamped at 0, ordered by (d, id); rows >= n
// are +inf / id -1.  On bf16 the products are exact and the sums f32.  On
// s8 codes q.x, |q|^2 and |x|^2 are exact integers (the TPU kernel's
// s8 x s8 -> s32 product) and d is formed in int32 and rounded once to f32:
// for D <= 512 every term is below 2^24 (|code| <= 127), so the plain
// version's f32 arithmetic rounds the same exact value the same way and the
// two are bit-identical.  Selection is EXACT per row:
// the TPU kernel's 128-lane pooling (pallas_topk.py:95-101) and its packed
// (distance | lane) keys are not carried over, so the plain reference for
// these kernels is the exact oracle.  The (B, N) distance matrix is never
// written to device memory.
//
// The tile, shared by all four kernels: tensor-core distance tiles.
//   Bound on this card: operations.  B x N x D multiply-adds
//   (16384 x 56000 x 128 = 117 G per call) against the tensor cores' dense
//   989 TFLOP/s in bf16 and 1,979 TOP/s in int8: 0.24 / 0.12 ms.  The f32
//   FMA tile these kernels had before (4 x 4 register micro-tiles of `fmaf`)
//   was bound by the 67 TFLOP/s of non-tensor f32 instead, 15x / 30x lower.
//   The corpus (56000 x 128: 14 MB bf16, 7 MB s8) stays in the 50 MB L2; each
//   block streams all of it, so L2 carries B / QB corpus copies per call.
//   Design: one block of 256 threads (8 warps) per QB = 64 queries.
//   - Warp w owns query rows 16 (w % 4) .. +15 and tile rows 32 (w / 4) .. +31:
//     four m16n8 `mma.sync` tiles, `m16n8k16.row.col.f32.bf16.bf16.f32` (f32
//     accumulation) or `m16n8k32.row.col.s32.s8.s8.s32` (exact).  Both take
//     32 bytes of a row per k-step and the same fragment layout in bytes, so
//     the data movement is one code for both types.
//   - Queries in registers: the warp's 16 query rows of the first 256 bytes of
//     features (128 bf16 or 256 s8, the whole row on the canonical D=128) are
//     loaded once as A fragments (8 k-steps x 4 registers) and kept for the
//     whole corpus loop.  Wider rows read the rest of their A fragments from
//     global memory (L1) per chunk.
//   - Corpus tiles of CT = 64 rows stream in their own type through a ring of
//     NST = 3 slots of 64 rows x 256 bytes, filled by 16-byte `cp.async.cg`
//     copies (rows >= n zero-filled) two items ahead, with
//     `cp.async.wait_group` and one block barrier per item.  An item is one
//     256-byte chunk of a tile's rows (one item per tile on D=128).  Slot rows
//     are padded to 272 bytes, so `ldmatrix.x4` (B fragments, two n-tiles per
//     load) hits eight distinct 16-byte bank groups.
//   - Epilogue: |x|^2 per tile row from the staged slot (f32 sums of bf16
//     values, `__dp4a` for s8), |q|^2 once per query; d = max((qn + xn) -
//     2 dot, 0), in int32 on s8 and converted once; the (QB x CT) distances go
//     to the shared `ds` tile (row stride CT + 8: conflict-free float2
//     stores).  Then each warp merges the tile into the running lists of
//     8 queries, by the kernel's selection (below).
//   - Why `mma.sync` and not `wgmma`: at even 30% of `mma.sync`'s rate the
//     product is under 1 ms per 16384 x 56000 call, below what the merge and
//     the per-tile barriers take; `wgmma` (with TMA and warp specialisation) is
//     the lever once a trace shows the product as the limit.
//   Tile shape: QB = 64 keeps 256 blocks on the main path's B = 16384, two
//   resident per SM (registers capped at 128 a thread) on 132 SMs; CT = 64
//   gives each warp 16 x 32 outputs (16 accumulators) and each query 64
//   candidates per tile.  Shared memory: 3 x 17 KB ring + 18 KB ds + 512 k
//   bytes of running lists (74.5 KiB at k=10, 133.5 KiB at k=128), for any
//   D % 64 == 0.  K3 shares K2's tile, so the two compute the same distances
//   bit for bit and, both ordering by (d, id), return the same lists.
//
// K2 / K2-s8 select by count-then-insert: per query a warp ballot finds the
// tile's candidates below the query's current k-th (d, id) and only those are
// inserted (the TPU count kernel's idea, exact; late tiles rarely insert
// anything).
//
// K3 / K3-s8 select by a data-oblivious compare-exchange network, the TPU
// fixed kernel's idea (k extract+insert passes on every tile, whatever the
// data, :113-140) without its serial passes: a warp argmin costs ~270 ns a
// step on this card and a compare-exchange stage 13-30 ns (P4's `reduce3`
// against `stage` / `stage64`).  Per query and tile: a bitonic sort of the 64
// candidates (21 stages, 15 of them shuffles), then a merge with the running
// list padded to the power of two P >= k (1 + log2 P stages); details at
// `NetworkMerge`.  Its cost depends on k only through P, never on the
// distances: no ballot pre-filter and no early exit, which would make it K2.
// What bounds it: shuffles and compare-exchange instructions, ~18 shuffle
// stages a query and tile at k <= 16, and not the tile's operations.  Order
// is by (d, id) on one 64-bit key, so ties break by id as in the plain
// version's stable sort.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;        // queries per block
constexpr int CT = 64;        // corpus rows per tile
constexpr int THREADS = 256;  // 8 warps
constexpr int KMAX = 128;     // largest k (4 list slots per lane)
constexpr unsigned FULL = 0xffffffffu;

// the tensor-core tile
constexpr int CHUNK = 256;              // row bytes per ring item
constexpr int ROW_STRIDE = CHUNK + 16;  // padded slot row: ldmatrix conflict-free
constexpr int SLOT = CT * ROW_STRIDE;   // bytes per ring slot
constexpr int NST = 3;                  // ring slots
constexpr int KSTEPS = CHUNK / 32;      // mma k-steps per item (32 row bytes each)
constexpr int DS_STRIDE = CT + 8;       // ds row stride (floats)

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

__device__ void store_lists(const float* ld, const int* li, int q0, int B, int k, int tid,
                            int* __restrict__ out_ids, float* __restrict__ out_d) {
  __syncthreads();
  for (int i = tid; i < QB * k; i += THREADS) {
    const int qi = i / k;
    if (q0 + qi < B) {
      out_ids[(size_t)q0 * k + i] = li[i];
      out_d[(size_t)q0 * k + i] = ld[i];
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `bytes` = 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 address matrix i's rows
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The element type's tensor-core product, squared norms and distance.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using acc_t = float;
  // c += a b over one k-step of 16 features: exact bf16 products, f32 sums
  __device__ __forceinline__ static void mma(acc_t* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // acc + the squares of 16 bytes (8 values)
  __device__ __forceinline__ static acc_t sq16(const uint4& raw, acc_t acc) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(h2[j]);
      acc = fmaf(v.x, v.x, acc);
      acc = fmaf(v.y, v.y, acc);
    }
    return acc;
  }
  __device__ __forceinline__ static float dist(acc_t qn, acc_t xn, acc_t dot) {
    return fmaxf((qn + xn) - 2.f * dot, 0.f);
  }
};

template <>
struct Mma<int8_t> {
  using acc_t = int;
  // c += a b over one k-step of 32 codes: s8 x s8 -> s32, exact
  __device__ __forceinline__ static void mma(acc_t* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static acc_t sq16(const uint4& raw, acc_t acc) {
    acc = __dp4a((int)raw.x, (int)raw.x, acc);
    acc = __dp4a((int)raw.y, (int)raw.y, acc);
    acc = __dp4a((int)raw.z, (int)raw.z, acc);
    return __dp4a((int)raw.w, (int)raw.w, acc);
  }
  // the exact integer distance, rounded once
  __device__ __forceinline__ static float dist(acc_t qn, acc_t xn, acc_t dot) {
    return fmaxf((float)(qn + xn - 2 * dot), 0.f);
  }
};

// Ring item `it` (tile it / nch, row bytes from (it % nch) * CHUNK) into the
// slot at `slot`: CT rows by 16-byte copies, rows >= n zero-filled.  Commits
// one group, empty past the last item, so every thread counts groups alike.
__device__ __forceinline__ void stage_item(uint32_t slot, const char* __restrict__ x, int n, int RB,
                                           int nch, int it, int items, int tid) {
  if (it < items) {
    const int r0 = (it / nch) * CT, c0 = (it % nch) * CHUNK;
    const int pieces = min(CHUNK, RB - c0) / 16;  // 4, 8, 12 or 16 per row
    const bool pow2 = (pieces & (pieces - 1)) == 0;
    const int shift = __ffs(pieces) - 1;
    for (int p = tid; p < CT * pieces; p += THREADS) {
      const int row = pow2 ? p >> shift : p / pieces, col = (p - row * pieces) * 16;
      const bool in = r0 + row < n;
      cp_async16(slot + row * ROW_STRIDE + col, x + (in ? (size_t)(r0 + row) * RB + c0 + col : 0), in ? 16 : 0);
    }
  }
  cp_async_commit();
}

// The A fragment of one k-step from a lane's two query rows (null: zeros):
// rows g / g+8, bytes off .. off+3 and off+16 .. off+19.
__device__ __forceinline__ void load_a(uint32_t* a, const char* ra, const char* rb, int off) {
  a[0] = ra ? __ldg(reinterpret_cast<const uint32_t*>(ra + off)) : 0u;
  a[1] = rb ? __ldg(reinterpret_cast<const uint32_t*>(rb + off)) : 0u;
  a[2] = ra ? __ldg(reinterpret_cast<const uint32_t*>(ra + off + 16)) : 0u;
  a[3] = rb ? __ldg(reinterpret_cast<const uint32_t*>(rb + off + 16)) : 0u;
}

// ---------------------------------------------------------------------------
// The selections, run by each warp once a tile's distances are in `ds`, on
// QUERIES of its queries at a time (`row` and the rows 8, 16, ... below it):
// `row` is a query's ds row (CT distances, rows >= n at +inf), (Ld, Li) its
// running list of k, ascending by (d, id); r0 the tile's first corpus row.
// ---------------------------------------------------------------------------

// K2: count-then-insert.  A ballot finds the tile's candidates below the
// query's current k-th (d, id); only those are inserted.
struct CountMerge {
  static constexpr int QUERIES = 1;
  __device__ __forceinline__ static void merge(const float* row, float* Ld, int* Li, int k, int r0, int n,
                                               int lane) {
#pragma unroll
    for (int j = 0; j < CT / 32; ++j) {
      const int c = lane + 32 * j;
      const float cd = row[c];
      const int ci = r0 + c;
      const bool cand = r0 + c < n && pair_less(cd, ci, Ld[k - 1], Li[k - 1]);
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
};

// K3: a compare-exchange network on 64-bit keys, (d's bits << 32) | id: d >= 0,
// so the unsigned order is the (d, id) order, and an empty slot or a row >= n
// is (+inf, -1), above every real candidate.  The tile's CT = 64 candidates
// sit two a lane, element 2 lane + r in key r.  A bitonic sort orders them in
// 21 stages: for each run size s = 2 .. 64, the flip stage (element e
// against e ^ (s - 1)) and the half-cleaners e ^ j, j = s / 4 .. 1.  A stage
// whose partner is in another lane is one 64-bit `__shfl_xor_sync` per key
// (15 of the 21); the others stay in registers.  The merge then keeps the P
// smallest of the list (padded to P = the power of two >= k with keys above
// every other) and the sorted candidates: min(L[P-1-e], C[e]) is bitonic, and
// log2 P half-cleaners sort it.  At P = 128 a lane holds four keys, elements
// 2 lane + r and 64 + 2 lane + r.  Every stage runs whatever the data: no
// early exit, as the TPU kernel's k passes (pallas_topk.py:113).
using key64 = unsigned long long;
constexpr key64 KEY_PAD = ~0ull;  // list slots >= k

__device__ __forceinline__ key64 make_key(float d, int id) {
  return (key64)__float_as_uint(d) << 32 | (uint32_t)id;
}

// the lower element of a pair keeps the smaller key
__device__ __forceinline__ key64 keep(key64 v, key64 other, bool lower) {
  return (other < v) == lower ? other : v;
}

__device__ __forceinline__ void cx(key64& a, key64& b) {
  const key64 lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// half-cleaner j over R keys a lane: element e against e ^ j
template <int R>
__device__ __forceinline__ void clean(key64* c, int j, int lane) {
  if (R == 4 && j == 64) {
    cx(c[0], c[R - 2]);
    cx(c[1], c[R - 1]);
  } else if (j == 1) {
#pragma unroll
    for (int r = 0; r < R; r += 2) cx(c[r], c[r + 1]);
  } else {
    const bool lower = (lane & (j / 2)) == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = keep(c[r], __shfl_xor_sync(FULL, c[r], j / 2), lower);
  }
}

__host__ __device__ constexpr int log2_of(int p) { return p > 1 ? 1 + log2_of(p / 2) : 0; }

// Queries a warp merges at once in K3: the stages of different queries are
// independent, so a stage has 2 x NET_QUERIES keys a lane whose shuffle and
// compare latencies overlap (on an H100 at k=10: 10.3 ms a 16384 x 56000 call
// with one query at a time, 9.3 with two, 9.1 with four).
constexpr int NET_QUERIES = 4;

template <int P>
struct NetworkMerge {
  static constexpr int QUERIES = NET_QUERIES;  // queries q, q + 8, ... of the warp
  static constexpr int R = P > 64 ? 4 : 2;     // keys a lane in the merge
  static constexpr int LOG_P = log2_of(P), LOG_CT = log2_of(CT);

  __device__ __forceinline__ static int element(int lane, int r) { return (r / 2) * 64 + 2 * lane + r % 2; }

  __device__ __forceinline__ static void merge(const float* row, float* Ld, int* Li, int k, int r0, int n,
                                               int lane) {
    constexpr int QSTEP = THREADS / 32;  // between a warp's queries
    key64 c[QUERIES][R];
    const int i0 = r0 + 2 * lane;
#pragma unroll
    for (int t = 0; t < QUERIES; ++t) {
      const float2 d2 = *reinterpret_cast<const float2*>(row + t * QSTEP * DS_STRIDE + 2 * lane);
      c[t][0] = make_key(d2.x, i0 < n ? i0 : -1);
      c[t][1] = make_key(d2.y, i0 + 1 < n ? i0 + 1 : -1);
      cx(c[t][0], c[t][1]);
    }
    // sort the 64 candidates
#pragma unroll
    for (int ls = 2; ls <= LOG_CT; ++ls) {  // runs of s = 2^ls
      const bool lower = (lane & (1 << (ls - 2))) == 0;
#pragma unroll
      for (int t = 0; t < QUERIES; ++t) {
        const key64 p0 = __shfl_xor_sync(FULL, c[t][1], (1 << (ls - 1)) - 1);
        const key64 p1 = __shfl_xor_sync(FULL, c[t][0], (1 << (ls - 1)) - 1);
        c[t][0] = keep(c[t][0], p0, lower);
        c[t][1] = keep(c[t][1], p1, lower);
      }
#pragma unroll
      for (int lj = ls - 2; lj >= 0; --lj)
#pragma unroll
        for (int t = 0; t < QUERIES; ++t) clean<2>(c[t], 1 << lj, lane);
    }
    // merge with the list: the P smallest, bitonic, then sorted
#pragma unroll
    for (int t = 0; t < QUERIES; ++t)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= 2) c[t][r] = KEY_PAD;
        const int e = element(lane, r), idx = P - 1 - e;
        if (e < P && idx < k) {
          const key64 l = make_key(Ld[t * QSTEP * k + idx], Li[t * QSTEP * k + idx]);
          c[t][r] = l < c[t][r] ? l : c[t][r];
        }
      }
#pragma unroll
    for (int lj = LOG_P - 1; lj >= 0; --lj)
#pragma unroll
      for (int t = 0; t < QUERIES; ++t) clean<R>(c[t], 1 << lj, lane);
    __syncwarp();  // every lane has read the lists
#pragma unroll
    for (int t = 0; t < QUERIES; ++t)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = element(lane, r);
        if (e < k) {
          Ld[t * QSTEP * k + e] = __uint_as_float((uint32_t)(c[t][r] >> 32));
          Li[t * QSTEP * k + e] = (int)(uint32_t)c[t][r];
        }
      }
  }
};

// ---------------------------------------------------------------------------
// The tensor-core tile, shared by all four kernels; `Select` merges each
// complete tile into the running lists.
// ---------------------------------------------------------------------------

template <typename T, typename Select>
__device__ __forceinline__ void scan_body(const T* __restrict__ q,  // (B, D)
                                          const T* __restrict__ x,  // (n, D)
                                          int n, int B, int D, int k,
                                          int* __restrict__ out_ids,    // (B, k)
                                          float* __restrict__ out_d) {  // (B, k)
  using M = Mma<T>;
  using acc_t = typename M::acc_t;
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);         // [NST][CT][ROW_STRIDE] bytes
  float* ds = reinterpret_cast<float*>(ring + NST * SLOT);  // [QB][DS_STRIDE]
  acc_t* qn = reinterpret_cast<acc_t*>(ds + QB * DS_STRIDE);  // [QB]
  acc_t* xn = qn + QB;                                  // [CT]
  float* ld = reinterpret_cast<float*>(xn + CT);        // [QB][k] running top-k, ascending
  int* li = reinterpret_cast<int*>(ld + QB * k);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wq = warp & 3, wn = warp >> 2;  // query rows 16 wq.., tile rows 32 wn..
  const int q0 = blockIdx.x * QB;
  const int RB = D * (int)sizeof(T);  // row bytes
  const int nch = (RB + CHUNK - 1) / CHUNK;
  const int items = (n + CT - 1) / CT * nch;
  const char* xb = reinterpret_cast<const char*>(x);
  const char* qb = reinterpret_cast<const char*>(q);
  const uint32_t ring_s = smem_u32(ring);

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) stage_item(ring_s + s * SLOT, xb, n, RB, nch, s, items, tid);

  for (int i = tid; i < QB * k; i += THREADS) {
    ld[i] = INFINITY;
    li[i] = -1;
  }
  if (tid < QB) {
    acc_t acc = 0;
    if (q0 + tid < B) {
      const uint4* row = reinterpret_cast<const uint4*>(qb + (size_t)(q0 + tid) * RB);
      for (int c = 0; c < RB / 16; ++c) acc = M::sq16(__ldg(row + c), acc);
    }
    qn[tid] = acc;
  }
  // the first chunk's A fragments, held for the whole corpus loop
  const int qa = q0 + 16 * wq + g;
  const char* rowa = qa < B ? qb + (size_t)qa * RB : nullptr;
  const char* rowb = qa + 8 < B ? qb + (size_t)(qa + 8) * RB : nullptr;
  const int ks0 = min(CHUNK, RB) / 32;
  uint32_t afr[KSTEPS][4];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    if (s < ks0) {
      load_a(afr[s], rowa, rowb, 32 * s + 4 * t4);
    } else {
      afr[s][0] = afr[s][1] = afr[s][2] = afr[s][3] = 0u;
    }
  }
  __syncthreads();  // qn and the lists
  const acc_t qna = qn[16 * wq + g], qnb = qn[16 * wq + g + 8];
  // |x|^2: lane (row 8 warp + lane % 8) sums every 4th 16-byte piece from lane / 8
  const int xrow = 8 * warp + (lane & 7), xq = lane >> 3;

  acc_t acc[4][4];
  acc_t xpart = 0;
  for (int it = 0; it < items; ++it) {
    const int c = it % nch;
    cp_async_wait<NST - 2>();
    __syncthreads();  // item `it` has landed; every thread is done with slot it - 1
    stage_item(ring_s + ((it + NST - 1) % NST) * SLOT, xb, n, RB, nch, it + NST - 1, items, tid);
    const char* slot = ring + (it % NST) * SLOT;
    const uint32_t slot_s = ring_s + (it % NST) * SLOT;
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
      xpart = 0;
    }
    const int cbytes = min(CHUNK, RB - c * CHUNK);
    for (int p = xq; p < cbytes / 16; p += 4)
      xpart = M::sq16(*reinterpret_cast<const uint4*>(slot + xrow * ROW_STRIDE + 16 * p), xpart);
    // lanes 0-7 / 8-15 / 16-23 / 24-31 address n-tile 2h bytes 0-15 / 16-31,
    // then n-tile 2h+1 bytes 0-15 / 16-31: b0, b1 of two n-tiles
    const uint32_t bsrc = slot_s + (32 * wn + 8 * (lane >> 4) + (lane & 7)) * ROW_STRIDE + 16 * ((lane >> 3) & 1);
    const int ks = cbytes / 32;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      if (s < ks) {
        uint32_t a[4];
        if (c == 0) {
          a[0] = afr[s][0];
          a[1] = afr[s][1];
          a[2] = afr[s][2];
          a[3] = afr[s][3];
        } else {
          load_a(a, rowa, rowb, c * CHUNK + 32 * s + 4 * t4);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t b[4];
          ldmatrix_x4(b, bsrc + 16 * h * ROW_STRIDE + 32 * s);
          M::mma(acc[2 * h], a, b[0], b[1]);
          M::mma(acc[2 * h + 1], a, b[2], b[3]);
        }
      }
    }
    if (c != nch - 1) continue;

    // the tile is complete: row norms, then its distances into ds
    xpart += __shfl_xor_sync(FULL, xpart, 8);
    xpart += __shfl_xor_sync(FULL, xpart, 16);
    if (lane < 8) xn[xrow] = xpart;
    __syncthreads();
    const int r0 = it / nch * CT;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * wn + 8 * j + 2 * t4;
      const acc_t x0 = xn[col], x1 = xn[col + 1];
      float2 lo = make_float2(M::dist(qna, x0, acc[j][0]), M::dist(qna, x1, acc[j][1]));
      float2 hi = make_float2(M::dist(qnb, x0, acc[j][2]), M::dist(qnb, x1, acc[j][3]));
      if (r0 + col >= n) lo.x = hi.x = INFINITY;
      if (r0 + col + 1 >= n) lo.y = hi.y = INFINITY;
      *reinterpret_cast<float2*>(ds + (16 * wq + g) * DS_STRIDE + col) = lo;
      *reinterpret_cast<float2*>(ds + (16 * wq + g + 8) * DS_STRIDE + col) = hi;
    }
    __syncthreads();

    for (int qi = warp; qi < QB; qi += THREADS / 32 * Select::QUERIES)
      Select::merge(ds + qi * DS_STRIDE, ld + qi * k, li + qi * k, k, r0, n, lane);
  }
  cp_async_wait<0>();  // only empty groups remain
  store_lists(ld, li, q0, B, k, tid, out_ids, out_d);
}

__global__ void __launch_bounds__(THREADS, 2)
    flat_topk_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ x, int n, int B,
                     int D, int k, int* __restrict__ out_ids, float* __restrict__ out_d) {
  scan_body<__nv_bfloat16, CountMerge>(q, x, n, B, D, k, out_ids, out_d);
}

__global__ void __launch_bounds__(THREADS, 2)
    flat_topk_s8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ x, int n, int B, int D, int k,
                        int* __restrict__ out_ids, float* __restrict__ out_d) {
  scan_body<int8_t, CountMerge>(q, x, n, B, D, k, out_ids, out_d);
}

// K3 / K3-s8: one instance per list size P = 1, 2, 4, ..., 128
template <int P>
__global__ void __launch_bounds__(THREADS, 2)
    flat_topk_fixed_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ x, int n,
                           int B, int D, int k, int* __restrict__ out_ids, float* __restrict__ out_d) {
  scan_body<__nv_bfloat16, NetworkMerge<P>>(q, x, n, B, D, k, out_ids, out_d);
}

template <int P>
__global__ void __launch_bounds__(THREADS, 2)
    flat_topk_fixed_s8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ x, int n, int B, int D,
                              int k, int* __restrict__ out_ids, float* __restrict__ out_d) {
  scan_body<int8_t, NetworkMerge<P>>(q, x, n, B, D, k, out_ids, out_d);
}

template <typename T>
using Kernel = void (*)(const T*, const T*, int, int, int, int, int*, float*);

const Kernel<__nv_bfloat16> FIXED_BF16[] = {
    flat_topk_fixed_kernel<1>,  flat_topk_fixed_kernel<2>,  flat_topk_fixed_kernel<4>,
    flat_topk_fixed_kernel<8>,  flat_topk_fixed_kernel<16>, flat_topk_fixed_kernel<32>,
    flat_topk_fixed_kernel<64>, flat_topk_fixed_kernel<128>};
const Kernel<int8_t> FIXED_S8[] = {
    flat_topk_fixed_s8_kernel<1>,  flat_topk_fixed_s8_kernel<2>,  flat_topk_fixed_s8_kernel<4>,
    flat_topk_fixed_s8_kernel<8>,  flat_topk_fixed_s8_kernel<16>, flat_topk_fixed_s8_kernel<32>,
    flat_topk_fixed_s8_kernel<64>, flat_topk_fixed_s8_kernel<128>};

// log2 of the list size P, the power of two >= k (k in 1 .. KMAX)
int list_log2(int k) {
  int i = 0;
  while ((1 << i) < k) ++i;
  return i;
}

// Dynamic shared memory of one block, the same for all four kernels and
// every D: the ring, ds, the norms and the running lists.
int smem_bytes(int k) {
  return NST * SLOT + (int)sizeof(float) * (QB * DS_STRIDE + QB + CT + QB * k) + (int)sizeof(int) * QB * k;
}

template <typename T>
int launch(Kernel<T> kernel, int smem, const void* q,
           const void* x, int n, int B, int D, int k, void* out_ids, void* out_d, void* stream) {
  if (k < 1 || k > KMAX || D % 64 != 0) return (int)cudaErrorInvalidValue;
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

// Dynamic shared memory of one block of K2 / K2-s8 (the same for both types
// and every D) and of K3 / K3-s8.
int expann_flat_topk_smem_bytes(int D, int k) {
  (void)D;
  return smem_bytes(k);
}

int expann_flat_topk_fixed_smem_bytes(int D, int k) { return smem_bytes(k); }

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller guarantees: D % 64 == 0, 1 <= k <= 128, rows 16-byte aligned.
int expann_flat_topk_bf16(const void* q, const void* x, int n, int B, int D, int k,
                          void* out_ids, void* out_d, void* stream) {
  return launch(flat_topk_kernel, smem_bytes(k), q, x, n, B, D, k, out_ids, out_d, stream);
}

// The fixed-pass kernel (K3); same contract.
int expann_flat_topk_fixed_bf16(const void* q, const void* x, int n, int B, int D, int k,
                                void* out_ids, void* out_d, void* stream) {
  if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  return launch(FIXED_BF16[list_log2(k)], smem_bytes(k), q, x, n, B, D, k, out_ids, out_d, stream);
}

// K2-s8 and K3-s8: int8 codes for q and x; same contract (D % 64 == 0
// keeps every row 16-byte aligned).
int expann_flat_topk_s8(const void* q, const void* x, int n, int B, int D, int k, void* out_ids,
                        void* out_d, void* stream) {
  return launch(flat_topk_s8_kernel, smem_bytes(k), q, x, n, B, D, k, out_ids, out_d, stream);
}

int expann_flat_topk_fixed_s8(const void* q, const void* x, int n, int B, int D, int k,
                              void* out_ids, void* out_d, void* stream) {
  if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  return launch(FIXED_S8[list_log2(k)], smem_bytes(k), q, x, n, B, D, k, out_ids, out_d, stream);
}

const char* expann_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
