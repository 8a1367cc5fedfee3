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
// K2 (bf16, count mode), the flat engine's calls and the builders' scans.
//   Bound on this card: operations, 2 B N D at the tensor cores' dense
//   989 TFLOP/s in bf16: 4.24 ms for the flat engine's 16384 x 1,000,000 call
//   at D=128, 0.354 ms for the builder's 4096 x 333,824 scan at D=128 and
//   2.83 ms at D=1024.  The old tile (below) reached 1.6-6.8% of it: every
//   64-row tile ran in lockstep phases (a copy wait, three block barriers,
//   the product, |x|^2 in every block, a distance tile through shared memory,
//   then a warp merging one query at a time), and a builder's batch of 4096
//   filled 64 of the 132 SMs.  Design:
//   - Ring and producer: a block is one or two consumer warpgroups of 64
//     queries and a producer warpgroup, one lane of which issues TMA loads
//     (tensor maps from cuTensorMapEncodeTiled, 128-byte swizzle) of corpus
//     chunks (128 rows x 64 features) into a ring of up to 8 stages, each
//     with a full and an empty mbarrier.  The tile's |x|^2 (128 f32, made
//     once a call by `flat_norms_kernel`, summed in f64 and rounded once,
//     so that |q|^2 + |x|^2 - 2 q.x errs by the product's f32 sums alone;
//     +inf past n) arrives by a bulk
//     copy beside its last chunk.  The queries stay in shared memory for the
//     whole scan where they fit (D <= 256 with two warpgroups, <= 512 with
//     one), else stream chunk by chunk beside the corpus.  The producer
//     gives up registers (setmaxnreg) for the consumers.
//   - Consumers: each warpgroup issues `wgmma.mma_async` m64n128k16 (bf16 ->
//     f32, both operands from shared memory) over the tile's chunks, one
//     commit group a chunk, freeing each chunk's stage as the next chunk's
//     products are issued; the two warpgroups run unsynchronised on the same
//     stages, so one's products run beside the other's epilogue.  Rows wider
//     than two chunks (D = 256, 384, ...) sum each chunk from zero, in two
//     accumulator sets by turns, and add the chunks' sums in f32: a tensor
//     core's running sum drifts below the round-to-nearest sum as it grows
//     (0.0011 at a D=512 self-match, against 1e-3 for the old tile).
//   - Filter: a thread holds two query rows x 32 columns of the tile's
//     accumulators and each row's k-th distance (the threshold) in
//     registers.  The epilogue forms d = (qn + xn) - 2 dot in place and each
//     row's least; where no distance of the warp's 16 rows lies below its
//     threshold (late tiles, nearly always) the tile ends there.  Otherwise
//     the passing candidates (d < threshold: within a block ids ascend, so a
//     tie never beats a listed id) are appended to the query's buffer of 32
//     (d, id) keys in shared memory, a quarter of the tile's columns at a
//     time, merging a buffer that would overflow into the query's sorted
//     list first (a bitonic sort of the buffer across the warp, then each
//     key's rank in the merged order by binary searches) and refreshing the
//     threshold from it.  Every warp owns its 16 rows: no block barrier in
//     the scan.
//   - Split and merge: where the groups of queries fill fewer SMs than the
//     card has, blocks split the corpus (at least 8 tiles each); each writes
//     its lists to a workspace, and the last block of a group to finish (a
//     global ticket) merges the others' sorted lists into its own, exactly
//     by (d, id), and writes the result.
//   - The launcher chooses the warpgroups (two where their lists, buffers
//     and a ring of 4 stages fit, else one: k=128 takes 1 KB of list a
//     query), resident or streamed queries, the ring's depth and the split
//     from B, n, D and k alone.  Each block adds the candidates its filter
//     passed to one int64 on the device (`ops/topk.pass_counter`).
//
// The old tile, kept by K2-s8, K3 and K3-s8: tensor-core distance tiles.
//   Those three keep it byte for byte, and with it their contracts: K2-s8 and
//   K3-s8 identical to the plain version on s8 codes and to each other, K3's
//   network (below) fed 64 candidates a tile, whatever the data.  Redesigning
//   them is later work.
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
//   Tile shape: QB = 64 keeps 256 blocks on the main path's B = 16384, two
//   resident per SM (registers capped at 128 a thread) on 132 SMs; CT = 64
//   gives each warp 16 x 32 outputs (16 accumulators) and each query 64
//   candidates per tile.  Shared memory: 3 x 17 KB ring + 18 KB ds + 512 k
//   bytes of running lists (74.5 KiB at k=10, 133.5 KiB at k=128), for any
//   D % 64 == 0.  K3-s8 shares K2-s8's tile, so the two compute the same
//   distances bit for bit and, both ordering by (d, id), return the same
//   lists; bf16 K3 and K2 sum in other orders and agree but on ties.
//
// K2-s8 selects by count-then-insert: per query a warp ballot finds the
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

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder comes through the runtime)
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>
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

// K2-s8: count-then-insert.  A ballot finds the tile's candidates below the
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
// The old tensor-core tile, shared by K2-s8, K3 and K3-s8; `Select` merges each
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

// ===========================================================================
// K2 (bf16, count mode): a warp-specialised wgmma scan with an in-register
// threshold filter.  Design and bound: the note at the top of this file.
// ===========================================================================

namespace k2 {

constexpr int TN = 128;               // corpus rows a tile: the wgmma's N
constexpr int KC = 64;                // features a chunk: 128 bytes, one 128-byte swizzle row
constexpr int QW = 64;                // queries a consumer warpgroup: the wgmma's M
constexpr int WG_THREADS = 128;
constexpr int CAP = 32;               // buffered candidates a query
constexpr int SLICES = 4;             // a tile's columns in 4 slices: at most CAP = 32 pass a query's slice
constexpr int GROUPS_PER_SLICE = TN / 8 / SLICES;
constexpr int X_BYTES = TN * KC * 2;  // a corpus chunk, 16 KB
constexpr int Q_BYTES = QW * KC * 2;  // a warpgroup's query chunk, 8 KB
constexpr int NORM_BYTES = 1024;      // a tile's TN f32 norms, padded to keep stages 1024-byte aligned
constexpr int MAX_STAGES = 8;
constexpr int RESIDENT_MAX = 65536;   // query bytes a block keeps for the whole scan
constexpr int SMEM_LIMIT = 232448;    // shared memory a block may use (227 KB)
constexpr int MIN_SPLIT_TILES = 8;    // tiles a corpus split scans at least
constexpr int MAX_THREADS = 3 * WG_THREADS;  // two consumer warpgroups and the producer's
constexpr int PRODUCER_REGS = 40;     // registers a producer thread keeps (setmaxnreg)
constexpr int CONSUMER_REGS = 232;    // and a consumer thread takes: 2 x 128 x 232 + 128 x 40 <= 65536
constexpr unsigned long long WAIT_TIMEOUT_NS = 2000000000ull;  // 2 s
constexpr key64 EMPTY = ((key64)0x7f800000u << 32) | 0xffffffffu;  // (+inf, id -1): an empty list slot

// The block's shared memory, from a 1024-byte aligned base: the ring's
// stages (corpus chunk, the streamed query chunks, the tile's norms), the
// resident query chunks, then per query its list of k keys, its buffer of
// CAP keys and its buffer count, a 32-key scratch a consumer warp, and the
// mbarriers.
struct Layout {
  int nwg, resident, nst, nch, k;
  __host__ __device__ int qpb() const { return nwg * QW; }
  __host__ __device__ int stage_bytes() const { return X_BYTES + NORM_BYTES + (resident ? 0 : nwg * Q_BYTES); }
  __host__ __device__ int norm_off() const { return X_BYTES + (resident ? 0 : nwg * Q_BYTES); }
  __host__ __device__ int qres_off() const { return nst * stage_bytes(); }
  __host__ __device__ int lists_off() const { return qres_off() + (resident ? nwg * nch * Q_BYTES : 0); }
  __host__ __device__ int bufs_off() const { return lists_off() + qpb() * k * 8; }
  __host__ __device__ int cnt_off() const { return bufs_off() + qpb() * CAP * 8; }
  __host__ __device__ int scratch_off() const { return cnt_off() + qpb() * 4; }
  __host__ __device__ int bars_off() const { return scratch_off() + nwg * 4 * 32 * 8; }
  __host__ __device__ int misc_off() const { return bars_off() + (2 * MAX_STAGES + 1) * 8; }
  __host__ __device__ int bytes() const { return misc_off() + 16 + 1024; }  // + the base's alignment
};

struct Params {
  const float* xnorm;   // tiles * TN: |x|^2, +inf past n
  const float* qnorm;   // B: |q|^2
  int* out_ids;
  float* out_d;
  key64* partial;       // groups * split * qpb * k: the splits' lists (split > 1)
  int* tickets;         // groups, zeroed by the norms kernel
  unsigned long long* passes;
  int n, B, k, nwg, resident, nst, nch, split, tiles;
};

// ---------------------------------------------------------------------------
// TMA, mbarriers, wgmma

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void bar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed; trap
// after WAIT_TIMEOUT_NS.
__device__ __forceinline__ void bar_wait(uint32_t bar, unsigned parity) {
  const uint64_t t0 = global_ns();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (global_ns() - t0 > WAIT_TIMEOUT_NS) __trap();
  }
}

// a (KC x rows) box of a 2-D bf16 tensor map at (feature c0, row c1); rows
// past the tensor arrive as zeros and still count their bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, unsigned bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// the wgmma descriptor of a K-major tile of 128-byte rows in 8-row groups of
// 1024 bytes, swizzled as TMA's SWIZZLE_128B writes it; a k-step of 16
// features starts 32 bytes further
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// the accumulators are not read before the wait that completes them
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = a (64 queries x 16) . b (128 rows x 16)^T (+ d when
// `accumulate`): exact bf16 products, f32 sums
__device__ __forceinline__ void mma_m64n128k16(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// barrier 1 among the consumer warpgroups (the producer warp may have left)
__device__ __forceinline__ void consumers_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// ---------------------------------------------------------------------------
// selection: a query's list L (k keys, ascending) and buffer Bf (cnt keys,
// in no order); keys are (d's bits << 32) | id, d >= 0, so the unsigned
// order is the (d, id) order, and EMPTY lies above every real key

// The k smallest of L and Bf, ascending, into L; the buffer empties.  One
// warp: the buffer (<= 32 keys) is sorted across the lanes by a bitonic
// network, then every key's place in the merged order is its rank in its
// own run plus the count of the other run's keys below it (binary searches:
// no two keys are equal but L's EMPTY slots, which keep their order).
__device__ __forceinline__ void warp_merge(key64* L, key64* Bf, int* cnt, key64* scr, int k, int lane) {
  const int c = *cnt;
  key64 v = lane < c ? Bf[lane] : KEY_PAD;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const key64 o = __shfl_xor_sync(FULL, v, stride);
      const bool low = (lane & stride) == 0, up = (lane & size) == 0;
      v = (low == up) == (o < v) ? o : v;
    }
  }
  scr[lane] = v;
  __syncwarp();
  int pos = k;
  if (v != KEY_PAD) {
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (L[mid] < v) lo = mid + 1; else hi = mid;
    }
    pos = lane + lo;
  }
  key64 lv[KMAX / 32];
  int lp[KMAX / 32];
#pragma unroll
  for (int t = 0; t < KMAX / 32; ++t) {
    const int j = lane + 32 * t;
    lv[t] = KEY_PAD;
    lp[t] = k;
    if (j < k) {
      lv[t] = L[j];
      int lo = 0, hi = c;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (scr[mid] < lv[t]) lo = mid + 1; else hi = mid;
      }
      lp[t] = j + lo;
    }
  }
  __syncwarp();
  if (pos < k) L[pos] = v;
#pragma unroll
  for (int t = 0; t < KMAX / 32; ++t)
    if (lp[t] < k) L[lp[t]] = lv[t];
  if (lane == 0) *cnt = 0;
  __syncwarp();
}

// Another split's sorted list (k keys in global memory) into L: its keys
// below L's k-th form a prefix, taken 32 at a time through the buffer.
__device__ __forceinline__ void merge_partial(const key64* __restrict__ src, key64* L, key64* Bf, int* cnt,
                                              key64* scr, int k, int lane) {
  for (int base = 0; base < k; base += 32) {
    const key64 e = base + lane < k ? __ldcg(reinterpret_cast<const unsigned long long*>(src) + base + lane)
                                    : KEY_PAD;
    int taken = __popc(__ballot_sync(FULL, e < L[k - 1]));
    if (taken && *cnt + taken > CAP) {
      warp_merge(L, Bf, cnt, scr, k, lane);
      taken = __popc(__ballot_sync(FULL, e < L[k - 1]));
    }
    const int c = *cnt;
    if (lane < taken) Bf[c + lane] = e;
    __syncwarp();
    if (lane == 0) *cnt = c + taken;
    __syncwarp();
    if (taken < 32) return;
  }
}

// exclusive prefix and total of c over the lanes of a quad
__device__ __forceinline__ void quad_scan(unsigned c, int t4, int lane, unsigned& pre, unsigned& tot) {
  unsigned x = c, y = __shfl_up_sync(FULL, x, 1);
  if (t4 >= 1) x += y;
  y = __shfl_up_sync(FULL, x, 2);
  if (t4 >= 2) x += y;
  pre = x - c;
  tot = __shfl_sync(FULL, x, lane | 3);
}

// The cut a raw distance d must fall below to pass: max(d, 0) < thr <=> d < cut.
__device__ __forceinline__ float cut_of(float thr) { return thr > 0.f ? thr : -INFINITY; }

// passes among the tile's column groups [J0, J1), row r0's in the low
// half, r0+8's in the high
template <int J0, int J1>
__device__ __forceinline__ unsigned count_passes(const float* acc, float cut0, float cut1) {
  unsigned c = 0;
#pragma unroll
  for (int j = J0; j < J1; ++j) {
    c += (unsigned)(acc[4 * j] < cut0) + (unsigned)(acc[4 * j + 1] < cut0);
    c += ((unsigned)(acc[4 * j + 2] < cut1) + (unsigned)(acc[4 * j + 3] < cut1)) << 16;
  }
  return c;
}

// Append this thread's passing candidates of groups [J0, J1) at its offsets
// (the quad's exclusive prefix `pre` past the buffers' counts), then count
// them in: the quad's totals `tot`.
template <int J0, int J1>
__device__ __forceinline__ void append(const float* acc, float cut0, float cut1, key64* bufs, int* bcnt, int lr,
                                       int col0, unsigned pre, unsigned tot, int t4, unsigned& passes) {
  const int lr0 = lr, lr1 = lr + 8;
  const int b0 = bcnt[lr0], b1 = bcnt[lr1];
  int i0 = b0 + (int)(pre & 0xffffu), i1 = b1 + (int)(pre >> 16);
#pragma unroll
  for (int j = J0; j < J1; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int id = col0 + 8 * j + e;
      if (acc[4 * j + e] < cut0) bufs[lr0 * CAP + i0++] = make_key(fmaxf(acc[4 * j + e], 0.f), id);
      if (acc[4 * j + 2 + e] < cut1) bufs[lr1 * CAP + i1++] = make_key(fmaxf(acc[4 * j + 2 + e], 0.f), id);
    }
  }
  __syncwarp();
  if (t4 == 0) {
    bcnt[lr0] = b0 + (int)(tot & 0xffffu);
    bcnt[lr1] = b1 + (int)(tot >> 16);
    passes += (tot & 0xffffu) + (tot >> 16);
  }
  __syncwarp();
}

// One slice of the tile through the filter: the slice's passing candidates
// of rows r0 / r0+8 appended to their buffers, each buffer that would
// overflow merged first (the warp's rows are its own: no block barrier).
// At most CAP pass a row's slice, so one merge makes room.
template <int SL>
__device__ __forceinline__ void filter_slice(const float* acc, float& thr0, float& thr1, bool v0, bool v1,
                                             key64* lists, key64* bufs, int* bcnt, key64* scr, int lr, int k,
                                             int col0, int lane, int t4, unsigned& passes) {
  constexpr int J0 = SL * GROUPS_PER_SLICE, J1 = J0 + GROUPS_PER_SLICE;
  const int lr0 = lr, lr1 = lr + 8;
  float cut0 = cut_of(thr0), cut1 = cut_of(thr1);
  unsigned c = count_passes<J0, J1>(acc, cut0, cut1);
  if (!__any_sync(FULL, c != 0)) return;
  unsigned pre, tot;
  quad_scan(c, t4, lane, pre, tot);
  const bool need0 = bcnt[lr0] + (int)(tot & 0xffffu) > CAP, need1 = bcnt[lr1] + (int)(tot >> 16) > CAP;
  const unsigned m0 = __ballot_sync(FULL, need0), m1 = __ballot_sync(FULL, need1);
  if (m0 | m1) {
    const int wrow = lr - (lane >> 2);  // the warp's first row
    unsigned rows = 0;
#pragma unroll
    for (int g = 0; g < 8; ++g) rows |= ((m0 >> (4 * g)) & 1u) << g | ((m1 >> (4 * g)) & 1u) << (g + 8);
    while (rows) {
      const int r = __ffs(rows) - 1;
      rows &= rows - 1;
      const int row = wrow + r;
      warp_merge(lists + row * k, bufs + row * CAP, bcnt + row, scr, k, lane);
    }
    if (v0) thr0 = __uint_as_float((uint32_t)(lists[lr0 * k + k - 1] >> 32));
    if (v1) thr1 = __uint_as_float((uint32_t)(lists[lr1 * k + k - 1] >> 32));
    cut0 = cut_of(thr0);
    cut1 = cut_of(thr1);
    c = count_passes<J0, J1>(acc, cut0, cut1);
    quad_scan(c, t4, lane, pre, tot);
  }
  append<J0, J1>(acc, cut0, cut1, bufs, bcnt, lr, col0, pre, tot, t4, passes);
}

// The tile through the filter, slice by slice.
__device__ __forceinline__ void filter_tile(const float* acc, float& thr0, float& thr1, bool v0, bool v1,
                                            key64* lists, key64* bufs, int* bcnt, key64* scr, int lr, int k,
                                            int col0, int lane, int t4, unsigned& passes) {
  filter_slice<0>(acc, thr0, thr1, v0, v1, lists, bufs, bcnt, scr, lr, k, col0, lane, t4, passes);
  filter_slice<1>(acc, thr0, thr1, v0, v1, lists, bufs, bcnt, scr, lr, k, col0, lane, t4, passes);
  filter_slice<2>(acc, thr0, thr1, v0, v1, lists, bufs, bcnt, scr, lr, k, col0, lane, t4, passes);
  filter_slice<3>(acc, thr0, thr1, v0, v1, lists, bufs, bcnt, scr, lr, k, col0, lane, t4, passes);
}

// One consumer thread's state: its rows lr / lr + 8 of the block (columns
// 8 j + 2 t4 + e of each tile), their thresholds and buffers, and its place
// in the ring.
struct Consumer {
  unsigned char* base;
  uint32_t base_s, full_s, empty_s, qres_s;
  int stage_bytes, norm_off, nst, nch, resident, wg, lane, t4, lr, k;
  float qn0, qn1, thr0, thr1;
  bool v0, v1;
  key64 *lists, *bufs, *scr;
  int* bcnt;
  unsigned passes;
  int stage, phase;

  // One chunk's products into acc, from zero or added, one commit group.
  __device__ __forceinline__ void chunk(float* acc, int kc, bool add) {
    bar_wait(full_s + 8 * stage, phase);
    const uint32_t xs = base_s + stage * stage_bytes;
    const uint32_t qs = resident ? qres_s + (wg * nch + kc) * Q_BYTES : xs + X_BYTES + wg * Q_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      mma_m64n128k16(acc, desc128(qs + 32 * kk), desc128(xs + 32 * kk), (add || kk > 0) ? 1 : 0);
    wgmma_commit();
  }

  // The ring's next stage; returns the one just used.
  __device__ __forceinline__ int advance() {
    const int used = stage;
    if (++stage == nst) {
      stage = 0;
      phase ^= 1;
    }
    return used;
  }

  __device__ __forceinline__ void release(int s) {
    __syncwarp();
    if (lane == 0) bar_arrive(empty_s + 8 * s);
  }

  // One tile's products into acc, chunk by chunk as the ring delivers them;
  // each chunk's stage is freed once the next chunk's products are issued
  // and its own are done.  Returns the tile's last stage (its norms), which
  // the epilogue frees.
  __device__ __forceinline__ int issue(float* acc) {
    int prev = 0;
    for (int kc = 0; kc < nch; ++kc) {
      chunk(acc, kc, kc > 0);
      if (kc > 0) {
        wgmma_wait<1>();
        release(prev);
      }
      prev = advance();
    }
    return prev;
  }

  // The same for an even count of chunks above 2 (D = 256, 384, ...), with
  // each chunk summed from zero in ca or cb by turns and the chunks' sums
  // added into acc in f32 as they complete: the tensor cores' sums run 4
  // k-steps, not D / 16, before they are rounded into acc.
  __device__ __forceinline__ int issue_by_chunks(float* acc, float* ca, float* cb) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int kc = 0; kc < nch; kc += 2) {
      chunk(ca, kc, false);
      if (kc > 0) {
        wgmma_wait<1>();
        fence_operands(cb);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += cb[i];
        release(prev);
      }
      prev = advance();
      chunk(cb, kc + 1, false);
      wgmma_wait<1>();
      fence_operands(ca);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += ca[i];
      release(prev);
      prev = advance();
    }
    wgmma_wait<0>();
    fence_operands(cb);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += cb[i];
    return prev;
  }

  // Tile t's epilogue once its products are done: raw distances
  // (qn + xn) - 2 dot in place and each row's least; the tile's last stage
  // released; then, where some distance of the warp's rows lies below its
  // row's k-th, the filter.
  __device__ __forceinline__ void epilogue(float* acc, int t, int last) {
    const float* xn = reinterpret_cast<const float*>(base + last * stage_bytes + norm_off);
    float m0 = INFINITY, m1 = INFINITY;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const float2 xv = *reinterpret_cast<const float2*>(xn + 8 * j + 2 * t4);
      acc[4 * j] = fmaf(-2.f, acc[4 * j], qn0 + xv.x);
      acc[4 * j + 1] = fmaf(-2.f, acc[4 * j + 1], qn0 + xv.y);
      acc[4 * j + 2] = fmaf(-2.f, acc[4 * j + 2], qn1 + xv.x);
      acc[4 * j + 3] = fmaf(-2.f, acc[4 * j + 3], qn1 + xv.y);
      m0 = fminf(m0, fminf(acc[4 * j], acc[4 * j + 1]));
      m1 = fminf(m1, fminf(acc[4 * j + 2], acc[4 * j + 3]));
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty_s + 8 * last);
    // the common path ends here: no distance of the warp's rows below its k-th
    if (__any_sync(FULL, fmaxf(m0, 0.f) < thr0 || fmaxf(m1, 0.f) < thr1))
      filter_tile(acc, thr0, thr1, v0, v1, lists, bufs, bcnt, scr, lr, k, t * TN + 2 * t4, lane, t4, passes);
  }
};

}  // namespace k2

// K2: a block of nwg consumer warpgroups (64 queries each) and the producer
// warpgroup; block group * split + s scans tiles [t0, t1) of the corpus for
// queries group * 64 nwg .. + 64 nwg - 1.
template <bool BY_CHUNKS>
__global__ void __launch_bounds__(k2::MAX_THREADS, 1)
    flat_topk_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tx,
                     const k2::Params p) {
  using namespace k2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t base_s = (raw_s + 1023u) & ~1023u;
  unsigned char* base = smem_raw + (base_s - raw_s);
  const Layout lay{p.nwg, p.resident, p.nst, p.nch, p.k};
  const int k = p.k, qpb = lay.qpb(), stage_bytes = lay.stage_bytes();
  key64* lists = reinterpret_cast<key64*>(base + lay.lists_off());
  key64* bufs = reinterpret_cast<key64*>(base + lay.bufs_off());
  int* bcnt = reinterpret_cast<int*>(base + lay.cnt_off());
  key64* scratch = reinterpret_cast<key64*>(base + lay.scratch_off());
  const uint32_t full_s = base_s + lay.bars_off(), empty_s = full_s + 8 * MAX_STAGES,
                 qbar_s = full_s + 16 * MAX_STAGES;
  int* flag = reinterpret_cast<int*>(base + lay.misc_off());
  unsigned long long* block_passes = reinterpret_cast<unsigned long long*>(base + lay.misc_off() + 8);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = blockIdx.x / p.split, s = blockIdx.x % p.split;
  const int q0 = group * qpb;
  const int t0 = (int)((long long)p.tiles * s / p.split), t1 = (int)((long long)p.tiles * (s + 1) / p.split);
  const int consumers = p.nwg * WG_THREADS;

  if (tid == 0) {
    for (int i = 0; i < p.nst; ++i) {
      bar_init(full_s + 8 * i, 1);
      bar_init(empty_s + 8 * i, p.nwg * 4);  // every consumer warp releases a stage
    }
    bar_init(qbar_s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    *block_passes = 0ull;
  }
  for (int i = tid; i < qpb * k; i += blockDim.x) lists[i] = EMPTY;
  for (int i = tid; i < qpb; i += blockDim.x) bcnt[i] = 0;
  __syncthreads();

  if (warp >= p.nwg * 4) {
    // the producer warpgroup gives up registers; one lane keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp == p.nwg * 4 && lane == 0) {
      if (p.resident) {
        bar_expect(qbar_s, p.nwg * p.nch * Q_BYTES);
        for (int wg = 0; wg < p.nwg; ++wg)
          for (int kc = 0; kc < p.nch; ++kc)
            tma_load(base_s + lay.qres_off() + (wg * p.nch + kc) * Q_BYTES, &tq, kc * KC, q0 + wg * QW, qbar_s);
      }
      const unsigned bytes = X_BYTES + (p.resident ? 0 : p.nwg * Q_BYTES);
      int stage = 0, phase = 0;
      for (int t = t0; t < t1; ++t) {
        for (int kc = 0; kc < p.nch; ++kc) {
          bar_wait(empty_s + 8 * stage, phase ^ 1);
          const uint32_t st = base_s + stage * stage_bytes, fb = full_s + 8 * stage;
          const bool last = kc == p.nch - 1;
          bar_expect(fb, bytes + (last ? TN * 4 : 0));
          tma_load(st, &tx, kc * KC, t * TN, fb);
          if (!p.resident)
            for (int wg = 0; wg < p.nwg; ++wg) tma_load(st + X_BYTES + wg * Q_BYTES, &tq, kc * KC, q0 + wg * QW, fb);
          if (last) bulk_load(st + lay.norm_off(), p.xnorm + (size_t)t * TN, TN * 4, fb);
          if (++stage == p.nst) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: queries q0 + 64 wg .. +63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2, w = warp & 3;
  const int lr = wg * QW + 16 * w + (lane >> 2);
  const bool v0 = q0 + lr < p.B, v1 = q0 + lr + 8 < p.B;
  Consumer c{base, base_s, full_s, empty_s, base_s + lay.qres_off(), stage_bytes, lay.norm_off(), p.nst, p.nch,
             p.resident, wg, lane, lane & 3, lr, k,
             v0 ? p.qnorm[q0 + lr] : 0.f, v1 ? p.qnorm[q0 + lr + 8] : 0.f,
             v0 ? INFINITY : -INFINITY, v1 ? INFINITY : -INFINITY,  // a row past B takes nothing
             v0, v1, lists, bufs, scratch + warp * 32, bcnt, 0u, 0, 0};
  if (p.resident) bar_wait(qbar_s, 0);

  float acc[64];
  if constexpr (BY_CHUNKS) {
    float ca[64], cb[64];
    for (int t = t0; t < t1; ++t) c.epilogue(acc, t, c.issue_by_chunks(acc, ca, cb));
  } else {
    for (int t = t0; t < t1; ++t) {
      const int last = c.issue(acc);
      wgmma_wait<0>();
      fence_operands(acc);
      c.epilogue(acc, t, last);
    }
  }
  unsigned passes = c.passes;
  key64* scr = c.scr;

  // the buffers into the lists
  const int wrow = wg * QW + 16 * w;
  for (int r = 0; r < 16; ++r)
    if (bcnt[wrow + r] > 0) warp_merge(lists + (wrow + r) * k, bufs + (wrow + r) * CAP, bcnt + wrow + r, scr, k, lane);
  passes = __reduce_add_sync(FULL, passes);
  if (lane == 0) atomicAdd(block_passes, (unsigned long long)passes);

  if (p.split > 1) {
    // this split's lists out; the last split of the group to finish merges
    // the others' into its own
    key64* mine = p.partial + ((size_t)(group * p.split + s) * qpb) * k;
    for (int r = 0; r < 16; ++r)
      for (int j = lane; j < k; j += 32) mine[(size_t)(wrow + r) * k + j] = lists[(wrow + r) * k + j];
    __threadfence();
    consumers_sync(consumers);
    if (tid == 0) *flag = atomicAdd(p.tickets + group, 1) == p.split - 1;
    consumers_sync(consumers);
    if (!*flag) {
      if (tid == 0) atomicAdd(p.passes, *block_passes);
      return;
    }
    __threadfence();
    for (int r = 0; r < 16; ++r) {
      const int row = wrow + r;
      if (q0 + row >= p.B) continue;
      for (int o = 0; o < p.split; ++o) {
        if (o == s) continue;
        merge_partial(p.partial + ((size_t)(group * p.split + o) * qpb + row) * k, lists + row * k,
                      bufs + row * CAP, bcnt + row, scr, k, lane);
      }
      if (bcnt[row] > 0) warp_merge(lists + row * k, bufs + row * CAP, bcnt + row, scr, k, lane);
    }
  }
  for (int r = 0; r < 16; ++r) {
    const int row = wrow + r;
    if (q0 + row >= p.B) continue;
    for (int j = lane; j < k; j += 32) {
      const key64 v = lists[row * k + j];
      p.out_ids[(size_t)(q0 + row) * k + j] = (int)(uint32_t)v;
      p.out_d[(size_t)(q0 + row) * k + j] = __uint_as_float((uint32_t)(v >> 32));
    }
  }
  consumers_sync(consumers);
  if (tid == 0) atomicAdd(p.passes, *block_passes);
}

// |x|^2 of the corpus rows (+inf on the padding up to tiles * TN) and |q|^2
// of the queries, eight lanes a row, correctly rounded to f32; zeroes the
// groups' tickets
__global__ void __launch_bounds__(256)
    flat_norms_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ q, int n, int B, int D,
                      int npad, float* __restrict__ xnorm, float* __restrict__ qnorm, int* __restrict__ tickets,
                      int groups) {
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < groups; i += blockDim.x) tickets[i] = 0;
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 3;
  const int sub = threadIdx.x & 7;
  const __nv_bfloat16* row = nullptr;
  if (r < n) row = x + r * D;
  else if (r >= npad && r - npad < B) row = q + (r - npad) * D;
  // in f64, where the squares of bf16 values sum exactly, then rounded once
  double acc = 0.0;
  if (row)
    for (int c = sub; c < D / 8; c += 8) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row) + c);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = __bfloat1622float2(h2[j]);
        acc = fma((double)v.x, (double)v.x, acc);
        acc = fma((double)v.y, (double)v.y, acc);
      }
    }
  acc += __shfl_xor_sync(FULL, acc, 1);
  acc += __shfl_xor_sync(FULL, acc, 2);
  acc += __shfl_xor_sync(FULL, acc, 4);
  if (sub == 0) {
    if (r < npad) xnorm[r] = r < n ? (float)acc : INFINITY;
    else if (r - npad < B) qnorm[r - npad] = (float)acc;
  }
}

namespace k2 {

// The launch's shape, chosen from B, n, D and k alone: two consumer
// warpgroups (128 queries a block) where their lists, buffers and a ring of
// at least 4 stages fit, else one; the queries resident where they take at
// most RESIDENT_MAX bytes, else streamed chunk by chunk beside the corpus;
// the corpus split across blocks while the groups of queries fill fewer
// than the card's SMs.
struct Plan {
  Layout lay;
  int groups, split, tiles, smem;
};

Plan plan_for(int n, int B, int D, int k, int sms) {
  Plan pl{};
  const int nch = D / KC;
  for (int nwg = 2; nwg >= 1; --nwg) {
    Layout lay{nwg, nwg * nch * Q_BYTES <= RESIDENT_MAX, 0, nch, k};
    const int room = SMEM_LIMIT - lay.bytes();  // with no stage
    lay.nst = std::min(MAX_STAGES, room / lay.stage_bytes());
    pl.lay = lay;
    if (lay.nst >= (nwg == 2 ? 4 : 2)) break;
  }
  pl.groups = (B + pl.lay.qpb() - 1) / pl.lay.qpb();
  pl.tiles = (n + TN - 1) / TN;
  pl.split = std::max(1, std::min(sms / pl.groups, pl.tiles / MIN_SPLIT_TILES));
  pl.smem = pl.lay.bytes();
  return pl;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  return sms;
}

// workspace: the tickets, the corpus norms, the query norms, the splits' lists
struct Workspace {
  size_t tickets, xnorm, qnorm, partial, bytes;
};

Workspace workspace_for(const Plan& pl, int B, int k) {
  auto up = [](size_t v) { return (v + 255) / 256 * 256; };
  Workspace w{};
  w.tickets = 0;
  w.xnorm = up((size_t)pl.groups * 4);
  w.qnorm = w.xnorm + up((size_t)pl.tiles * TN * 4);
  w.partial = w.qnorm + up((size_t)B * 4);
  w.bytes = w.partial + (pl.split > 1 ? (size_t)pl.groups * pl.split * pl.lay.qpb() * k * 8 : 0);
  return w;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime: the library links no libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a (rows, D) bf16 tensor in boxes of KC features x box_rows rows, 128-byte swizzled
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int D, int box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, estrides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const void* q, const void* x, int n, int B, int D, int k, void* out_ids, void* out_d, void* ws,
           void* passes, void* stream) {
  if (k < 1 || k > KMAX || D % KC != 0 || n < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const Plan pl = plan_for(n, B, D, k, sm_count());
  const Workspace w = workspace_for(pl, B, k);
  char* wsb = static_cast<char*>(ws);
  CUtensorMap tq, tx;
  if (!tensor_map(&tq, q, B, D, QW) || !tensor_map(&tx, x, n, D, TN)) return (int)cudaErrorNotSupported;
  const cudaStream_t st = (cudaStream_t)stream;
  const int npad = pl.tiles * TN;
  const long long rows = (long long)npad + B;
  flat_norms_kernel<<<(unsigned)((rows + 31) / 32), 256, 0, st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)q, n, B, D, npad, (float*)(wsb + w.xnorm),
      (float*)(wsb + w.qnorm), (int*)(wsb + w.tickets), pl.groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto kernel = pl.lay.nch > 2 && pl.lay.nch % 2 == 0 ? flat_topk_kernel<true> : flat_topk_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return (int)err;
  const Params p{(const float*)(wsb + w.xnorm), (const float*)(wsb + w.qnorm), (int*)out_ids, (float*)out_d,
                 (key64*)(wsb + w.partial), (int*)(wsb + w.tickets), (unsigned long long*)passes,
                 n, B, k, pl.lay.nwg, pl.lay.resident, pl.lay.nst, pl.lay.nch, pl.split, pl.tiles};
  kernel<<<pl.groups * pl.split, (pl.lay.nwg + 1) * WG_THREADS, pl.smem, st>>>(tq, tx, p);
  return (int)cudaGetLastError();
}

}  // namespace k2

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

// Dynamic shared memory of one block of K2-s8 (the old tile: the same for
// every D) and of K3 / K3-s8.
int expann_flat_topk_smem_bytes(int D, int k) {
  (void)D;
  return smem_bytes(k);
}

// K2's dynamic shared memory (its plan's, which depends on D and k alone).
int expann_flat_topk_bf16_smem_bytes(int D, int k) {
  return k2::plan_for(1, 1, D, k, k2::sm_count()).smem;
}

// Bytes of the device workspace that K2 needs for this call, on the
// current device: the split's tickets, the norms, the splits' lists.
int expann_flat_topk_workspace_bytes(int n, int B, int D, int k) {
  if (k < 1 || k > KMAX || D % k2::KC != 0 || n < 1 || B < 1) return 0;
  const k2::Plan pl = k2::plan_for(n, B, D, k, k2::sm_count());
  return (int)k2::workspace_for(pl, B, k).bytes;
}

// K2's plan for a call on the current device, into out[0..6]: consumer
// warpgroups, queries resident, ring stages, query groups, corpus splits,
// tiles, dynamic shared memory.
int expann_flat_topk_plan(int n, int B, int D, int k, void* out) {
  const k2::Plan pl = k2::plan_for(std::max(n, 1), std::max(B, 1), D, k, k2::sm_count());
  int* o = static_cast<int*>(out);
  o[0] = pl.lay.nwg;
  o[1] = pl.lay.resident;
  o[2] = pl.lay.nst;
  o[3] = pl.groups;
  o[4] = pl.split;
  o[5] = pl.tiles;
  o[6] = pl.smem;
  return 0;
}

int expann_flat_topk_fixed_smem_bytes(int D, int k) { return smem_bytes(k); }

// K2: the norms kernel, then the scan, on `stream`; returns
// cudaGetLastError() (0 on success).  The caller guarantees: n, B >= 1,
// D % 64 == 0, 1 <= k <= 128, rows 16-byte aligned; `workspace` holds
// expann_flat_topk_workspace_bytes(n, B, D, k) bytes; `passes` is one
// int64 on the device, to which the scan adds the candidates its filter
// passed.
int expann_flat_topk_bf16(const void* q, const void* x, int n, int B, int D, int k, void* out_ids, void* out_d,
                          void* workspace, void* passes, void* stream) {
  return k2::launch(q, x, n, B, D, k, out_ids, out_d, workspace, passes, stream);
}

// The fixed-pass kernel (K3): the old tile, the same contract, no workspace.
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
