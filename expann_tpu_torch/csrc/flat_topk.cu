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
// K2 / K2-s8: tensor-core distance tiles.
//   Bound on this card: operations.  B x N x D multiply-adds
//   (16384 x 56000 x 128 = 117 G per call) against the tensor cores' dense
//   989 TFLOP/s in bf16 and 1,979 TOP/s in int8: 0.24 / 0.12 ms.  The f32
//   FMA tile these kernels had before (4 x 4 register micro-tiles of `fmaf`)
//   was bound by the 67 TFLOP/s of non-tensor f32 instead, 15x / 30x lower.
//   The corpus (56000 x 128: 14 MB bf16, 7 MB s8) stays in the 50 MB L2; each
//   block streams all of it, so L2 carries B / QB corpus copies per call.
//   Design: one block of 256 threads (8 warps) per QB = 64 queries, as before.
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
//     stores), read by the count-then-insert merge: per query a warp ballot
//     finds the tile's candidates below the query's current k-th (d, id) and
//     only those are inserted (the TPU count kernel's idea, exact; late tiles
//     rarely insert anything).
//   - Why `mma.sync` and not `wgmma`: at even 30% of `mma.sync`'s rate the
//     product is under 1 ms per 16384 x 56000 call, below what the merge and
//     the per-tile barriers take; `wgmma` (with TMA and warp specialisation) is
//     the lever once a trace shows the product as the limit.
//   Tile shape: QB = 64 keeps 256 blocks on the main path's B = 16384, two
//   resident per SM (registers capped at 128 a thread) on 132 SMs; CT = 64
//   gives each warp 16 x 32 outputs (16 accumulators) and the merge two
//   ballots per query and tile.  Shared memory: 3 x 17 KB ring + 18 KB ds +
//   512 k bytes of running lists (74.5 KiB at k=10, 133.5 KiB at k=128), for
//   any D % 64 == 0.
//
// K3 / K3-s8 keep the f32 tile until their own redesign: the query tile in
// shared memory as f32, transposed; corpus tiles of CT=64 rows staged in
// DK=64-feature chunks, transposed, each thread a 4x4 register micro-tile of
// `fmaf` (s8 codes staged to f32, exact); then per tile and per query exactly
// k passes, each a warp argmin by (d, id), an insertion if it beats the
// list's last entry, and the winner knocked out — the TPU fixed kernel's k
// extract+insert passes, exact (its (d, id) tie-break, :132-134).  K3 pays k
// passes on every tile whatever the data; it exists to keep the TPU package's
// `topk_mode="fixed"`.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;        // queries per block
constexpr int CT = 64;        // corpus rows per tile
constexpr int DK = 64;        // features staged per chunk (K3's f32 tile)
constexpr int THREADS = 256;  // 8 warps
constexpr int KMAX = 128;     // largest k (4 list slots per lane)
constexpr unsigned FULL = 0xffffffffu;

// K2's tensor-core tile
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

// ---------------------------------------------------------------------------
// K2 / K2-s8: the tensor-core tile
// ---------------------------------------------------------------------------

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

template <typename T>
__device__ __forceinline__ void count_body(const T* __restrict__ q,  // (B, D)
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

    // count-then-insert: a ballot finds the tile's candidates below the
    // query's current k-th (d, id); only those are inserted
    for (int qi = warp; qi < QB; qi += THREADS / 32) {
      float* Ld = ld + qi * k;
      int* Li = li + qi * k;
#pragma unroll
      for (int j = 0; j < CT / 32; ++j) {
        const int row = lane + 32 * j;
        const float cd = ds[qi * DS_STRIDE + row];
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
  cp_async_wait<0>();  // only empty groups remain
  store_lists(ld, li, q0, B, k, tid, out_ids, out_d);
}

__global__ void __launch_bounds__(THREADS, 2)
    flat_topk_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ x, int n, int B,
                     int D, int k, int* __restrict__ out_ids, float* __restrict__ out_d) {
  count_body<__nv_bfloat16>(q, x, n, B, D, k, out_ids, out_d);
}

__global__ void __launch_bounds__(THREADS, 2)
    flat_topk_s8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ x, int n, int B, int D, int k,
                        int* __restrict__ out_ids, float* __restrict__ out_d) {
  count_body<int8_t>(q, x, n, B, D, k, out_ids, out_d);
}

int count_smem_bytes(int k) {
  return NST * SLOT + (int)sizeof(float) * (QB * DS_STRIDE + QB + CT + QB * k) + (int)sizeof(int) * QB * k;
}

// ---------------------------------------------------------------------------
// K3 / K3-s8: the f32 tile
// ---------------------------------------------------------------------------

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
  store_lists(s.ld, s.li, q0, B, k, tid, out_ids, out_d);
}

__global__ void __launch_bounds__(THREADS)
    flat_topk_fixed_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ x, int n,
                           int B, int D, int k, int* __restrict__ out_ids, float* __restrict__ out_d) {
  fixed_body<__nv_bfloat16>(q, x, n, B, D, k, out_ids, out_d);
}

__global__ void __launch_bounds__(THREADS)
    flat_topk_fixed_s8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ x, int n, int B, int D,
                              int k, int* __restrict__ out_ids, float* __restrict__ out_d) {
  fixed_body<int8_t>(q, x, n, B, D, k, out_ids, out_d);
}

int fixed_smem_bytes(int D, int k) {
  return (int)sizeof(float) * (D * QB + DK * CT + QB * CT + QB + CT + QB * k) +
         (int)sizeof(int) * QB * k;
}

template <typename T>
int launch(void (*kernel)(const T*, const T*, int, int, int, int, int*, float*), int smem, const void* q,
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
  return count_smem_bytes(k);
}

int expann_flat_topk_fixed_smem_bytes(int D, int k) { return fixed_smem_bytes(D, k); }

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller guarantees: D % 64 == 0, 1 <= k <= 128, rows 16-byte aligned.
int expann_flat_topk_bf16(const void* q, const void* x, int n, int B, int D, int k,
                          void* out_ids, void* out_d, void* stream) {
  return launch(flat_topk_kernel, count_smem_bytes(k), q, x, n, B, D, k, out_ids, out_d, stream);
}

// The fixed-pass kernel (K3); same contract.
int expann_flat_topk_fixed_bf16(const void* q, const void* x, int n, int B, int D, int k,
                                void* out_ids, void* out_d, void* stream) {
  return launch(flat_topk_fixed_kernel, fixed_smem_bytes(D, k), q, x, n, B, D, k, out_ids, out_d, stream);
}

// K2-s8 and K3-s8: int8 codes for q and x; same contract (D % 64 == 0
// keeps every row 16-byte aligned).
int expann_flat_topk_s8(const void* q, const void* x, int n, int B, int D, int k, void* out_ids,
                        void* out_d, void* stream) {
  return launch(flat_topk_s8_kernel, count_smem_bytes(k), q, x, n, B, D, k, out_ids, out_d, stream);
}

int expann_flat_topk_fixed_s8(const void* q, const void* x, int n, int B, int D, int k,
                              void* out_ids, void* out_d, void* stream) {
  return launch(flat_topk_fixed_s8_kernel, fixed_smem_bytes(D, k), q, x, n, B, D, k, out_ids, out_d,
                stream);
}

const char* expann_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
