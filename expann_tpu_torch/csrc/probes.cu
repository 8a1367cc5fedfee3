// Hopper counterparts of the repo's four TPU capability probes (tools/):
//
//   P1 probe_fused_kernel    tools/probe_fused.py:probe_kernel (:26, call :60)
//   P2 block_gather_kernel   tools/perf_pallas_gather.py:_kernel (:34,
//                            launcher run_block_gather :63, call :78)
//   P3 step_overhead_kernel  tools/probe_step_overhead.py:make(feat) (:30,
//                            body :33, call :98)
//   P4 probe_lanes_kernel    tools/probe_lanes.py:make_kernel (:43, call :134)
//
// Each computes what its TPU kernel computes (the plain PyTorch versions in
// expann_tpu_torch/tools/ say it again) and answers the same question for
// this card:
//
// P1  Can a kernel start a bulk asynchronous copy (`cp.async.bulk`, completed
//     on an `mbarrier`) whose source address it computed itself, and run a
//     loop whose exit depends on data?  One block of two warps, each on its
//     own chain, with no block barrier.  Warp 0 runs the address chain: it
//     loads row 0 (a float4 a lane), finds its first argmin lane by shuffle
//     butterflies, and its lane 0 (which initialised the mbarrier at entry)
//     starts the copy of the 4 KB entry tab[lane % n_tab]; when it lands the
//     entry leaves by one bulk store.  Warp 1 runs the loop beside the copy:
//     `c = -100; while (c < min(x[0, :8])) c += 1` (the same f32 adds, the
//     same exit test, at most max_iters steps), its count written as f32 by
//     16-byte stores.  The other rows' argmins, which no output reads, are
//     not computed.  Bound: latency (one block, ~16 KB moved).
//
// P2  The rate of random block gathers: G steps, step i copies the R x D
//     bf16 block packed[ids[i]] into shared memory and scores it against
//     one bf16 query (f32 sums), out[i] = q . block^T.  A persistent grid (as
//     many blocks as fit on the SMs) walks the steps with a stride; each
//     block keeps an NBUF-slot ring of blocks in flight, one `mbarrier` per
//     slot, the next copy into a slot issued as soon as every thread has
//     scored it.  Bound: HBM bytes (G R D 2 read, G R 4 written).  The ring
//     must fit one block's shared memory (227 KB): the wrapper refuses a
//     larger one (R=128, NBUF=8 is 256 KB).
//
// P3  The fixed cost of one step of a traversal-shaped kernel: one block
//     per T=8-row tile of an (B, 128) f32 beam, ITERS steps of
//     d += rowmin(d) * 1e-6 (a warp per row); with `dma` each step also
//     copies the T*E = 32 blocks packed[(i*131 + c) % 4096] (c < 32) into
//     the tile's shared memory, waits for every copy, and adds row 0 of the
//     first block times 1e-9.  The copy indices do not depend on the tile,
//     so every tile reads the same <= 768 blocks (~24 MB), which L2 holds.
//     The tiles of a thread-block cluster of c blocks share each L2 read:
//     the cluster's blocks split a step's 32 copies between them, and each
//     issues its share as one multicast bulk copy that lands in every block
//     of the cluster, so a call reads its bytes from L2 once a cluster, not
//     once a tile.  A ring of NSLOT slots carries the copies, each slot with
//     a full mbarrier (its bytes, armed by the block's producer warp) and an
//     empty one (one arrival from every row warp of every block of the
//     cluster, by `mapa` and `mbarrier.arrive` on the peer's barrier); a
//     block's producer multicasts into a slot only once its empty barrier
//     says that every block has read it.  Row warps wait on full barriers
//     only: no block barrier in the loop.  The ring alone (~96 KB at 32 KB
//     blocks) is the `dma` footprint, so two tiles reside on an SM;
//     `scratch` reserves the same bytes and does not use them, so the two
//     readings differ by the copies alone.  The grid is padded to a
//     multiple of c: a padded block takes part in its cluster's copies and
//     barriers and writes no row.
//     `while1` / `while6` carry 1 / 5 more values through the loop in
//     registers (on this card a counted loop and a while loop compile
//     alike).  Bound: bytes (beam in and out, the distinct blocks once).
//     What sets the `dma` time on an H100 is each SM's intake from L2, ~64
//     bytes a clock, which clusters of 4-8 blocks reach; the L2 reads they
//     save do not show.  A one-block cluster issues plain bulk copies: a
//     multicast to one block ran at about half their rate.
//
// P4  The cost of one warp-level lane operation: one warp per 128-wide row
//     (4 values a lane, columns 4*lane .. 4*lane+3), `warps` warps a block
//     (a launch argument, 1-8), ITERS chained steps of the mode's operation.
//     A row's min is the lane's own min of its 4 values, then one
//     `redux.sync` (__reduce_min_sync) on the orderable key of it (keys.cuh),
//     then back to f32, as K1 reduces (fused_search.cu): one instruction on
//     the chain where a 5-level __shfl_xor_sync butterfly put five shuffle
//     round trips.  `reduce3` chains three such reductions a step: the min,
//     the first column holding it (a redux of the int column), the value at
//     that column.  jnp.roll is a __shfl_sync plus a rotation in registers,
//     the broadcast of lane 3 a __shfl_sync, the inclusive prefix sum (the
//     TPU took it as a product with a triangular matrix on its matrix unit)
//     a warp scan.  Every step performs its mode's reductions on data that
//     depends on the step before, and ITERS is a launch argument, so
//     nothing folds.  The tool launches 4 warps a block, one on each of an
//     SM's schedulers (1 a block ties with it); 8 a block put two chains on
//     a scheduler and were slower a step on an NVIDIA H100 80GB HBM3 at
//     700.00 W (up to 7% for the reductions, 14-27% for the compare-exchange
//     stages and the broadcast).  Bound: latency of the dependent chain; its
//     f32 operations are far below the card's peak.
//
// Every elementwise update uses __fmul_rn / __fadd_rn: no contraction into
// an FMA, so the kernels repeat the plain versions' rounding exactly.
// Every wait on an mbarrier gives up after WAIT_TIMEOUT_NS (a copy that
// never lands: a wrong size or address); the kernel then writes NaN where
// the copied data would go, so a fault fails the comparison with the plain
// version instead of hanging the card.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "keys.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long WAIT_TIMEOUT_NS = 2000000000ull;  // 2 s
constexpr int BAR_BYTES = 128;  // room for 16 mbarriers ahead of the buffers

// ---------------------------------------------------------------------------
// bulk copies and mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// one thread; then fence_barrier_init and a barrier (of the block, the
// warp or the cluster: whoever uses it) before any use
__device__ __forceinline__ void barrier_init(uint64_t* bar, unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// order this thread's earlier shared-memory accesses (made visible to it by
// a block barrier) before a bulk copy that overwrites them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One thread: arm this block's `bar` for `bytes` more (its one arrival).
__device__ __forceinline__ void barrier_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// One thread: copy `bytes` from global `src` into this block's shared `dst`,
// completing `bytes` on `bar` (armed for them).  Multiples of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One thread: arm `bar` for `bytes` and start the copy of `bytes` from
// global `src` into shared `dst`; the copy completes the barrier's phase.
// `src`, `dst` and `bytes` are multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  barrier_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// Wait until the phase of parity `parity` of `bar` has completed; false
// after WAIT_TIMEOUT_NS.  `try_wait` suspends the thread until the phase
// completes or a time the card sets runs out; the clock is read only every
// WAIT_POLLS polls, never on the first.  (On an H100 an explicit 10 ms
// suspend-time hint made P3 ~8% slower at its cluster size, and a wait that
// acquires at cluster scope, with arrivals released at cluster scope,
// 1.6-2.5x slower.)
constexpr unsigned WAIT_POLLS = 8;

__device__ __forceinline__ bool barrier_wait_polled(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint64_t t0 = 0;
  for (unsigned n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return true;
    if (n % WAIT_POLLS == 0) {
      const uint64_t t = global_ns();
      if (n == 0)
        t0 = t;
      else if (t - t0 > WAIT_TIMEOUT_NS)
        return false;
    }
  }
}

// One thread: copy `bytes` from global `src` to shared `dst` in every block
// of `mask` (the same offset in each), completing `bytes` on the barrier at
// `bar`'s offset in each.  Multiples of 16.
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src, unsigned bytes, uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], "
      "%4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// One thread: copy `bytes` from shared `src` to global `dst` and wait until
// the copy has read its source.  Multiples of 16.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// Every thread of the cluster: what each wrote before is seen by all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

// One arrival on the barrier at `bar`'s offset in block `cta` of the
// cluster (a release at the default scope, as CUTLASS's TMA pipelines
// release a peer's slot).
__device__ __forceinline__ void arrive_in(uint64_t* bar, unsigned cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
}

// ---------------------------------------------------------------------------
// warp reductions

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float lane_min4(const float d[4]) { return fminf(fminf(d[0], d[1]), fminf(d[2], d[3])); }

// P3's row min: a shuffle butterfly (kept, so that P3's step costs stay
// comparable with its earlier readings)
__device__ __forceinline__ float row_min4(const float d[4]) { return warp_min(lane_min4(d)); }

// P4's row min: one redux.sync on the orderable key of the lane's min
__device__ __forceinline__ float row_min_redux(const float d[4]) {
  return from_orderable(__reduce_min_sync(FULL, orderable(lane_min4(d))));
}

// ---------------------------------------------------------------------------
// P1

constexpr int P1_ROWS = 8, P1_W = 128, P1_THREADS = 64;
constexpr unsigned P1_ENTRY_BYTES = P1_ROWS * P1_W * 4;  // 4 KB

__global__ void __launch_bounds__(P1_THREADS)
probe_fused_kernel(const float* __restrict__ tab,  // (n_tab, 8, 128)
                   const float* __restrict__ x,    // (8, 128)
                   float* __restrict__ o,          // (8, 128)
                   float* __restrict__ w,          // (8, 128)
                   int n_tab, int max_iters) {
  __shared__ __align__(128) float buf[P1_ROWS * P1_W];
  __shared__ __align__(8) uint64_t bar;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* o4 = reinterpret_cast<float4*>(o);
  float4* w4 = reinterpret_cast<float4*>(w);

  if (warp == 0) {
    // the address chain: row 0's first argmin lane -> the entry -> its copy
    if (lane == 0) {
      barrier_init(&bar);
      fence_barrier_init();
    }
    const float4 v = reinterpret_cast<const float4*>(x)[lane];  // columns 4 lane .. 4 lane + 3
    float m = v.x;
    int l = 4 * lane;
    if (v.y < m) m = v.y, l = 4 * lane + 1;
    if (v.z < m) m = v.z, l = 4 * lane + 2;
    if (v.w < m) m = v.w, l = 4 * lane + 3;
#pragma unroll
    for (int off = 16; off; off >>= 1) {  // ties to the lower column
      const float om = __shfl_xor_sync(FULL, m, off);
      const int ol = __shfl_xor_sync(FULL, l, off);
      if (om < m || (om == m && ol < l)) m = om, l = ol;
    }
    __syncwarp();  // the barrier's initialisation before any lane waits on it
    if (lane == 0) bulk_load(buf, tab + (size_t)(l % n_tab) * P1_ROWS * P1_W, P1_ENTRY_BYTES, &bar);
    if (__all_sync(FULL, barrier_wait_polled(&bar, 0))) {
      if (lane == 0) {
        fence_proxy_async();
        bulk_store(o, buf, P1_ENTRY_BYTES);
      }
    } else {
      for (int i = lane; i < P1_ROWS * P1_W / 4; i += 32) o4[i] = make_float4(NAN, NAN, NAN, NAN);
    }
  } else {
    // the loop whose exit depends on the data, beside the copy
    const float4 a = reinterpret_cast<const float4*>(x)[0], b = reinterpret_cast<const float4*>(x)[1];
    const float m = fminf(fminf(fminf(a.x, a.y), fminf(a.z, a.w)), fminf(fminf(b.x, b.y), fminf(b.z, b.w)));
    float c = -100.f;
    int n = 0;
    while (c < m && n < max_iters) {
      c = __fadd_rn(c, 1.f);
      ++n;
    }
    const float f = (float)n;
    for (int i = lane; i < P1_ROWS * P1_W / 4; i += 32) w4[i] = make_float4(f, f, f, f);
  }
}

// ---------------------------------------------------------------------------
// P2

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_MAX_NBUF = BAR_BYTES / 8;

__host__ __device__ __forceinline__ int round128(int b) { return (b + 127) / 128 * 128; }

__global__ void __launch_bounds__(GATHER_THREADS)
block_gather_kernel(const __nv_bfloat16* __restrict__ packed,  // (NB, R, D)
                    const int* __restrict__ ids,               // (G,)
                    const __nv_bfloat16* __restrict__ q,       // (D,)
                    float* __restrict__ out,                   // (G, R)
                    int G, int R, int D, int nbuf) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* qs = reinterpret_cast<float*>(smem + BAR_BYTES);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + BAR_BYTES + round128(D * 4));
  const int tid = threadIdx.x;
  const int hw = tid >> 4, hl = tid & 15;  // a half-warp scores one row
  const size_t blk = (size_t)R * D;
  const unsigned blk_bytes = (unsigned)(blk * 2);
  // this block's steps: blockIdx.x + j * gridDim.x, j < count
  const int count = (G - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  for (int i = tid; i < D; i += GATHER_THREADS) qs[i] = __bfloat162float(q[i]);
  if (tid == 0) {
    for (int s = 0; s < nbuf; ++s) barrier_init(&bars[s]);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < nbuf && j < count; ++j)
      bulk_load(ring + j * blk, packed + (size_t)ids[blockIdx.x + j * gridDim.x] * blk, blk_bytes, &bars[j]);

  for (int j = 0; j < count; ++j) {
    const int slot = j % nbuf;
    const size_t step = blockIdx.x + (size_t)j * gridDim.x;
    if (!__syncthreads_and(barrier_wait_polled(&bars[slot], (j / nbuf) & 1))) {
      for (int jj = j; jj < count; ++jj)
        for (int r = tid; r < R; r += GATHER_THREADS) out[(blockIdx.x + (size_t)jj * gridDim.x) * R + r] = NAN;
      return;
    }
    const __nv_bfloat16* b = ring + slot * blk;
    for (int r = hw; r < R; r += GATHER_THREADS / 16) {
      float acc = 0.f;
      for (int c = hl * 8; c < D; c += 128) {
        const uint4 raw = *reinterpret_cast<const uint4*>(b + (size_t)r * D + c);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(h2[k]);
          acc = fmaf(f.x, qs[c + 2 * k], acc);
          acc = fmaf(f.y, qs[c + 2 * k + 1], acc);
        }
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
      if (hl == 0) out[step * R + r] = acc;
    }
    __syncthreads();  // every thread is done with the slot
    if (tid == 0 && j + nbuf < count) {
      fence_proxy_async();
      bulk_load(ring + slot * blk, packed + (size_t)ids[step + (size_t)nbuf * gridDim.x] * blk, blk_bytes,
                &bars[slot]);
    }
  }
}

// ---------------------------------------------------------------------------
// P3

constexpr int ST_T = 8, ST_E = 4, ST_W = 128, ST_NSLOT = 3, ST_MAX_CLUSTER = 16;
constexpr int ST_COPIES = ST_T * ST_E;
constexpr int ST_THREADS = (ST_T + 1) * 32;  // a warp a row, then the producer warp

__host__ __device__ __forceinline__ int step_ring_bytes(int RS) {
  // the full and empty barriers, then the ring
  return BAR_BYTES + ST_NSLOT * RS * ST_W * 2;
}

// The producer (one thread a block): for every copy of the call, in order,
// wait until every block of the cluster has read the slot's previous round
// (so this block's full barrier has completed it), arm this block's full
// barrier for the slot's bytes, and, for this block's share of the copies,
// multicast the block to the whole cluster (a plain copy in a one-block
// cluster).  Stops at a timed-out wait.
__device__ void step_produce(__nv_bfloat16* ring, uint64_t* full, uint64_t* empty,
                             const __nv_bfloat16* __restrict__ packed, size_t blk, unsigned blk_bytes, int iters,
                             int modulus, unsigned csize, unsigned rank) {
  const uint16_t mask = (uint16_t)((1u << csize) - 1);
  const unsigned total = (unsigned)iters * ST_COPIES;
  for (unsigned g = 0; g < total; ++g) {
    const unsigned s = g % ST_NSLOT, k = g / ST_NSLOT;
    if (k > 0 && !barrier_wait_polled(&empty[s], (k - 1) & 1)) return;
    barrier_expect(&full[s], blk_bytes);
    if (g % csize == rank) {
      const unsigned it = g / ST_COPIES, c = g % ST_COPIES;
      const __nv_bfloat16* src = packed + (size_t)((it * 131 + c) % (unsigned)modulus) * blk;
      if (csize == 1)  // a one-block multicast runs at about half a plain copy's rate
        bulk_copy(ring + s * blk, src, blk_bytes, &full[s]);
      else
        bulk_load_multicast(ring + s * blk, src, blk_bytes, &full[s], mask);
    }
  }
}

template <bool DMA, int CARRY>
__global__ void __launch_bounds__(ST_THREADS)
step_overhead_kernel(const float* __restrict__ q,                // (B, 128)
                     const float* __restrict__ bd0,              // (B, 128)
                     const __nv_bfloat16* __restrict__ packed,   // (>= modulus, RS, 128)
                     float* __restrict__ out,                    // (B, 128)
                     int tiles, int iters, int RS, int modulus) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + ST_NSLOT;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + BAR_BYTES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool real = (int)blockIdx.x < tiles;  // a padded block writes no row
  const size_t blk = (size_t)RS * ST_W;
  const unsigned blk_bytes = (unsigned)(blk * 2);
  const unsigned csize = DMA ? cluster_blocks() : 1u, rank = DMA ? cluster_rank() : 0u;

  if (DMA) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < ST_NSLOT; ++s) {
        barrier_init(&full[s]);
        barrier_init(&empty[s], ST_T * csize);
      }
      fence_barrier_init();
    }
    cluster_sync();  // every block's barriers before any multicast or remote arrival
  }

  if (warp == ST_T) {
    if (DMA && lane == 0) step_produce(ring, full, empty, packed, blk, blk_bytes, iters, modulus, csize, rank);
  } else {
    const size_t row = (size_t)blockIdx.x * ST_T + warp;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if (real) {
      const float4 v = reinterpret_cast<const float4*>(bd0 + row * ST_W)[lane];
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
    int ids[4] = {0, 0, 0, 0}, ex[4] = {0, 0, 0, 0}, dn = 0, nc = 0;
    bool ok = true;
    for (int it = 0; it < iters && ok; ++it) {
      const float m = row_min4(d);
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = __fadd_rn(d[k], __fmul_rn(m, 1e-6f));
      if (DMA) {
        float r0[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = 0; c < ST_COPIES; ++c) {
          const unsigned g = (unsigned)it * ST_COPIES + c, s = g % ST_NSLOT;
          ok = __all_sync(FULL, barrier_wait_polled(&full[s], (g / ST_NSLOT) & 1));
          if (!ok) break;
          if (c == 0) {  // row 0 of block (qi=0, e=0)
            const uint2 raw = reinterpret_cast<const uint2*>(ring + s * blk)[lane];
            const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
            const float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
            r0[0] = a.x;
            r0[1] = a.y;
            r0[2] = b.x;
            r0[3] = b.y;
            fence_proxy_async();  // the read before the next multicast into the slot
          }
          __syncwarp();
          if (lane < (int)csize) arrive_in(&empty[s], lane);  // this warp is done with the slot, in every block
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) d[k] = __fadd_rn(d[k], __fmul_rn(r0[k], 1e-9f));
      }
      if (CARRY == 6) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ids[k] ^= 1;
          ex[k] ^= 1;
        }
        dn ^= 1;
        nc += 1;
      }
    }
    if (CARRY == 6) {
      const float extra = (float)(__shfl_sync(FULL, ids[0] + ex[0], 0) + dn + nc);  // column 0
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = __fadd_rn(d[k], __fmul_rn(extra, 0.f));
    }
    if (real) {
      const float q0 = q[(size_t)blockIdx.x * ST_T * ST_W];  // q[tile * T, 0]
      float4 res;
      res.x = ok ? __fadd_rn(d[0], __fmul_rn(q0, 0.f)) : NAN;
      res.y = ok ? __fadd_rn(d[1], __fmul_rn(q0, 0.f)) : NAN;
      res.z = ok ? __fadd_rn(d[2], __fmul_rn(q0, 0.f)) : NAN;
      res.w = ok ? __fadd_rn(d[3], __fmul_rn(q0, 0.f)) : NAN;
      reinterpret_cast<float4*>(out + row * ST_W)[lane] = res;
    }
  }
  if (DMA) cluster_sync();  // no block exits while a multicast may still land in it
}

// ---------------------------------------------------------------------------
// P4

constexpr int LN_MAX_WARPS = 8, LN_W = 128;
enum LaneMode {
  L_REDUCE, L_REDUCE3, L_STAGE, L_STAGE64, L_BCAST, L_CUMSUM, L_CARRY2, L_CARRY3, L_CARRY_N1, L_CARRY6, L_MODES
};

template <int MODE>
__global__ void __launch_bounds__(LN_MAX_WARPS * 32)
probe_lanes_kernel(const float* __restrict__ x, float* __restrict__ o, int rows, int iters) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= (size_t)rows) return;
  const float4 v = reinterpret_cast<const float4*>(x + row * LN_W)[lane];
  float d[4] = {v.x, v.y, v.z, v.w};
  int ids[4] = {0, 0, 0, 0}, ex[4] = {0, 0, 0, 0}, dn = 0, nc = 0;
  constexpr bool CARRY = MODE >= L_CARRY2;

  for (int i = 0; i < iters; ++i) {
    if (MODE == L_REDUCE || CARRY) {
      const float m = row_min_redux(d);
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = __fadd_rn(d[k], __fmul_rn(m, 1e-6f));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (MODE == L_CARRY2 || MODE == L_CARRY3 || MODE == L_CARRY6) ids[k] ^= 1;
        if (MODE == L_CARRY3 || MODE == L_CARRY6) ex[k] ^= 1;
      }
      if (MODE == L_CARRY_N1 || MODE == L_CARRY6) dn ^= 1;
      if (MODE == L_CARRY6) nc += 1;
    } else if (MODE == L_REDUCE3) {
      // the min, the first column holding it, and the value at that column:
      // three redux.sync in a chain
      const float m = row_min_redux(d);
      int ls = INT_MAX;
#pragma unroll
      for (int k = 3; k >= 0; --k)
        if (d[k] == m) ls = 4 * lane + k;
      ls = __reduce_min_sync(FULL, ls);
      float val = INFINITY;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * lane + k == ls) val = d[k];
      val = from_orderable(__reduce_min_sync(FULL, orderable(val)));
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = __fadd_rn(d[k], __fmul_rn(val, 1e-6f));
    } else if (MODE == L_STAGE || MODE == L_STAGE64) {
      // partner = jnp.roll(d, s): column j takes column j - s
      float p[4];
      bool up[4];
      if (MODE == L_STAGE) {
        p[0] = __shfl_sync(FULL, d[3], (lane + 31) & 31);
        p[1] = d[0];
        p[2] = d[1];
        p[3] = d[2];
#pragma unroll
        for (int k = 0; k < 4; ++k) up[k] = (k & 1) == 0;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          p[k] = __shfl_sync(FULL, d[k], (lane + 16) & 31);
          up[k] = lane < 16;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = __fadd_rn(up[k] ? fminf(d[k], p[k]) : fmaxf(d[k], p[k]), 1e-7f);
    } else if (MODE == L_BCAST) {
      const float c = __shfl_sync(FULL, d[3], 0);  // column 3
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = __fadd_rn(d[k], d[k] == c ? 1e-6f : 0.f);
    } else if (MODE == L_CUMSUM) {
      float s[4];
      s[0] = d[0];
      s[1] = __fadd_rn(s[0], d[1]);
      s[2] = __fadd_rn(s[1], d[2]);
      s[3] = __fadd_rn(s[2], d[3]);
      float incl = s[3];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl = __fadd_rn(incl, t);
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = __fadd_rn(d[k], __fmul_rn(__fadd_rn(excl, s[k]), 1e-9f));
    }
  }
  if (MODE == L_CARRY2 || MODE == L_CARRY3 || MODE == L_CARRY6) {
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = __fadd_rn(d[k], __fmul_rn((float)(ids[k] + ex[k]), 0.f));
  }
  if (MODE == L_CARRY_N1 || MODE == L_CARRY6) {
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = __fadd_rn(d[k], __fmul_rn((float)(dn + nc), 0.f));
  }
  reinterpret_cast<float4*>(o + row * LN_W)[lane] = make_float4(d[0], d[1], d[2], d[3]);
}

template <int MODE>
cudaError_t launch_lanes(const float* x, float* o, int rows, int iters, int warps, cudaStream_t stream) {
  probe_lanes_kernel<MODE><<<(rows + warps - 1) / warps, warps * 32, 0, stream>>>(x, o, rows, iters);
  return cudaGetLastError();
}

// P3's launch attributes, set once a device (and again only when a launch
// needs more shared memory than the last setting): its dynamic shared
// memory and the non-portable cluster size (16 blocks).
template <bool DMA, int CARRY>
cudaError_t prepare_step(int smem) {
  constexpr int MAX_DEVICES = 64;
  static int set_plus_one[MAX_DEVICES];  // the device's last setting + 1; 0: none
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem + 1 <= set_plus_one[dev]) return cudaSuccess;
  const auto kern = step_overhead_kernel<DMA, CARRY>;
  if (set_plus_one[dev] == 0 &&
      (err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
    return err;
  set_plus_one[dev] = smem + 1;
  return cudaSuccess;
}

// The launch: ceil(tiles / cluster) clusters of `cluster` blocks.
inline cudaLaunchConfig_t step_config(int tiles, int cluster, int smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((tiles + cluster - 1) / cluster * cluster));
  cfg.blockDim = dim3(ST_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool DMA, int CARRY>
cudaError_t launch_step(const float* q, const float* bd0, const __nv_bfloat16* packed, float* out, int B,
                        int RS, int iters, int modulus, int cluster, int smem, cudaStream_t stream) {
  cudaError_t err = prepare_step<DMA, CARRY>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const int tiles = B / ST_T;
  const cudaLaunchConfig_t cfg = step_config(tiles, cluster, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, step_overhead_kernel<DMA, CARRY>, q, bd0, packed, out, tiles, iters, RS, modulus);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool DMA>
int step_active_clusters(int cluster, int smem) {
  cudaError_t err = prepare_step<DMA, 0>(smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = step_config(cluster, cluster, smem, 0, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, step_overhead_kernel<DMA, 0>, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

}  // namespace

extern "C" {

// The most dynamic shared memory a block of the current device may use.
int expann_smem_optin(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  return v;
}

// P1.  tab (n_tab, 8, 128) f32, x (8, 128) f32 -> o, w (8, 128) f32.
int expann_probe_fused(const void* tab, const void* x, void* o, void* w, int n_tab, int max_iters,
                       void* stream) {
  if (n_tab < 1 || max_iters < 0) return (int)cudaErrorInvalidValue;
  probe_fused_kernel<<<1, P1_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)tab, (const float*)x, (float*)o, (float*)w, n_tab, max_iters);
  return (int)cudaGetLastError();
}

int expann_block_gather_smem_bytes(int R, int D, int nbuf) {
  return BAR_BYTES + round128(D * 4) + nbuf * R * D * 2;
}

// P2.  packed (NB, R, D) bf16, ids (G,) i32 in [0, NB), q (D,) bf16 ->
// out (G, R) f32.  The caller checks that the ring fits
// (expann_block_gather_smem_bytes <= expann_smem_optin).
int expann_block_gather(const void* packed, const void* ids, const void* q, void* out, int G, int R, int D,
                        int nbuf, void* stream) {
  if (G < 1 || R < 1 || D < 8 || D % 8 != 0 || nbuf < 1 || nbuf > GATHER_MAX_NBUF)
    return (int)cudaErrorInvalidValue;
  const int smem = expann_block_gather_smem_bytes(R, D, nbuf);
  cudaError_t err =
      cudaFuncSetAttribute(block_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_gather_kernel, GATHER_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = G < sms * per_sm ? G : sms * per_sm;
  block_gather_kernel<<<grid, GATHER_THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)packed, (const int*)ids, (const __nv_bfloat16*)q, (float*)out, G, R, D, nbuf);
  return (int)cudaGetLastError();
}

int expann_step_overhead_smem_bytes(int RS) { return step_ring_bytes(RS); }

// P3's clusters of `cluster` blocks the current device holds at once, with
// (smem_on) or without the ring; a negative CUDA error code on failure.
int expann_step_overhead_clusters(int RS, int smem_on, int cluster) {
  if (RS < 1 || cluster < 1 || cluster > ST_MAX_CLUSTER) return -(int)cudaErrorInvalidValue;
  return smem_on ? step_active_clusters<true>(cluster, step_ring_bytes(RS)) : step_active_clusters<false>(cluster, 0);
}

// P3.  q, bd0 (B, 128) f32, packed (>= modulus, RS, 128) bf16 -> out
// (B, 128) f32; B % 8 == 0, RS >= 1; carry 0 (fori), 1 (while1), 6 (while6);
// clusters of `cluster` blocks (1-16), the grid padded to a multiple.
int expann_step_overhead(const void* q, const void* bd0, const void* packed, void* out, int B, int RS,
                         int iters, int modulus, int dma, int scratch, int carry, int cluster, void* stream) {
  if (B < ST_T || B % ST_T != 0 || RS < 1 || iters < 0 || modulus < 1 || (carry != 0 && carry != 1 && carry != 6) ||
      cluster < 1 || cluster > ST_MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  const int smem = (dma || scratch) ? step_ring_bytes(RS) : 0;
  const auto* qq = (const float*)q;
  const auto* b0 = (const float*)bd0;
  const auto* pk = (const __nv_bfloat16*)packed;
  auto* o = (float*)out;
  const auto st = (cudaStream_t)stream;
  cudaError_t err;
  if (dma)
    err = carry == 6 ? launch_step<true, 6>(qq, b0, pk, o, B, RS, iters, modulus, cluster, smem, st)
          : carry == 1 ? launch_step<true, 1>(qq, b0, pk, o, B, RS, iters, modulus, cluster, smem, st)
                       : launch_step<true, 0>(qq, b0, pk, o, B, RS, iters, modulus, cluster, smem, st);
  else
    err = carry == 6 ? launch_step<false, 6>(qq, b0, pk, o, B, RS, iters, modulus, cluster, smem, st)
          : carry == 1 ? launch_step<false, 1>(qq, b0, pk, o, B, RS, iters, modulus, cluster, smem, st)
                       : launch_step<false, 0>(qq, b0, pk, o, B, RS, iters, modulus, cluster, smem, st);
  return (int)err;
}

// P4.  x (rows, 128) f32 -> o (rows, 128) f32; mode is the index into
// expann_tpu_torch/tools/probe_lanes.py:MODES; `warps` rows (warps) a block, 1-8.
int expann_probe_lanes(const void* x, void* o, int rows, int iters, int mode, int warps, void* stream) {
  if (rows < 1 || iters < 0 || warps < 1 || warps > LN_MAX_WARPS) return (int)cudaErrorInvalidValue;
  const auto* xx = (const float*)x;
  auto* oo = (float*)o;
  const auto st = (cudaStream_t)stream;
  switch (mode) {
    case L_REDUCE: return (int)launch_lanes<L_REDUCE>(xx, oo, rows, iters, warps, st);
    case L_REDUCE3: return (int)launch_lanes<L_REDUCE3>(xx, oo, rows, iters, warps, st);
    case L_STAGE: return (int)launch_lanes<L_STAGE>(xx, oo, rows, iters, warps, st);
    case L_STAGE64: return (int)launch_lanes<L_STAGE64>(xx, oo, rows, iters, warps, st);
    case L_BCAST: return (int)launch_lanes<L_BCAST>(xx, oo, rows, iters, warps, st);
    case L_CUMSUM: return (int)launch_lanes<L_CUMSUM>(xx, oo, rows, iters, warps, st);
    case L_CARRY2: return (int)launch_lanes<L_CARRY2>(xx, oo, rows, iters, warps, st);
    case L_CARRY3: return (int)launch_lanes<L_CARRY3>(xx, oo, rows, iters, warps, st);
    case L_CARRY_N1: return (int)launch_lanes<L_CARRY_N1>(xx, oo, rows, iters, warps, st);
    case L_CARRY6: return (int)launch_lanes<L_CARRY6>(xx, oo, rows, iters, warps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
