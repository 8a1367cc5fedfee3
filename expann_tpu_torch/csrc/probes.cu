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
//     loop whose exit depends on data?  One block: a warp per row finds the
//     row's first argmin lane by shuffle butterflies; row 0's lane, mod the
//     table size, picks the 4 KB table entry that one thread copies into
//     shared memory; then `c = -100; while (c < min(x[0, :8])) c += 1`, its
//     count written as f32.  Bound: latency (one block, ~16 KB moved).
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
//     copies the T*E = 32 blocks packed[(i*131 + c) % 4096] (c < 32)
//     through a ring of NSLOT slots, waits for every copy, and adds row 0
//     of the first block times 1e-9.  The TPU kernel copied into a 1 MiB
//     scratch; a block has 227 KB, so the ring stands in for it and every
//     copy still happens.  The copy indices do not depend on the tile: all
//     tiles read the same <= 768 blocks (~24 MB), which L2 holds, so the
//     `dma` reading is an L2 copy cost.  `scratch` allocates the shared
//     memory the TPU kernel's scratch stood for and does not use it;
//     `while1` / `while6` carry 1 / 5 more values through the loop in
//     registers (on this card a counted loop and a while loop compile
//     alike).  Bound: bytes (beam in and out, the distinct blocks).
//
// P4  The cost of one warp-level lane operation: one warp per 128-wide row
//     (4 values a lane, columns 4*lane .. 4*lane+3), T=8 warps a block, G
//     blocks, ITERS chained steps of the mode's operation: min and argmin by
//     __shfl_xor_sync butterflies, jnp.roll by __shfl_sync plus a rotation
//     in registers, the broadcast of lane 3 by __shfl_sync, the inclusive
//     prefix sum (the TPU took it as a product with a triangular matrix on
//     its matrix unit) by a warp scan.  Every step depends on the one
//     before and ITERS is a launch argument, so nothing folds.  Bound:
//     latency of the dependent chain; its f32 operations are far below the
//     card's peak.
//
// Every elementwise update uses __fmul_rn / __fadd_rn: no contraction into
// an FMA, so the kernels repeat the plain versions' rounding exactly.
// Every wait on an mbarrier gives up after WAIT_TIMEOUT_NS (a copy that
// never lands: a wrong size or address); the kernel then writes NaN where
// its results would go, so a fault fails the comparison with the plain
// version instead of hanging the card.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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

// one thread; then fence_barrier_init and a block barrier before any use
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// order this thread's earlier shared-memory accesses (made visible to it by
// a block barrier) before a bulk copy that overwrites them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One thread: arm `bar` for `bytes` and start the copy of `bytes` from
// global `src` into shared `dst`; the copy completes the barrier's phase.
// `src`, `dst` and `bytes` are multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed; false
// after WAIT_TIMEOUT_NS.
__device__ __forceinline__ bool barrier_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  const uint64_t t0 = global_ns();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return true;
    if (global_ns() - t0 > WAIT_TIMEOUT_NS) return false;
  }
}

// ---------------------------------------------------------------------------
// warp reductions

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = min(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float row_min4(const float d[4]) {
  return warp_min(fminf(fminf(d[0], d[1]), fminf(d[2], d[3])));
}

// ---------------------------------------------------------------------------
// P1

constexpr int P1_ROWS = 8, P1_W = 128;
constexpr unsigned P1_ENTRY_BYTES = P1_ROWS * P1_W * 4;  // 4 KB

__global__ void __launch_bounds__(P1_ROWS * 32)
probe_fused_kernel(const float* __restrict__ tab,  // (n_tab, 8, 128)
                   const float* __restrict__ x,    // (8, 128)
                   float* __restrict__ o,          // (8, 128)
                   float* __restrict__ w,          // (8, 128)
                   int n_tab, int max_iters) {
  __shared__ __align__(128) float buf[P1_ROWS * P1_W];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int sel[P1_ROWS];
  const int tid = threadIdx.x, row = tid >> 5, lane = tid & 31;

  // 1. each row's first argmin lane: ascending columns, ties to the lower
  float v = INFINITY;
  int l = INT_MAX;
  for (int c = lane; c < P1_W; c += 32) {
    const float xv = x[row * P1_W + c];
    if (xv < v) {
      v = xv;
      l = c;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int ol = __shfl_xor_sync(FULL, l, off);
    if (ov < v || (ov == v && ol < l)) {
      v = ov;
      l = ol;
    }
  }
  if (lane == 0) sel[row] = l;
  if (tid == 0) {
    barrier_init(&bar);
    fence_barrier_init();
  }
  __syncthreads();

  // 2-3. the copy of tab[lane(row 0) % n_tab], its address computed here
  if (tid == 0) bulk_load(buf, tab + (size_t)(sel[0] % n_tab) * P1_ROWS * P1_W, P1_ENTRY_BYTES, &bar);
  const bool ok = __syncthreads_and(barrier_wait(&bar, 0));

  // 4. the loop whose exit depends on the data
  float m = x[0];
  for (int j = 1; j < 8; ++j) m = fminf(m, x[j]);
  float c = -100.f;
  int n = 0;
  while (c < m && n < max_iters) {
    c = __fadd_rn(c, 1.f);
    ++n;
  }
  for (int i = tid; i < P1_ROWS * P1_W; i += blockDim.x) {
    o[i] = ok ? buf[i] : NAN;
    w[i] = ok ? (float)n : NAN;
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
    if (!__syncthreads_and(barrier_wait(&bars[slot], (j / nbuf) & 1))) {
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

constexpr int ST_T = 8, ST_E = 4, ST_W = 128, ST_NSLOT = 4;
constexpr int ST_COPIES = ST_T * ST_E;

__host__ __device__ __forceinline__ int step_scratch_bytes(int RS) {
  // the copy ring, then room for the TPU kernel's (T, E, 2, R) f32 and
  // (T, 128) i32 scratch
  return BAR_BYTES + ST_NSLOT * RS * ST_W * 2 + ST_T * ST_E * 2 * ST_W * 4 + ST_T * 128 * 4;
}

template <bool DMA, int CARRY>
__global__ void __launch_bounds__(ST_T * 32)
step_overhead_kernel(const float* __restrict__ q,                // (B, 128)
                     const float* __restrict__ bd0,              // (B, 128)
                     const __nv_bfloat16* __restrict__ packed,   // (>= modulus, RS, 128)
                     float* __restrict__ out,                    // (B, 128)
                     int iters, int RS, int modulus) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + BAR_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row = (size_t)blockIdx.x * ST_T + warp;
  const size_t blk = (size_t)RS * ST_W;
  const unsigned blk_bytes = (unsigned)(blk * 2);

  const float4 v = reinterpret_cast<const float4*>(bd0 + row * ST_W)[lane];
  float d[4] = {v.x, v.y, v.z, v.w};
  int ids[4] = {0, 0, 0, 0}, ex[4] = {0, 0, 0, 0}, dn = 0, nc = 0;
  if (DMA) {
    if (tid == 0) {
      for (int s = 0; s < ST_NSLOT; ++s) barrier_init(&bars[s]);
      fence_barrier_init();
    }
    __syncthreads();
  }

  bool ok = true;
  for (int it = 0; it < iters && ok; ++it) {
    const float m = row_min4(d);
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = __fadd_rn(d[k], __fmul_rn(m, 1e-6f));
    if (DMA) {
      float r0[4] = {0.f, 0.f, 0.f, 0.f};
      if (tid == 0) {
        fence_proxy_async();  // slot 0 was read in the step before
        for (int c = 0; c < ST_NSLOT; ++c)
          bulk_load(ring + c * blk, packed + (size_t)((it * 131 + c) % modulus) * blk, blk_bytes, &bars[c]);
      }
      for (int c = 0; c < ST_COPIES; ++c) {
        const unsigned g = (unsigned)it * ST_COPIES + c;
        ok = __syncthreads_and(barrier_wait(&bars[c % ST_NSLOT], (g / ST_NSLOT) & 1));
        if (!ok) break;
        // every thread is past copy c-1's slot: refill it
        const int nxt = c - 1 + ST_NSLOT;
        if (tid == 0 && c >= 1 && nxt < ST_COPIES) {
          fence_proxy_async();
          bulk_load(ring + ((c - 1) % ST_NSLOT) * blk, packed + (size_t)((it * 131 + nxt) % modulus) * blk,
                    blk_bytes, &bars[(c - 1) % ST_NSLOT]);
        }
        if (c == 0) {  // row 0 of block (qi=0, e=0)
          const uint2 raw = reinterpret_cast<const uint2*>(ring)[lane];
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
          const float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
          r0[0] = a.x;
          r0[1] = a.y;
          r0[2] = b.x;
          r0[3] = b.y;
        }
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
  const float q0 = q[(size_t)blockIdx.x * ST_T * ST_W];  // q[tile * T, 0]
  float4 res;
  res.x = ok ? __fadd_rn(d[0], __fmul_rn(q0, 0.f)) : NAN;
  res.y = ok ? __fadd_rn(d[1], __fmul_rn(q0, 0.f)) : NAN;
  res.z = ok ? __fadd_rn(d[2], __fmul_rn(q0, 0.f)) : NAN;
  res.w = ok ? __fadd_rn(d[3], __fmul_rn(q0, 0.f)) : NAN;
  reinterpret_cast<float4*>(out + row * ST_W)[lane] = res;
}

// ---------------------------------------------------------------------------
// P4

constexpr int LN_T = 8, LN_W = 128;
enum LaneMode {
  L_REDUCE, L_REDUCE3, L_STAGE, L_STAGE64, L_BCAST, L_CUMSUM, L_CARRY2, L_CARRY3, L_CARRY_N1, L_CARRY6, L_MODES
};

template <int MODE>
__global__ void __launch_bounds__(LN_T * 32)
probe_lanes_kernel(const float* __restrict__ x, float* __restrict__ o, int rows, int iters) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * LN_T + warp;
  if (row >= (size_t)rows) return;
  const float4 v = reinterpret_cast<const float4*>(x + row * LN_W)[lane];
  float d[4] = {v.x, v.y, v.z, v.w};
  int ids[4] = {0, 0, 0, 0}, ex[4] = {0, 0, 0, 0}, dn = 0, nc = 0;
  constexpr bool CARRY = MODE >= L_CARRY2;

  for (int i = 0; i < iters; ++i) {
    if (MODE == L_REDUCE || CARRY) {
      const float m = row_min4(d);
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
      // the min, the first lane holding it, and the value at that lane
      const float m = row_min4(d);
      int ls = INT_MAX;
#pragma unroll
      for (int k = 3; k >= 0; --k)
        if (d[k] == m) ls = 4 * lane + k;
      ls = warp_min_int(ls);
      float val = INFINITY;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * lane + k == ls) val = d[k];
      val = warp_min(val);
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
cudaError_t launch_lanes(const float* x, float* o, int rows, int iters, cudaStream_t stream) {
  probe_lanes_kernel<MODE><<<(rows + LN_T - 1) / LN_T, LN_T * 32, 0, stream>>>(x, o, rows, iters);
  return cudaGetLastError();
}

template <bool DMA, int CARRY>
cudaError_t launch_step(const float* q, const float* bd0, const __nv_bfloat16* packed, float* out, int B,
                        int RS, int iters, int modulus, int smem, cudaStream_t stream) {
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(step_overhead_kernel<DMA, CARRY>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  step_overhead_kernel<DMA, CARRY><<<B / ST_T, ST_T * 32, smem, stream>>>(q, bd0, packed, out, iters, RS, modulus);
  return cudaGetLastError();
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
  probe_fused_kernel<<<1, P1_ROWS * 32, 0, (cudaStream_t)stream>>>(
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

int expann_step_overhead_smem_bytes(int RS) { return step_scratch_bytes(RS); }

// P3.  q, bd0 (B, 128) f32, packed (>= modulus, RS, 128) bf16 -> out
// (B, 128) f32; B % 8 == 0, RS >= 1; carry 0 (fori), 1 (while1), 6 (while6).
int expann_step_overhead(const void* q, const void* bd0, const void* packed, void* out, int B, int RS,
                         int iters, int modulus, int dma, int scratch, int carry, void* stream) {
  if (B < ST_T || B % ST_T != 0 || RS < 1 || iters < 0 || modulus < 1 || (carry != 0 && carry != 1 && carry != 6))
    return (int)cudaErrorInvalidValue;
  const int smem = (dma || scratch) ? step_scratch_bytes(RS) : 0;
  const auto* qq = (const float*)q;
  const auto* b0 = (const float*)bd0;
  const auto* pk = (const __nv_bfloat16*)packed;
  auto* o = (float*)out;
  const auto st = (cudaStream_t)stream;
  cudaError_t err;
  if (dma)
    err = carry == 6 ? launch_step<true, 6>(qq, b0, pk, o, B, RS, iters, modulus, smem, st)
          : carry == 1 ? launch_step<true, 1>(qq, b0, pk, o, B, RS, iters, modulus, smem, st)
                       : launch_step<true, 0>(qq, b0, pk, o, B, RS, iters, modulus, smem, st);
  else
    err = carry == 6 ? launch_step<false, 6>(qq, b0, pk, o, B, RS, iters, modulus, smem, st)
          : carry == 1 ? launch_step<false, 1>(qq, b0, pk, o, B, RS, iters, modulus, smem, st)
                       : launch_step<false, 0>(qq, b0, pk, o, B, RS, iters, modulus, smem, st);
  return (int)err;
}

// P4.  x (rows, 128) f32 -> o (rows, 128) f32; mode is the index into
// expann_tpu_torch/tools/probe_lanes.py:MODES.
int expann_probe_lanes(const void* x, void* o, int rows, int iters, int mode, void* stream) {
  if (rows < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  const auto* xx = (const float*)x;
  auto* oo = (float*)o;
  const auto st = (cudaStream_t)stream;
  switch (mode) {
    case L_REDUCE: return (int)launch_lanes<L_REDUCE>(xx, oo, rows, iters, st);
    case L_REDUCE3: return (int)launch_lanes<L_REDUCE3>(xx, oo, rows, iters, st);
    case L_STAGE: return (int)launch_lanes<L_STAGE>(xx, oo, rows, iters, st);
    case L_STAGE64: return (int)launch_lanes<L_STAGE64>(xx, oo, rows, iters, st);
    case L_BCAST: return (int)launch_lanes<L_BCAST>(xx, oo, rows, iters, st);
    case L_CUMSUM: return (int)launch_lanes<L_CUMSUM>(xx, oo, rows, iters, st);
    case L_CARRY2: return (int)launch_lanes<L_CARRY2>(xx, oo, rows, iters, st);
    case L_CARRY3: return (int)launch_lanes<L_CARRY3>(xx, oo, rows, iters, st);
    case L_CARRY_N1: return (int)launch_lanes<L_CARRY_N1>(xx, oo, rows, iters, st);
    case L_CARRY6: return (int)launch_lanes<L_CARRY6>(xx, oo, rows, iters, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
