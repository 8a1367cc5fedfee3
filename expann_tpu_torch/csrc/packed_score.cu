// Per-iteration block scorer over the packed bf16 neighbour layout (K4).
//
// Replaces expann_tpu/ops/pallas_beam.py:_beam_score_kernel (launcher
// `packed_score` :180, call :234).
//
// What it computes, for every (query b, selected node e) pair: the node's
// packed block of RS neighbour rows scored against the query,
//   d[r] = norms[node, r] - 2 q.x_r    (q rounded to bf16, f32 sums,
//                                        no |q|^2 and no clamp),
// for the R_tile slots of the node's aux row (slots >= RS have a +inf
// norm and no row, so they come out +inf), with ids[r] = ids[node, r].
// With topt = t > 0 only the node's t best by (d, lane) leave the kernel,
// ascending; a pass past the node's finite slots gives
// (+inf, ids[node, 0]), as the TPU kernel's t argmin passes do.  A
// sentinel node (all norms +inf) gives all +inf.
//
// What bounds it on this card.  Small B (the per-iteration route: B <= 32,
// E = 2, at most 64 blocks on 132 SMs): latency.  One pair is a chain of
// dependent steps, sel[p], then its 32 KB block (128 x 128 bf16) and aux
// rows at that address, then the dots, then the selection; the card is
// never short of bandwidth there.  Large B: HBM bytes, one block and two
// aux rows per pair.  Six blocks resident per SM (34,432 bytes of shared
// memory each at the canonical widths, at most 80 registers a thread for
// R_tile <= 256) keep enough copies in flight; each block's copy is idle
// only while it scores and selects, which the others hide.
//
// Design: one 128-thread block per pair (grid B * E).
//  * Copy.  As soon as sel[p] is read, one thread starts one bulk
//    asynchronous copy (`cp.async.bulk`, completed on an mbarrier with
//    complete_tx bytes) of the node's whole block, a contiguous RS * D * 2
//    byte range, into shared memory, and in the same wave the aux rows
//    (norms and ids, R_tile x 4 B each) when they are 16-byte aligned
//    (R_tile % 4 == 0; coalesced loads otherwise).  The other threads load
//    the query meanwhile.  A block larger than one 32 KB slot is staged in
//    16-row-aligned chunks through two slots, the next chunk's copy in
//    flight while the current one is scored.  The sentinel starts no copy.
//    Every wait gives up after WAIT_TIMEOUT_NS (a copy that never lands);
//    the pair's outputs are then NaN with the sentinel id, so a fault fails
//    the comparison with the plain version instead of hanging the card.
//    After the wait nothing but the output stores touches global memory.
//  * Score.  A half-warp owns 16 rows.  Lane l reads columns 8 l + 128 m
//    of each row (16-byte loads, a half-warp covers 256 contiguous bytes
//    of one row: no bank conflict) against the bf16-rounded query in
//    shared memory, f32 sums; then a transposing butterfly (8 + 4 + 2 + 1
//    shuffles instead of 16 x 4) leaves row l's whole dot in lane l.  The
//    tensor cores do not help: one query against RS rows is a matrix-vector
//    product (M = 1) and the limit is latency.
//  * Select.  Every slot becomes one 64-bit key (orderable(d) << 32) | lane
//    and a bitonic network sorts the keys ascending, P = 128 x KPT of them
//    (KPT keys a thread, element i * 128 + tid, pads of ~0 above every
//    slot): stages whose partner is in the warp are 64-bit shuffles, those
//    across warps go through shared memory (three at R_tile = 128), those
//    across a thread's own keys stay in registers.  No data-dependent exit.
//    d can be negative here (no |q|^2, no clamp), so orderable() is the
//    full sign-aware map: a negative float has every bit flipped, a
//    non-negative one its sign bit (and -0 counts as +0), so the unsigned
//    order of the keys is the (d, lane) order.  The first t keys are
//    written out; wherever the selected d is +inf the id is ids[node, 0]
//    (the lane-0 rule of the TPU kernel's exhausted passes), not the id of
//    the +inf lane.  topt = 0 writes all R_tile slots in lane order.
//
// Contract (the wrapper checks it): D % 8 == 0, RS % 16 == 0, RS <= R_tile
// <= 128 * KPT_MAX, 0 <= topt <= R_tile, E >= 1, any B, 16-byte aligned
// rows, and the staging plan within the card's shared memory per block
// (D up to ~6000 at R_tile = 128; the TPU kernel's own VMEM limit stops at
// D = 512 for E = 2).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "keys.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 16;            // rows a half-warp scores at once
constexpr int STAGE_BYTES = 32768;   // one staging slot
constexpr int SMEM_LIMIT = 232448;   // shared memory a block may use (227 KB)
constexpr int HEADER = 128;          // the two mbarriers, then the stage region
constexpr int KPT_MAX = 16;          // keys a thread: R_tile <= 2048
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long WAIT_TIMEOUT_NS = 2000000000ull;  // 2 s

using key64 = unsigned long long;
constexpr key64 KEY_PAD = ~0ull;

// ---------------------------------------------------------------------------
// the staging plan, the same on the host and the card

struct Plan {
  int cr;     // rows a chunk (a multiple of 16, <= RS)
  int nc;     // chunks
  int nslot;  // slots: 1, or 2 for a block of several chunks
  int slot;   // bytes a slot
  int smem;   // dynamic shared memory of one block
};

__host__ __device__ inline int keys_per_thread(int Rt) {
  int kpt = 1;
  while (kpt * THREADS < Rt) kpt *= 2;
  return kpt;
}

__host__ __device__ inline Plan make_plan(int D, int RS, int Rt) {
  Plan p;
  const int rb = 2 * D;
  p.cr = RS * rb <= STAGE_BYTES ? RS : (STAGE_BYTES / rb / GROUP) * GROUP;
  if (p.cr < GROUP) p.cr = GROUP;
  p.nc = (RS + p.cr - 1) / p.cr;
  p.slot = p.cr * rb;
  const int keys = 2 * 8 * keys_per_thread(Rt) * THREADS;  // the network's two exchange buffers
  const int tail = 4 * D + 8 * Rt;                         // query, norms, ids
  for (p.nslot = p.nc > 1 ? 2 : 1;; p.nslot = 1) {
    const int region = p.nslot * p.slot > keys ? p.nslot * p.slot : keys;
    p.smem = HEADER + region + ((tail + 15) & ~15);
    if (p.smem <= SMEM_LIMIT || p.nslot == 1) break;
  }
  return p;
}

// ---------------------------------------------------------------------------
// bulk copies and mbarriers (the pattern of probes.cu)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// one thread; then fence_barrier_init and a block barrier before any wait
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

// One thread: arm `bar` for `bytes` in all, then start each copy on it.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// `src`, `dst` and `bytes` are multiples of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
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
// scoring

// one butterfly step of group_dot: a lane with bit H set keeps the upper H
// of its 2H partial sums and sends the lower H, its partner the reverse
template <int H>
__device__ __forceinline__ void fold(float* part, int hl) {
  const bool up = (hl & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? part[i] : part[i + H];
    const float keep = up ? part[i + H] : part[i];
    part[i] = keep + __shfl_xor_sync(FULL, send, H);
  }
}

__device__ __forceinline__ float dot8(const uint4& v, const float4& qa, const float4& qb, float a) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float2 f = __bfloat1622float2(h[0]);
  a = fmaf(f.x, qa.x, a);
  a = fmaf(f.y, qa.y, a);
  f = __bfloat1622float2(h[1]);
  a = fmaf(f.x, qa.z, a);
  a = fmaf(f.y, qa.w, a);
  f = __bfloat1622float2(h[2]);
  a = fmaf(f.x, qb.x, a);
  a = fmaf(f.y, qb.y, a);
  f = __bfloat1622float2(h[3]);
  a = fmaf(f.x, qb.z, a);
  return fmaf(f.y, qb.w, a);
}

// Lane hl of a half-warp sums columns 8 hl + 128 m of the 16 rows at `rows`
// against the query, eight rows' loads at a time; the butterfly (fold 8,
// 4, 2, 1) then leaves row hl's whole sum in lane hl.
__device__ __forceinline__ float group_dot(const unsigned char* rows, const float* qs, int D, int row_bytes,
                                           int hl, bool active) {
  float part[GROUP];
#pragma unroll
  for (int i = 0; i < GROUP; ++i) part[i] = 0.f;
  if (active) {
    for (int c = hl * 8; c < D; c += 128) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + c);
      const float4 qb = *reinterpret_cast<const float4*>(qs + c + 4);
#pragma unroll
      for (int i0 = 0; i0 < GROUP; i0 += 8) {
        uint4 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = *reinterpret_cast<const uint4*>(rows + (i0 + i) * row_bytes + c * 2);
#pragma unroll
        for (int i = 0; i < 8; ++i) part[i0 + i] = dot8(v[i], qa, qb, part[i0 + i]);
      }
    }
  }
  fold<8>(part, hl);
  fold<4>(part, hl);
  fold<2>(part, hl);
  fold<1>(part, hl);
  return part[0];
}

// ---------------------------------------------------------------------------
// selection: keys of orderable(d) (keys.cuh)

__device__ __forceinline__ key64 kmin(key64 a, key64 b) { return a < b ? a : b; }
__device__ __forceinline__ key64 kmax(key64 a, key64 b) { return a < b ? b : a; }

__host__ __device__ constexpr int log2_of(int p) { return p > 1 ? 1 + log2_of(p / 2) : 0; }

// Bitonic sort, ascending, of the block's P = KPT * THREADS keys; thread
// tid holds elements i * THREADS + tid.  Stage (s, j): element e against
// e ^ j, the lower of the two keeps the smaller key where e & s == 0 and
// the larger elsewhere.  `xbuf` holds 2 * P keys; the exchange stages
// alternate its halves, so one block barrier each suffices.
template <int KPT>
__device__ __forceinline__ void sort_keys(key64 (&k)[KPT], key64* xbuf, int tid) {
  constexpr int P = KPT * THREADS, LOG_P = log2_of(P);
  int half = 0;
#pragma unroll
  for (int ls = 1; ls <= LOG_P; ++ls) {
    const int s = 1 << ls;
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j >= THREADS) {  // a thread's own keys
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const int pi = i ^ (j / THREADS);
          if (pi > i) {
            const bool up = ((i * THREADS) & s) == 0;
            const key64 lo = kmin(k[i], k[pi]), hi = kmax(k[i], k[pi]);
            k[i] = up ? lo : hi;
            k[pi] = up ? hi : lo;
          }
        }
        continue;
      }
      const bool lower = (tid & j) == 0;
      if (j >= 32) {  // another warp: through shared memory
        key64* buf = xbuf + half * P;
        half ^= 1;
#pragma unroll
        for (int i = 0; i < KPT; ++i) buf[i * THREADS + tid] = k[i];
        __syncthreads();
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const key64 o = buf[i * THREADS + (tid ^ j)];
          const bool up = ((i * THREADS + tid) & s) == 0;
          k[i] = lower == up ? kmin(k[i], o) : kmax(k[i], o);
        }
      } else {  // this warp: a 64-bit shuffle
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const key64 o = __shfl_xor_sync(FULL, k[i], j);
          const bool up = ((i * THREADS + tid) & s) == 0;
          k[i] = lower == up ? kmin(k[i], o) : kmax(k[i], o);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------

template <int KPT>
__global__ void __launch_bounds__(THREADS, KPT <= 2 ? 6 : 2)
packed_score_kernel(const __nv_bfloat16* __restrict__ packed,  // (N+1, RS, D)
                    const float* __restrict__ pnorms,          // (N+1, Rt)
                    const int* __restrict__ pids,              // (N+1, Rt)
                    const int* __restrict__ sel,               // (B, E)
                    const float* __restrict__ q,               // (B, D)
                    float* __restrict__ out_d,                 // (B, E * K)
                    int* __restrict__ out_i,                   // (B, E * K)
                    int E, int D, int RS, int Rt, int topt, int sentinel) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan plan = make_plan(D, RS, Rt);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stage = smem + HEADER;
  float* qs = reinterpret_cast<float*>(smem + plan.smem - ((4 * D + 8 * Rt + 15) & ~15));
  float* sn = qs + D;                            // [Rt] norms, then distances
  int* si = reinterpret_cast<int*>(sn + Rt);     // [Rt] ids

  const int p = blockIdx.x;  // pair index b * E + e
  const int b = p / E;
  const int tid = threadIdx.x;
  const int node = sel[p];
  const bool real = node != sentinel;
  const bool aux_bulk = real && Rt % 4 == 0;
  const size_t arow = (size_t)node * Rt;
  const int row_bytes = 2 * D;
  const unsigned char* block = reinterpret_cast<const unsigned char*>(packed) + (size_t)node * RS * row_bytes;

  // ---- the copies: the block's first chunks and the aux rows ----
  if (tid == 0) {
    for (int s = 0; s < plan.nslot; ++s) barrier_init(&bars[s]);
    fence_barrier_init();
    if (real) {
      for (int c = 0; c < plan.nslot; ++c) {
        const int rows = min(plan.cr, RS - c * plan.cr);
        expect_bytes(&bars[c], rows * row_bytes + (c == 0 && aux_bulk ? 8 * Rt : 0));
        if (c == 0 && aux_bulk) {
          bulk_copy(sn, pnorms + arow, 4 * Rt, &bars[0]);
          bulk_copy(si, pids + arow, 4 * Rt, &bars[0]);
        }
        bulk_copy(stage + c * plan.slot, block + (size_t)c * plan.cr * row_bytes, rows * row_bytes, &bars[c]);
      }
    }
  }
  for (int i = tid; i < D; i += THREADS)
    qs[i] = __bfloat162float(__float2bfloat16_rn(q[(size_t)b * D + i]));
  if (!aux_bulk)
    for (int r = tid; r < Rt; r += THREADS) {
      sn[r] = pnorms[arow + r];
      si[r] = pids[arow + r];
    }
  __syncthreads();

  // ---- scoring, chunk by chunk ----
  const int K = topt ? topt : Rt;
  const size_t o = (size_t)p * K;
  const int warp = tid >> 5, hl = tid & 15;
  bool ok = true;
  if (real) {
    for (int c = 0; c < plan.nc; ++c) {
      const int slot = c % plan.nslot;
      ok = __syncthreads_and(barrier_wait(&bars[slot], (c / plan.nslot) & 1));
      if (!ok) break;
      const int r0 = c * plan.cr, groups = min(plan.cr, RS - r0) / GROUP;
      const unsigned char* st = stage + slot * plan.slot;
      for (int g0 = 2 * warp; g0 < groups; g0 += 2 * WARPS) {  // warp-uniform: the butterfly needs both halves
        const int g = g0 + ((tid >> 4) & 1);
        const bool active = g < groups;
        const float dot = group_dot(st + (size_t)g * GROUP * row_bytes, qs, D, row_bytes, hl, active);
        if (active) sn[r0 + g * GROUP + hl] -= 2.f * dot;
      }
      __syncthreads();  // the slot is free again
      if (tid == 0 && c + plan.nslot < plan.nc) {
        const int cn = c + plan.nslot, rows = min(plan.cr, RS - cn * plan.cr);
        fence_proxy_async();
        expect_bytes(&bars[slot], rows * row_bytes);
        bulk_copy(stage + slot * plan.slot, block + (size_t)cn * plan.cr * row_bytes, rows * row_bytes, &bars[slot]);
      }
    }
  }
  if (!ok) {
    for (int r = tid; r < K; r += THREADS) {
      out_d[o + r] = __int_as_float(0x7fc00000);
      out_i[o + r] = sentinel;
    }
    return;
  }

  if (topt == 0) {
    for (int r = tid; r < Rt; r += THREADS) {
      out_d[o + r] = sn[r];
      out_i[o + r] = si[r];
    }
    return;
  }

  // ---- selection: sort the (d, lane) keys, keep the first t ----
  key64 k[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int e = i * THREADS + tid;
    k[i] = e < Rt ? (key64)orderable(sn[e]) << 32 | (uint32_t)e : KEY_PAD;
  }
  sort_keys<KPT>(k, reinterpret_cast<key64*>(stage), tid);
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int e = i * THREADS + tid;
    if (e < topt) {
      const float d = from_orderable((uint32_t)(k[i] >> 32));
      out_d[o + e] = d;
      out_i[o + e] = si[d == INFINITY ? 0 : (int)(uint32_t)k[i]];
    }
  }
}

using Kernel = void (*)(const __nv_bfloat16*, const float*, const int*, const int*, const float*, float*, int*,
                        int, int, int, int, int, int);
const Kernel KERNELS[] = {packed_score_kernel<1>, packed_score_kernel<2>, packed_score_kernel<4>,
                          packed_score_kernel<8>, packed_score_kernel<16>};
constexpr int N_KERNELS = sizeof(KERNELS) / sizeof(KERNELS[0]);

// The dynamic shared memory each instance was allowed so far, per device:
// cudaFuncSetAttribute runs only when a launch needs more.
constexpr int MAX_DEVICES = 64;
int smem_allowed[MAX_DEVICES][N_KERNELS];

}  // namespace

extern "C" {

// Dynamic shared memory of one block at these widths.
int expann_packed_score_smem_bytes(int D, int RS, int Rt) { return make_plan(D, RS, Rt).smem; }

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller guarantees: every sel entry in [0, sentinel], rows 16-byte aligned,
// and expann_packed_score_smem_bytes(D, RS, Rt) within the card's limit.
int expann_packed_score_bf16(const void* packed, const void* pnorms, const void* pids,
                             const void* sel, const void* q, void* out_d, void* out_i, int B,
                             int E, int D, int RS, int Rt, int topt, int sentinel,
                             void* stream) {
  if (D < 8 || D % 8 != 0 || RS < GROUP || RS % GROUP != 0 || RS > Rt || Rt > KPT_MAX * THREADS ||
      topt < 0 || topt > Rt || E < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int smem = make_plan(D, RS, Rt).smem;
  const int ki = log2_of(keys_per_thread(Rt));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int* allowed = dev < MAX_DEVICES ? &smem_allowed[dev][ki] : nullptr;
  if (!allowed || smem > *allowed) {
    err = cudaFuncSetAttribute(KERNELS[ki], cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (allowed) *allowed = smem;
  }
  KERNELS[ki]<<<B * E, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)packed, (const float*)pnorms, (const int*)pids, (const int*)sel,
      (const float*)q, (float*)out_d, (int*)out_i, E, D, RS, Rt, topt, sentinel);
  return (int)cudaGetLastError();
}

}  // extern "C"
