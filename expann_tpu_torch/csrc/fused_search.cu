// Fused bottom-layer beam search over the packed neighbour layout, bf16
// blocks (`fused_search_kernel`, K1) or centered s8 code blocks
// (`fused_search_s8_kernel`, K1-s8), or over the bf16 corpus rows read by
// neighbour id (`fused_search_rows_kernel`, K1-rows).
//
// Replaces expann_tpu/ops/pallas_fused.py:_fused_kernel (launcher
// `fused_search` :665, call :717), its "topt" merge only, and its s8 branch
// (:101, :258-262).  K1-rows replaces no TPU kernel: it serves an index
// whose packed blocks (N+1 x RS x D) do not fit the card, such as 1M rows
// of 960 dims (201 GB of bf16 blocks against 2 GB of rows), where the JAX
// package falls back to its gather beam.
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
//   * per selected node in order: take its best TOPT by (d, row), skip
//     those whose id is already in the beam (checked against the beam as
//     it stands when that node's turn starts), and offer the others in
//     ascending order: each replaces the live worst (d, lane) if strictly
//     smaller.
// ncomp counts RS per selected (non-sentinel) node, padding rows included;
// K1-rows counts the non-sentinel rows it copied and scored.  K1-rows
// scores the same rows as K1 in the same order, so over the same graph and
// query both return the same beams, distances and iteration counts.
// Unlike the TPU kernel, distances and lanes are kept as separate
// (d, lane) pairs (no low-mantissa lane keys), the expanded flag is its own
// byte (not ~id), and termination is per query (a done query in a TPU
// tile is inert, so the results are the same).
//
// What bounds it on this card.  Counted once per byte, the traversal's
// inputs (the 1.89 GB bf16 layout at the canonical 56k config, 0.98 GB in
// s8) take ~0.6 ms (~0.3 ms) at 3.35 TB/s; but each block is read once
// per query that expands it, ~35 times a 16384-query call, and the 50 MB
// L2 holds 3-5% of the layout, so the work is a random gather of 33.8 KB
// (s8 16.9 KB) items from HBM, one per expansion, at a data-dependent
// address that the previous iteration's merge decides.  The gather rate
// sets the pace, and that rate is the bytes in flight per SM over the
// memory latency: the design keeps as many queries resident as it can,
// each with a copy in flight for as much of its time as it can.
//
// Design: one query a block of 64 threads (two warps), 16 blocks an SM.
//  * Copy.  As soon as selection names the iteration's nodes, one thread
//    starts bulk asynchronous copies (`cp.async.bulk`, completed on an
//    mbarrier with complete_tx bytes) of their blocks in chunks of CR rows
//    through a ring of NSLOT slots (one 8 KB slot, 32 bf16 or 64 s8 rows a
//    chunk, unless the batch is small enough for a deeper ring to keep it
//    all resident: choose_plan), and in the first chunk's wave every
//    selected node's norm and id rows (R_tile x 4 B each).  The scoring warps read the
//    block from shared memory: no row is staged through registers and no
//    norm or id load depends on a dot.  A slot is refilled with the
//    iteration's next chunk as soon as it has been scored.  A wait that
//    lasts WAIT_TIMEOUT_NS traps: the launch fails (the caller's next
//    synchronizing call raises) instead of hanging the card or returning a
//    beam while copies are still in flight.
//  * Score.  Both warps: a group of LPR lanes (16 for bf16, 8 for s8: one
//    16-byte load a lane covers a 128-element row either way, a
//    quarter-warp reads 128 contiguous bytes, no bank conflict) owns a row,
//    four (s8: two) rows in flight a group, then folds its LPR partial dots
//    by an xor butterfly; |q|^2 is summed in one fixed order (as 128 lanes
//    would) whatever the block size, so no distance depends on it.
//  * Merge (warp 0), a node as soon as its last chunk is scored, while the
//    next node's chunks are in flight and the other warp waits for them.
//    Every reduction is a (distance, index) key reduced by two `redux.sync`
//    instructions (min or max of the distance's orderable bits, then of the
//    index among the lanes that hold it), not a chain of shuffles.  Only
//    rows below the beam's live worst at selection can enter it, so a
//    node's top-TOPT is drawn from those alone, best first; each is checked
//    against a snapshot of the beam's ids taken at the node's turn and
//    offered to the live worst at once; the first refused ends the turn.
//  * Select (warp 0): the live worst and E argmins, the same reductions.
//  * K1-rows: the copy stage alone differs (a template policy: K1 and K1-s8
//    compile as before).  Selection first copies the selected nodes' norm
//    and id rows onto a barrier of their own, and the copying thread waits
//    for them; then every chunk is one bulk copy a non-sentinel neighbour
//    row, `rows + id * D` (2 KB at D = 1024), into the chunk's slot, armed
//    for the rows actually copied.  A sentinel slot is not copied and
//    scores +inf, as its +inf norm makes it score in K1.  The id row's
//    latency is paid once an iteration; the other resident queries' copies
//    cover it.  At D = 1024 an 8 KB slot holds 4 rows, the f32 query takes
//    4 KB, and ~18 KB of shared memory leaves ~11 queries an SM.
//  * Occupancy.  13.5 KB of shared memory (13.2 KB in s8) and at most 64
//    registers a thread (`__launch_bounds__(64, 16)`, no spills) give 16
//    resident queries an SM, 2112 on the card: while one merges and
//    selects, the others' copies are in flight.  Larger rings cut that
//    count (two 32 KB slots: 3 an SM) and were slower on an H100 at 16384
//    canonical queries; a batch small enough for a deeper ring to keep all
//    of it resident takes one (choose_plan).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "keys.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int WARPS = THREADS / 32;
constexpr int QN_LANES = 128;        // |q|^2 is summed as 128 lanes would, whatever THREADS
constexpr int MIN_BLOCKS = 16;       // resident blocks an SM: at most 64 registers a thread
constexpr int ROWS_MIN_BLOCKS = 12;  // K1-rows: shared memory holds ~11 an SM at D = 1024 anyway
constexpr int DEFAULT_SLOT = 8192;   // the default ring: one 8 KB slot (32 bf16 or 64 s8 rows)
constexpr int HEADER = 64;           // the slots' mbarriers (K1-rows: and the id rows'), then the stage region
constexpr int MAX_SLOTS = HEADER / 8;
constexpr int MAX_RS = 256;          // rows a block: 8 per lane of warp 0
constexpr int SMEM_LIMIT = 232448;   // shared memory a block may use (227 KB)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;
constexpr float FINTH = 1.0e38f;  // "finite": real distances are far below
constexpr unsigned long long WAIT_TIMEOUT_NS = 2000000000ull;  // 2 s

// ---------------------------------------------------------------------------
// bulk copies and mbarriers (the pattern of packed_score.cu and probes.cu)

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

// order this thread's earlier shared-memory accesses (and those made
// visible to it by a barrier) before a bulk copy that overwrites them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One thread: arm `bar` for `bytes` in all, then start each copy on it.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// One thread: arrive on `bar` with no bytes to wait for (a chunk of
// sentinel rows alone: its phase completes at once).
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// `src`, `dst` and `bytes` are multiples of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed; trap
// after WAIT_TIMEOUT_NS.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  const uint64_t t0 = global_ns();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (global_ns() - t0 > WAIT_TIMEOUT_NS) __trap();
  }
}

// ---------------------------------------------------------------------------
// keys: orderable(d) and from_orderable (keys.cuh).  NONE is above every
// real key.

// The warp's smallest key (h, i) by h, then i: h and i of it in every lane.
__device__ __forceinline__ void warp_argmin(uint32_t h, uint32_t i, uint32_t& mh, uint32_t& mi) {
  mh = __reduce_min_sync(FULL, h);
  mi = __reduce_min_sync(FULL, h == mh ? i : NONE);
}

// The warp's largest key (h, i) by h, then i.
__device__ __forceinline__ void warp_argmax(uint32_t h, uint32_t i, uint32_t& mh, uint32_t& mi) {
  mh = __reduce_max_sync(FULL, h);
  mi = __reduce_max_sync(FULL, h == mh ? i : 0u);
}

// The live worst (d, lane) of the beam: (orderable(d), lane) in every lane.
__device__ __forceinline__ void live_worst(const float* bd, int ef, int lane, uint32_t& wh, uint32_t& wl) {
  uint32_t h = 0u, l = 0u;  // below every real key: orderable(d) >= 0x80000000 for d >= 0
  for (int j = lane; j < ef; j += 32) {
    const uint32_t k = orderable(bd[j]);
    if (k >= h) {  // j ascends: ties keep the larger lane
      h = k;
      l = (uint32_t)j;
    }
  }
  warp_argmax(h, l, wh, wl);
}

// ---------------------------------------------------------------------------
// block element types: the query as the scorer holds it, and the partial
// dot of one 16-byte load against it

template <typename T>
struct Blk;

template <>
struct Blk<__nv_bfloat16> {
  static constexpr int ELT = 2;
  static constexpr int PER16 = 8;  // elements per 16-byte load
  static constexpr int LPR = 16;   // lanes per 128-element row
  static constexpr int QBYTES = 4; // the query in shared memory: f32
  static constexpr int UNROLL = 4; // rows in flight per lane group while scoring
  using Acc = float;
  struct Frag {
    float4 a, b;
  };
  // qs[i]: the query rounded to bf16, as f32
  __device__ __forceinline__ static void stage(unsigned char* qs, int i, float v) {
    reinterpret_cast<float*>(qs)[i] = __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static Frag frag(const unsigned char* qs, int c) {
    const float4* p = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(qs) + c);
    return Frag{p[0], p[1]};
  }
  __device__ __forceinline__ static float dot(const uint4& v, const Frag& f, float acc) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    float2 x = __bfloat1622float2(h[0]);
    acc = fmaf(x.x, f.a.x, acc);
    acc = fmaf(x.y, f.a.y, acc);
    x = __bfloat1622float2(h[1]);
    acc = fmaf(x.x, f.a.z, acc);
    acc = fmaf(x.y, f.a.w, acc);
    x = __bfloat1622float2(h[2]);
    acc = fmaf(x.x, f.b.x, acc);
    acc = fmaf(x.y, f.b.y, acc);
    x = __bfloat1622float2(h[3]);
    acc = fmaf(x.x, f.b.z, acc);
    return fmaf(x.y, f.b.w, acc);
  }
};

template <>
struct Blk<int8_t> {
  static constexpr int ELT = 1;
  static constexpr int PER16 = 16;
  static constexpr int LPR = 8;
  static constexpr int QBYTES = 1;  // the query's s8 codes
  static constexpr int UNROLL = 2;  // 4 was 3% slower at 16384 queries (H100)
  using Acc = int;                  // exact: |sums| < 2^24
  struct Frag {
    int4 w;
  };
  __device__ __forceinline__ static void stage(unsigned char* qs, int i, float v) {
    reinterpret_cast<int8_t*>(qs)[i] = (int8_t)(int)v;
  }
  __device__ __forceinline__ static Frag frag(const unsigned char* qs, int c) {
    return Frag{*reinterpret_cast<const int4*>(qs + c)};
  }
  __device__ __forceinline__ static int dot(const uint4& v, const Frag& f, int acc) {
    acc = __dp4a((int)v.x, f.w.x, acc);
    acc = __dp4a((int)v.y, f.w.y, acc);
    acc = __dp4a((int)v.z, f.w.z, acc);
    return __dp4a((int)v.w, f.w.w, acc);
  }
};

// ---------------------------------------------------------------------------
// the shared-memory plan, the same on the host and the card

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

struct Plan {
  int cr;     // rows a chunk
  int nc;     // chunks a block
  int nslot;  // ring slots
  int slot;   // bytes a slot (cr rows)
  // byte offsets of the regions in dynamic shared memory
  int aux_n, aux_i, sd, qs, bd, bi, bs, bx, ctl, smem;
};

__host__ __device__ inline Plan make_plan(int elt, int qbytes, int D, int RS, int Rt, int EF, int E, int nslot,
                                          int slot) {
  Plan p;
  const int rb = D * elt;
  p.cr = slot / rb;
  if (p.cr > RS) p.cr = RS;
  if (p.cr < 1) p.cr = 1;
  p.nc = (RS + p.cr - 1) / p.cr;
  p.nslot = nslot < E * p.nc ? nslot : E * p.nc;  // never more slots than an iteration's chunks
  if (p.nslot < 1) p.nslot = 1;
  p.slot = p.cr * rb;
  int o = HEADER + p.nslot * p.slot;
  p.aux_n = o;
  o += align16(E * Rt * 4);
  p.aux_i = o;
  o += align16(E * Rt * 4);
  p.sd = o;
  o += align16(E * RS * 4);
  p.qs = o;
  o += align16(D * qbytes);
  p.bd = o;
  o += align16(EF * 4);
  p.bi = o;
  o += align16(EF * 4);
  p.bs = o;
  o += align16(EF * 4);
  p.bx = o;
  o += align16(EF);
  p.ctl = o;
  o += align16(4 * (2 * E + 2 + QN_LANES / 32));
  p.smem = o;
  return p;
}

// ---------------------------------------------------------------------------

// One selected node's turn (warp 0): its rows `de` (distances) and `ie`
// (ids) against the beam.  Only rows below `wd`, the live worst at
// selection, can enter (the worst never rises within an iteration), so the
// node's top-TOPT by (d, row) is drawn from those alone, best first; each
// is skipped if its id was in the beam when the turn started (the snapshot
// `bs`), else offered to the live worst; the first refused ends the turn
// (later rows are no smaller, the worst is no larger).
__device__ __forceinline__ void merge_node(const float* de, const int* ie, float* bd, int* bi, int* bs,
                                           unsigned char* bx, float wd, int RS, int EF, int ef, int topt,
                                           int sentinel, int lane) {
  unsigned pm = 0u;
#pragma unroll
  for (int i = 0; i < MAX_RS / 32; ++i) {
    const int j = lane + 32 * i;
    if (j < RS && de[j] < wd) pm |= 1u << i;
  }
  if (!__any_sync(FULL, pm != 0u)) return;
  for (int j = lane; j < EF; j += 32) bs[j] = bi[j];
  __syncwarp();
  for (int t = 0; t < topt; ++t) {
    uint32_t h = NONE, l = NONE;
#pragma unroll
    for (int i = 0; i < MAX_RS / 32; ++i) {
      if (!((pm >> i) & 1u)) continue;
      const uint32_t k = orderable(de[lane + 32 * i]);
      if (k < h) {  // rows ascend with i: ties keep the smaller row
        h = k;
        l = (uint32_t)(lane + 32 * i);
      }
    }
    uint32_t ch, cr;
    warp_argmin(h, l, ch, cr);
    if (ch == NONE) break;  // no row left below the worst
    if ((int)(cr & 31) == lane) pm &= ~(1u << (cr >> 5));
    const float cd = de[cr];
    const int cid = ie[cr];
    uint32_t wh, wl;
    live_worst(bd, ef, lane, wh, wl);
    bool hit = false;
    if (cid != sentinel)
      for (int j = lane; j < EF; j += 32) hit |= bs[j] == cid;
    if (__any_sync(FULL, hit)) continue;
    if (!(cd < from_orderable(wh))) break;
    if ((int)(wl & 31) == lane) {
      bd[wl] = cd;
      bi[wl] = cid;
      bx[wl] = 0;
    }
    __syncwarp();
  }
  __syncwarp();
}

// ROWS: `src` is the corpus (N+1, D) and a node's neighbours are copied
// row by row by id (K1-rows); else `src` is the packed blocks (N+1, RS, D).
// `stall` (K1-rows): bytes the id rows' barrier expects beyond its copies,
// 0 in service; more makes that wait time out (the timeout's test).
template <typename T, bool ROWS>
__device__ __forceinline__ void fused_body(const T* __restrict__ src,         // (N+1, RS, D) or (N+1, D)
                                           const float* __restrict__ pnorms,  // (N+1, Rt)
                                           const int* __restrict__ pids,      // (N+1, Rt)
                                           const float* __restrict__ q,       // (B, D)
                                           const float* __restrict__ bd0,     // (B, EF)
                                           const int* __restrict__ bi0,       // (B, EF)
                                           int* __restrict__ obi,
                                           float* __restrict__ obd,  // (B, EF)
                                           int* __restrict__ oncomp,
                                           int* __restrict__ oiters,  // (B,)
                                           int D, int RS, int Rt, int EF, int ef, int max_iters, int E,
                                           int topt, int sentinel, int nslot_req, int slot_req, int stall) {
  using B_ = Blk<T>;
  using Acc = typename B_::Acc;
  constexpr int PER16 = B_::PER16, LPR = B_::LPR, GROUPS = THREADS / LPR, UNROLL = B_::UNROLL;
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan P = make_plan(B_::ELT, B_::QBYTES, D, RS, Rt, EF, E, nslot_req, slot_req);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stage = smem + HEADER;
  float* an = reinterpret_cast<float*>(smem + P.aux_n);  // [E][Rt] norms of the selected nodes' rows
  int* ai = reinterpret_cast<int*>(smem + P.aux_i);      // [E][Rt] their ids
  float* sd = reinterpret_cast<float*>(smem + P.sd);     // [E][RS] scored distances
  unsigned char* qs = smem + P.qs;                       // [D] the query as the scorer reads it
  float* bd = reinterpret_cast<float*>(smem + P.bd);     // [EF] beam distances
  int* bi = reinterpret_cast<int*>(smem + P.bi);         // [EF] beam ids
  int* bs = reinterpret_cast<int*>(smem + P.bs);         // [EF] the ids at a node's turn
  unsigned char* bx = smem + P.bx;                       // [EF] expanded flags
  int* sel = reinterpret_cast<int*>(smem + P.ctl);       // [E] selected nodes
  int* rl = sel + E;                                     // [E] selections with a real node, in order
  int* ctl = rl + E;                                     // [2] stop flag, real selections
  float* red = reinterpret_cast<float*>(ctl + 2);        // [QN_LANES / 32] |q|^2 partials

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = tid / LPR, gl = tid % LPR;
  const int rb = D * B_::ELT;
  const unsigned aux_bytes = 8u * Rt;  // a node's norm and id rows

  uint64_t* abar = &bars[P.nslot];  // K1-rows: the selected nodes' norm and id rows
  if (tid == 0) {
    for (int s = 0; s < P.nslot + (ROWS ? 1 : 0); ++s) barrier_init(&bars[s]);
    fence_barrier_init();
  }
  for (int i = tid; i < D; i += THREADS) B_::stage(qs, i, q[(size_t)b * D + i]);
  // |q|^2 in one fixed order: lane v of QN_LANES sums elements v, v + QN_LANES, ...,
  // each 32 of them fold by a butterfly, then the folds add in order
  for (int vw = warp; vw < QN_LANES / 32; vw += WARPS) {
    float part = 0.f;
    for (int i = vw * 32 + lane; i < D; i += QN_LANES) {
      const float v = q[(size_t)b * D + i];
      part = fmaf(v, v, part);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
    if (lane == 0) red[vw] = part;
  }
  for (int j = tid; j < EF; j += THREADS) {
    bd[j] = fmaxf(bd0[(size_t)b * EF + j], 0.f);
    bi[j] = bi0[(size_t)b * EF + j];
    bx[j] = 0;
  }
  __syncthreads();
  float qn = 0.f;
#pragma unroll
  for (int w = 0; w < QN_LANES / 32; ++w) qn += red[w];
  // this lane's query fragment for the first 128 columns
  const bool has_frag = gl * PER16 < D;
  const typename B_::Frag qf = has_frag ? B_::frag(qs, gl * PER16) : typename B_::Frag{};

  // chunk k of an iteration: rows [c * cr, ...) of the (k / nc)-th real selection
  auto chunk_src = [&](int k, unsigned& bytes) -> const unsigned char* {
    const int c = k % P.nc;
    const int node = sel[rl[k / P.nc]];
    const int rows = min(P.cr, RS - c * P.cr);
    bytes = (unsigned)(rows * rb);
    return reinterpret_cast<const unsigned char*>(src) + ((size_t)node * RS + (size_t)c * P.cr) * rb;
  };
  // K1-rows, one thread: arm `bar` for chunk k's non-sentinel rows and copy
  // each by its id into the slot `dst`; returns the rows copied
  auto copy_rows = [&](int k, unsigned char* dst, uint64_t* bar) -> int {
    const int r0 = (k % P.nc) * P.cr;
    const int rows = min(P.cr, RS - r0);
    const int* ids = ai + rl[k / P.nc] * Rt + r0;
    int real = 0;
    for (int r = 0; r < rows; ++r) real += ids[r] != sentinel;
    if (real)
      expect_bytes(bar, (unsigned)(real * rb));
    else
      arrive(bar);
    for (int r = 0; r < rows; ++r)
      if (ids[r] != sentinel)
        bulk_copy(dst + r * rb, reinterpret_cast<const unsigned char*>(src) + (size_t)ids[r] * rb, rb, bar);
    return real;
  };

  unsigned kc = 0;  // chunks consumed so far, over all iterations: slot kc % nslot, parity (kc / nslot) & 1
  unsigned ka = 0;  // K1-rows: id-row phases so far
  int it = 0, ncomp = 0;
  uint32_t wsel = NONE;  // warp 0: orderable bits of the live worst at this iteration's selection
  while (it < max_iters) {
    // ---- selection (warp 0), and the copies it names ----
    if (warp == 0) {
      uint32_t wl;
      live_worst(bd, ef, lane, wsel, wl);
      const float wd = from_orderable(wsel);
      bool stop = false;
      int nreal = 0;
      for (int e = 0; e < E; ++e) {
        uint32_t h = NONE, l = NONE;
        for (int j = lane; j < ef; j += 32) {
          if (bx[j]) continue;
          const uint32_t k = orderable(bd[j]);
          if (k < h) {  // j ascends: ties keep the smaller lane
            h = k;
            l = (uint32_t)j;
          }
        }
        uint32_t mh, ml;
        warp_argmin(h, l, mh, ml);
        const bool fin = mh != NONE && from_orderable(mh) < FINTH;
        if (e == 0) stop = !fin || from_orderable(mh) > wd;
        const int s = (fin && !stop) ? bi[ml] : sentinel;
        if (fin && (int)(ml & 31) == lane) bx[ml] = 1;
        if (lane == 0) {
          sel[e] = s;
          if (s != sentinel) rl[nreal] = e;
        }
        nreal += s != sentinel;
        __syncwarp();
      }
      if (lane == 0) {
        ctl[0] = stop;
        ctl[1] = nreal;
        if constexpr (ROWS) {
          if (!stop && nreal > 0) {
            // the selected nodes' aux rows on their own barrier; once they
            // land, the iteration's first chunks by the ids they hold
            fence_proxy_async();
            expect_bytes(abar, aux_bytes * nreal + (unsigned)stall);
            for (int r = 0; r < nreal; ++r) {
              const int e = rl[r];
              const size_t arow = (size_t)sel[e] * Rt;
              bulk_copy(an + e * Rt, pnorms + arow, 4 * Rt, abar);
              bulk_copy(ai + e * Rt, pids + arow, 4 * Rt, abar);
            }
            barrier_wait(abar, ka & 1);
            for (int k = 0; k < P.nslot && k < nreal * P.nc; ++k) {
              const int slot = (kc + k) % P.nslot;
              ncomp += copy_rows(k, stage + slot * P.slot, &bars[slot]);
            }
          }
        } else if (!stop) {
          ncomp += nreal * RS;
          // the iteration's first chunks, and every selected node's aux rows
          // on the first chunk's barrier; sel / rl are this thread's own writes
          fence_proxy_async();
          const int nch = nreal * P.nc;
          for (int k = 0; k < P.nslot && k < nch; ++k) {
            uint64_t* bar = &bars[(kc + k) % P.nslot];
            unsigned bytes;
            const unsigned char* from = chunk_src(k, bytes);
            expect_bytes(bar, bytes + (k == 0 ? aux_bytes * nreal : 0u));
            if (k == 0)
              for (int r = 0; r < nreal; ++r) {
                const int e = rl[r];
                const size_t arow = (size_t)sel[e] * Rt;
                bulk_copy(an + e * Rt, pnorms + arow, 4 * Rt, bar);
                bulk_copy(ai + e * Rt, pids + arow, 4 * Rt, bar);
              }
            bulk_copy(stage + ((kc + k) % P.nslot) * P.slot, from, bytes, bar);
          }
        }
      }
    }
    __syncthreads();
    ++it;
    if (ctl[0]) break;
    const int nreal = ctl[1];
    if constexpr (ROWS) {
      if (nreal > 0) {  // every thread reads the aux rows: wait for them too
        barrier_wait(abar, ka & 1);
        ++ka;
      }
    }

    // ---- scoring (all warps), chunk by chunk from the ring ----
    const int nch = nreal * P.nc;  // the iteration's chunks
    for (int k = 0; k < nch; ++k, ++kc) {
      const int slot = kc % P.nslot;
      barrier_wait(&bars[slot], (kc / P.nslot) & 1);
      __syncthreads();
      const int e = rl[k / P.nc], r0 = (k % P.nc) * P.cr;
      const int rows = min(P.cr, RS - r0);
      const unsigned char* st = stage + slot * P.slot;
      const float* ne = an + e * Rt + r0;
      float* de = sd + e * RS + r0;
      for (int base = 0; base < rows; base += GROUPS * UNROLL) {  // the same trip count in every lane
        Acc acc[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          acc[u] = 0;
          const int r = base + grp + u * GROUPS;
          // K1-rows: a sentinel row was not copied; it scores +inf by its norm, as in K1
          if (r < rows && has_frag && (!ROWS || ai[e * Rt + r0 + r] != sentinel)) {
            const unsigned char* row = st + (size_t)r * rb;
            acc[u] = B_::dot(*reinterpret_cast<const uint4*>(row + gl * 16), qf, acc[u]);
            for (int c = gl * PER16 + LPR * PER16; c < D; c += LPR * PER16)
              acc[u] = B_::dot(*reinterpret_cast<const uint4*>(row + c * B_::ELT), B_::frag(qs, c), acc[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
          for (int off = LPR / 2; off; off >>= 1) acc[u] += __shfl_xor_sync(FULL, acc[u], off);
          const int r = base + grp + u * GROUPS;
          if (gl == 0 && r < rows) de[r] = fmaxf((ne[r] + qn) - 2.f * (float)acc[u], 0.f);
        }
      }
      __syncthreads();  // the slot is free again, and node e's rows so far are scored
      if (tid == 0 && k + P.nslot < nch) {
        uint64_t* bar = &bars[slot];
        fence_proxy_async();
        if constexpr (ROWS) {
          ncomp += copy_rows(k + P.nslot, stage + slot * P.slot, bar);
        } else {
          unsigned bytes;
          const unsigned char* from = chunk_src(k + P.nslot, bytes);
          expect_bytes(bar, bytes);
          bulk_copy(stage + slot * P.slot, from, bytes, bar);
        }
      }
      // node e's last chunk: warp 0 merges it while the later chunks' copies
      // are in flight; the other warps go on to the next chunk's wait
      if (warp == 0 && (k + 1) % P.nc == 0)
        merge_node(sd + e * RS, ai + e * Rt, bd, bi, bs, bx, from_orderable(wsel), RS, EF, ef, topt, sentinel,
                   lane);
    }
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

// One named kernel per block type (the build report lists each by name).
#define FUSED_KERNEL(NAME, T)                                                                        \
  __global__ void __launch_bounds__(THREADS, MIN_BLOCKS)                                             \
      NAME(const T* __restrict__ packed, const float* __restrict__ pnorms,                           \
           const int* __restrict__ pids, const float* __restrict__ q, const float* __restrict__ bd0, \
           const int* __restrict__ bi0, int* __restrict__ obi,                                       \
           float* __restrict__ obd, int* __restrict__ oncomp, int* __restrict__ oiters, int D, int RS, \
           int Rt, int EF, int ef, int max_iters, int E, int topt, int sentinel, int nslot, int slot) { \
    fused_body<T, false>(packed, pnorms, pids, q, bd0, bi0, obi, obd, oncomp, oiters, D, RS, Rt, EF, ef, \
                         max_iters, E, topt, sentinel, nslot, slot, 0);                              \
  }
FUSED_KERNEL(fused_search_kernel, __nv_bfloat16)
FUSED_KERNEL(fused_search_s8_kernel, int8_t)
#undef FUSED_KERNEL

// K1-rows: `rows` is the bf16 corpus (N+1, D), RS the id slots scored a node.
__global__ void __launch_bounds__(THREADS, ROWS_MIN_BLOCKS)
    fused_search_rows_kernel(const __nv_bfloat16* __restrict__ rows, const float* __restrict__ pnorms,
                             const int* __restrict__ pids, const float* __restrict__ q,
                             const float* __restrict__ bd0, const int* __restrict__ bi0, int* __restrict__ obi,
                             float* __restrict__ obd, int* __restrict__ oncomp, int* __restrict__ oiters, int D,
                             int RS, int Rt, int EF, int ef, int max_iters, int E, int topt, int sentinel,
                             int nslot, int slot, int stall) {
  fused_body<__nv_bfloat16, true>(rows, pnorms, pids, q, bd0, bi0, obi, obd, oncomp, oiters, D, RS, Rt, EF, ef,
                                  max_iters, E, topt, sentinel, nslot, slot, stall);
}

// The three kernels: index 0 K1, 1 K1-s8, 2 K1-rows (its element type and
// copy policy in `Kind`).
constexpr int KINDS = 3;
template <int KI>
struct Kind;
template <>
struct Kind<0> {
  using T = __nv_bfloat16;
  static constexpr bool ROWS = false;
  static auto kernel() { return fused_search_kernel; }
};
template <>
struct Kind<1> {
  using T = int8_t;
  static constexpr bool ROWS = false;
  static auto kernel() { return fused_search_s8_kernel; }
};
template <>
struct Kind<2> {
  using T = __nv_bfloat16;
  static constexpr bool ROWS = true;
  static auto kernel() { return fused_search_rows_kernel; }
};

template <typename T>
Plan plan_for(int D, int RS, int Rt, int EF, int E, int nslot, int slot) {
  return make_plan(Blk<T>::ELT, Blk<T>::QBYTES, D, RS, Rt, EF, E, nslot, slot);
}

constexpr int MAX_DEVICES = 64;
constexpr int MAX_RESIDENT = 32;  // blocks an SM (H100)

// What a device offers one instance, read once: its SM count, and for n
// resident blocks an SM the dynamic shared memory each may take.
struct Occupancy {
  bool ready;
  int sms;
  int nmax;                     // resident blocks an SM with no dynamic shared memory
  size_t avail[MAX_RESIDENT + 1];  // avail[n]: the most a block may take with n an SM
  // resident blocks an SM at `smem` bytes a block
  int resident(int smem) const {
    int n = nmax;
    while (n > 0 && avail[n] < (size_t)smem) --n;
    return n;
  }
};
Occupancy occupancy[MAX_DEVICES][KINDS];

// On the current device, once: let kernel KI take up to SMEM_LIMIT bytes
// of dynamic shared memory, and read its occupancy table.
template <int KI>
cudaError_t prepare(const Occupancy*& occ) {
  const auto kernel = Kind<KI>::kernel();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Occupancy& o = occupancy[dev][KI];
  occ = &o;
  if (o.ready) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.nmax, kernel, THREADS, 0);
  if (o.nmax > MAX_RESIDENT) o.nmax = MAX_RESIDENT;
  for (int n = 1; err == cudaSuccess && n <= o.nmax; ++n)
    err = cudaOccupancyAvailableDynamicSMemPerBlock(&o.avail[n], kernel, n, THREADS);
  if (err != cudaSuccess) return err;
  o.ready = true;
  return cudaSuccess;
}

// The ring of a launch of B queries: the first of (E slots of a whole
// block: the iteration's blocks all in flight), (two 16 KB slots) and (one
// 16 KB slot) that is deeper than the default and whose resident blocks an
// SM still hold the whole batch at once; a batch too large for any of them
// takes the default, one 8 KB slot, which keeps the most queries resident
// (16 an SM).  A small batch leaves resident slots empty, so a deeper ring
// a query is free there; a large one is paced by the bytes in flight an
// SM, which more resident queries raise.  No CUDA call: `occ` was read once.
// K1-rows keeps one barrier of the header for the id rows.
template <int KI>
Plan choose_plan(const Occupancy& occ, int B, int D, int RS, int Rt, int EF, int E) {
  using T = typename Kind<KI>::T;
  const int max_slots = MAX_SLOTS - (Kind<KI>::ROWS ? 1 : 0);
  const Plan p = plan_for<T>(D, RS, Rt, EF, E, 1, DEFAULT_SLOT);
  const int need = (B + occ.sms - 1) / occ.sms;
  const int rings[3][2] = {{E < max_slots ? E : max_slots, RS * D * Blk<T>::ELT}, {2, 16384}, {1, 16384}};
  for (const auto& r : rings) {
    const Plan c = plan_for<T>(D, RS, Rt, EF, E, r[0], r[1]);
    if (c.smem <= SMEM_LIMIT && c.nslot * c.slot > p.nslot * p.slot && occ.resident(c.smem) >= need) return c;
  }
  return p;
}

template <int KI>
int launch(const void* src, const void* pnorms, const void* pids, const void* q, const void* bd0,
           const void* bi0, void* obi, void* obd, void* oncomp, void* oiters, int B, int D, int RS, int Rt,
           int EF, int ef, int max_iters, int E, int topt, int sentinel, int stall, void* stream) {
  using T = typename Kind<KI>::T;
  if (D % (16 / Blk<T>::ELT) != 0 || D < 1 || RS < 1 || RS % 16 != 0 || RS > MAX_RS || RS > Rt || Rt % 4 != 0 ||
      ef < 1 || ef > EF || topt < 1 || topt > RS || E < 1 || stall < 0 || stall % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Occupancy* occ = nullptr;
  const cudaError_t err = prepare<KI>(occ);
  if (err != cudaSuccess) return (int)err;
  const Plan p = choose_plan<KI>(*occ, B, D, RS, Rt, EF, E);
  if (p.smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;  // even the default ring does not fit
  const auto kernel = Kind<KI>::kernel();
  if constexpr (Kind<KI>::ROWS)
    kernel<<<B, THREADS, p.smem, (cudaStream_t)stream>>>(
        (const T*)src, (const float*)pnorms, (const int*)pids, (const float*)q, (const float*)bd0,
        (const int*)bi0, (int*)obi, (float*)obd, (int*)oncomp, (int*)oiters, D, RS, Rt, EF, ef, max_iters, E,
        topt, sentinel, p.nslot, p.slot, stall);
  else
    kernel<<<B, THREADS, p.smem, (cudaStream_t)stream>>>(
        (const T*)src, (const float*)pnorms, (const int*)pids, (const float*)q, (const float*)bd0,
        (const int*)bi0, (int*)obi, (float*)obd, (int*)oncomp, (int*)oiters, D, RS, Rt, EF, ef, max_iters, E,
        topt, sentinel, p.nslot, p.slot);
  return (int)cudaGetLastError();
}

template <int KI>
int ring(int B, int D, int RS, int Rt, int EF, int E, int* nslot, int* slot, int* ctas) {
  const Occupancy* occ = nullptr;
  cudaError_t err = prepare<KI>(occ);
  if (err != cudaSuccess) return (int)err;
  const Plan p = choose_plan<KI>(*occ, B, D, RS, Rt, EF, E);
  *nslot = p.nslot;
  *slot = p.slot;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, Kind<KI>::kernel(), THREADS, p.smem);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at the default ring (kind: 0 K1,
// 1 K1-s8, 2 K1-rows, whose plan is K1's).
int expann_fused_search_smem_bytes(int kind, int D, int RS, int Rt, int EF, int E) {
  return kind == 1 ? plan_for<int8_t>(D, RS, Rt, EF, E, 1, DEFAULT_SLOT).smem
                   : plan_for<__nv_bfloat16>(D, RS, Rt, EF, E, 1, DEFAULT_SLOT).smem;
}

// The ring a launch of B queries of kernel `kind` (as above) takes on the
// current device, into nslot / slot (bytes), and its resident blocks
// (queries) an SM, as cudaOccupancyMaxActiveBlocksPerMultiprocessor gives
// it, into ctas; returns a CUDA error code (0 on success).
int expann_fused_search_ring(int kind, int B, int D, int RS, int Rt, int EF, int E, int* nslot, int* slot,
                             int* ctas) {
  if (kind == 1) return ring<1>(B, D, RS, Rt, EF, E, nslot, slot, ctas);
  if (kind == 2) return ring<2>(B, D, RS, Rt, EF, E, nslot, slot, ctas);
  return ring<0>(B, D, RS, Rt, EF, E, nslot, slot, ctas);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller guarantees: D % 8 == 0, RS % 16 == 0, RS <= 256, RS <= Rt, Rt % 4 == 0,
// 1 <= ef <= EF, 1 <= topt <= RS, E >= 1, rows 16-byte aligned, every
// selected id in [0, sentinel].  The launcher chooses the ring from B
// (choose_plan).
int expann_fused_search_bf16(const void* packed, const void* pnorms, const void* pids, const void* q,
                             const void* bd0, const void* bi0, void* obi, void* obd,
                             void* oncomp, void* oiters, int B, int D, int RS, int Rt, int EF, int ef,
                             int max_iters, int E, int topt, int sentinel, void* stream) {
  return launch<0>(packed, pnorms, pids, q, bd0, bi0, obi, obd, oncomp, oiters, B, D, RS, Rt, EF, ef, max_iters,
                   E, topt, sentinel, 0, stream);
}

// K1-s8: int8 code blocks and a code-space query (integer-valued f32 in
// [-127, 127]); the same contract with D % 16 == 0.
int expann_fused_search_s8(const void* packed, const void* pnorms, const void* pids, const void* q,
                           const void* bd0, const void* bi0, void* obi, void* obd,
                           void* oncomp, void* oiters, int B, int D, int RS, int Rt, int EF, int ef,
                           int max_iters, int E, int topt, int sentinel, void* stream) {
  return launch<1>(packed, pnorms, pids, q, bd0, bi0, obi, obd, oncomp, oiters, B, D, RS, Rt, EF, ef, max_iters,
                   E, topt, sentinel, 0, stream);
}

// K1-rows: the bf16 corpus `rows` (N+1, D) with the zero sentinel row N,
// and the layout's norm and id rows (N+1, Rt), of which each node's first
// RS slots are scored; K1's contract otherwise.  `stall` (a multiple of 16,
// 0 in service) is the test of the copy timeout: the id rows' barrier then
// expects that many bytes more than it receives, and its wait traps.
int expann_fused_search_rows_bf16(const void* rows, const void* pnorms, const void* pids, const void* q,
                                  const void* bd0, const void* bi0, void* obi, void* obd, void* oncomp,
                                  void* oiters, int B, int D, int RS, int Rt, int EF, int ef, int max_iters,
                                  int E, int topt, int sentinel, int stall, void* stream) {
  return launch<2>(rows, pnorms, pids, q, bd0, bi0, obi, obd, oncomp, oiters, B, D, RS, Rt, EF, ef, max_iters, E,
                   topt, sentinel, stall, stream);
}

}  // extern "C"
