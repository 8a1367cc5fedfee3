// Per-iteration block scorer over the packed bf16 neighbour layout.
//
// Replaces expann_tpu/ops/pallas_beam.py:_beam_score_kernel (launcher
// `packed_score` :180, call :234).
//
// What it computes, for every (query b, selected node e) pair: the node's
// packed block of RS neighbour rows scored against the query,
//   d[r] = norms[node, r] - 2 q.x_r    (q rounded to bf16, f32 sums,
//                                        no |q|^2 and no clamp),
// for the R_tile slots of the node's aux row (slots >= RS have a +inf
// norm and a zero dot, so they come out +inf), with ids[r] = ids[node, r].
// With topt = t > 0 only the node's t best by (d, lane) leave the kernel,
// ascending: t passes of (min d, lowest lane), each knocking its winner
// out to +inf; once the finite slots are used up every lane is +inf and
// lane 0 wins, as in the TPU kernel.  A sentinel node (all norms +inf)
// skips its block reads: its dots are never needed.
//
// What bounds it on this card: device-memory latency.  One pair reads one
// RS x D bf16 block (128 x 128 x 2 = 32 KB) and one aux row at a
// data-dependent address; a small batch (B <= 32, E = 2) launches at most
// 64 blocks, which cannot fill 132 SMs, so the call costs about one HBM
// round trip plus the launch.  At large B it is HBM-bandwidth bound.
//
// Design: one 128-thread block per pair (grid B * E).  The query row sits
// in shared memory, rounded to bf16 and kept as f32.  Each half-warp owns
// one packed row at a time and reads it with coalesced 16-byte loads (a
// warp covers two contiguous 256-byte rows), four rows in flight per
// half-warp, and reduces its 16 partial dots by shuffles, as
// fused_search.cu does.  The top-t passes run in warp 0 with shuffle
// argmins over (d, lane) pairs in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int HALF_WARPS = THREADS / 16;
constexpr int UNROLL = 4;  // packed rows in flight per half-warp
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool dl_less(float ad, int al, float bd, int bl) {
  return ad < bd || (ad == bd && al < bl);
}

__global__ void __launch_bounds__(THREADS)
packed_score_kernel(const __nv_bfloat16* __restrict__ packed,  // (N+1, RS, D)
                    const float* __restrict__ pnorms,          // (N+1, Rt)
                    const int* __restrict__ pids,              // (N+1, Rt)
                    const int* __restrict__ sel,               // (B, E)
                    const float* __restrict__ q,               // (B, D)
                    float* __restrict__ out_d,                 // (B, E * K)
                    int* __restrict__ out_i,                   // (B, E * K)
                    int E, int D, int RS, int Rt, int topt, int sentinel) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [D] query rounded to bf16
  float* sd = qs + D;                           // [Rt] slot distances

  const int p = blockIdx.x;  // pair index b * E + e
  const int b = p / E;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int hw = tid >> 4, hl = tid & 15;
  const int node = sel[p];
  const size_t arow = (size_t)node * Rt;

  for (int i = tid; i < D; i += THREADS)
    qs[i] = __bfloat162float(__float2bfloat16_rn(q[(size_t)b * D + i]));
  for (int r = RS + tid; r < Rt; r += THREADS) sd[r] = pnorms[arow + r];
  __syncthreads();

  // ---- scoring: one packed row per half-warp at a time ----
  const bool real = node != sentinel;
  for (int r0 = hw; r0 < RS; r0 += HALF_WARPS * UNROLL) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + HALF_WARPS * u;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (real && r < RS && hl * 8 < D)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(packed + ((size_t)node * RS + r) * D + hl * 8));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + HALF_WARPS * u;
      float acc = 0.f;
      if (real && r < RS) {
        for (int c = hl * 8; c < D; c += 128) {
          const uint4 v = (c == hl * 8)
                              ? raw[u]
                              : __ldg(reinterpret_cast<const uint4*>(
                                    packed + ((size_t)node * RS + r) * D + c));
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h2[j]);
            acc = fmaf(f.x, qs[c + 2 * j], acc);
            acc = fmaf(f.y, qs[c + 2 * j + 1], acc);
          }
        }
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
      if (hl == 0 && r < RS) sd[r] = pnorms[arow + r] - 2.f * acc;
    }
  }
  __syncthreads();

  if (topt == 0) {
    const size_t o = (size_t)p * Rt;
    for (int r = tid; r < Rt; r += THREADS) {
      out_d[o + r] = sd[r];
      out_i[o + r] = pids[arow + r];
    }
    return;
  }

  // ---- top-t: t passes of (min d, lowest lane) in warp 0 ----
  if (warp != 0) return;
  const size_t o = (size_t)p * topt;
  for (int t = 0; t < topt; ++t) {
    float vd = INFINITY;
    int vl = INT_MAX;
    for (int r = lane; r < Rt; r += 32)
      if (dl_less(sd[r], r, vd, vl)) {
        vd = sd[r];
        vl = r;
      }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, vd, off);
      const int ol = __shfl_xor_sync(FULL, vl, off);
      if (dl_less(od, ol, vd, vl)) {
        vd = od;
        vl = ol;
      }
    }
    __syncwarp();
    if (lane == 0) {
      out_d[o + t] = vd;
      out_i[o + t] = pids[arow + vl];
      sd[vl] = INFINITY;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

int expann_packed_score_smem_bytes(int D, int Rt) { return 4 * (D + Rt); }

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller guarantees: D % 8 == 0, RS % 16 == 0, RS <= Rt, 0 <= topt <= Rt,
// every sel entry in [0, sentinel], rows 16-byte aligned.
int expann_packed_score_bf16(const void* packed, const void* pnorms, const void* pids,
                             const void* sel, const void* q, void* out_d, void* out_i, int B,
                             int E, int D, int RS, int Rt, int topt, int sentinel,
                             void* stream) {
  if (D % 8 != 0 || RS % 16 != 0 || RS > Rt || topt < 0 || topt > Rt || E < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int smem = expann_packed_score_smem_bytes(D, Rt);
  cudaError_t err = cudaFuncSetAttribute(
      packed_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  packed_score_kernel<<<B * E, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)packed, (const float*)pnorms, (const int*)pids, (const int*)sel,
      (const float*)q, (float*)out_d, (int*)out_i, E, D, RS, Rt, topt, sentinel);
  return (int)cudaGetLastError();
}

}  // extern "C"
