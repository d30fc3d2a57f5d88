// fused_jump.cu: kernel K1, the fused multi-level pointer-jump descent of
// the reduce round, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _jump_group_kernel / jump_group in
// sheep_tpu/ops/pallas_jump.py:41-88 (the descent half of
// sheep_tpu/ops/forest.py _lift_descend:195-218).  For each link i and for
// each ancestor table T_k = f^(2^k) of one group, deepest stride first:
//     lo <- T_k[lo]   where T_k[lo] < hi
// and out[i] = the final lo.  f is the min-up-neighbour table [n+1]; slot n
// absorbs sentinels (T_k[n] == n, and a dead link has lo == hi == n).  A lo
// outside [0, width) is clamped for the gather, as the JAX reference's
// gathers clamp, and stays unclamped where the step does not move it.
//
// What bounds it on this card: the gathers.  Each link reads lo and hi once
// and writes lo once (12 bytes, streamed), and makes one data-dependent
// 4-byte gather per level into a table of 4(n+1) bytes; there is no
// arithmetic to speak of.  Each gather costs a 32-byte sector: from L2
// while its table stays there, from HBM once it does not, and a warp's
// gathers share sectors only when its links share lo.
//
// Design:
// - L2-sized table groups.  The wrapper (ops/fused_jump.py plan_groups)
//   launches this kernel once per group of tables that fits half the
//   card's L2, deepest group first, each launch reading the previous
//   one's output: the TPU kernel's VMEM-budget grouping with L2 in place
//   of VMEM.  At n >= 2^22 that is one table a launch, at n = 2^20 six.
//   Links sorted by lo (a reduce round's) take one pass over all tables:
//   their gathers sweep each table in order, so no table needs to stay.
// - Cache policy.  Table gathers carry an L2 evict_last policy
//   (createpolicy + ld.global.nc.L2::cache_hint); lo/hi are read and out
//   written with the streaming hint (__ldcs/__stcs, evict-first), so the
//   12 bytes a link of streaming does not push the group's tables out.
//   The hint helps a group that fits the L2 and costs a little in a pass
//   whose tables do not (against a copy of this kernel without hints, one
//   H100), which the plan avoids for unsorted links.
// - Four links a thread.  lo and hi load as int4 and out stores as int4
//   when all three pointers are 16-byte aligned; otherwise, and for the
//   E % 4 tail, four scalar links a thread, each warp access still
//   coalesced.  At every level a thread issues its four independent
//   gathers before it uses any, so four are in flight per thread where
//   the one-link design had one (a dependent chain of L).  In the int4
//   path a warp stages its 128 links through 1 KB of shared memory so
//   that each gather instruction covers 32 consecutive links, as the
//   scalar path's do: on sorted links, neighbours share lo, so such a
//   gather touches few sectors.
// - The grid is the kernel's occupancy (cudaOccupancyMaxActiveBlocks-
//   PerMultiprocessor) times the SM count, grid-stride beyond it.
// Not used, and why: TMA, staging the tables in shared memory, and wgmma.
// The gathers are data-dependent and their tables (4(n+1) bytes each) are
// far larger than a block's 227 KB of shared memory, so there is no tile
// to stage, and there is no matrix product.
//
// Plain C interface; launched on the caller's stream; allocates nothing
// and does not synchronise.  Returns cudaGetLastError() after the launch.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libfused_jump.so fused_jump.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLinks = 4;  // links a thread

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// A table gather through the read-only path, kept in L2 by the policy.
__device__ __forceinline__ int32_t load_kept(const int32_t* p,
                                             uint64_t policy) {
  int32_t v;
  asm("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(policy));
  return v;
}

// Descend kLinks links through `levels` tables of `width` entries.
__device__ __forceinline__ void descend(const int32_t* __restrict__ t,
                                        int levels, int64_t width,
                                        uint64_t policy, int32_t (&l)[kLinks],
                                        const int32_t (&h)[kLinks]) {
  for (int k = 0; k < levels; ++k, t += width) {
    int32_t nl[kLinks];
#pragma unroll
    for (int j = 0; j < kLinks; ++j) {
      const int64_t idx = l[j] < 0 ? 0 : (l[j] >= width ? width - 1 : l[j]);
      nl[j] = load_kept(t + idx, policy);
    }
#pragma unroll
    for (int j = 0; j < kLinks; ++j)
      if (nl[j] < h[j]) l[j] = nl[j];
  }
}

__global__ void __launch_bounds__(kThreads)
fused_jump_kernel(const int32_t* __restrict__ tables, int levels,
                  int64_t width, const int32_t* __restrict__ lo,
                  const int32_t* __restrict__ hi, int32_t* __restrict__ out,
                  int64_t e, int vec) {
  const uint64_t policy = evict_last_policy();
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t quads = e / kLinks;
    const int4* lo4 = reinterpret_cast<const int4*>(lo);
    const int4* hi4 = reinterpret_cast<const int4*>(hi);
    int4* out4 = reinterpret_cast<int4*>(out);
    // Each warp stages its 128 links through shared memory: lane t stores
    // links 4t..4t+3 as one int4 and reads back links t, 32+t, 64+t,
    // 96+t, so each warp-wide gather covers 32 consecutive links, as the
    // scalar path's do (on sorted links neighbours share lo, and such a
    // gather touches few sectors); out goes back the same way.
    __shared__ int4 stage[kThreads / 32][2][32];
    const int lane = threadIdx.x & 31;
    int4* slo4 = stage[threadIdx.x >> 5][0];
    int4* shi4 = stage[threadIdx.x >> 5][1];
    int32_t* slo = reinterpret_cast<int32_t*>(slo4);
    const int32_t* shi = reinterpret_cast<const int32_t*>(shi4);
    // the trip count is the warp's, so its lanes stage together; a lane
    // past the end descends lo = hi = 0, which never moves
    for (int64_t q0 = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
         q0 < quads; q0 += nthreads) {
      const int64_t q = q0 + lane;
      const bool ok = q < quads;
      const int4 zero = make_int4(0, 0, 0, 0);
      slo4[lane] = ok ? __ldcs(lo4 + q) : zero;
      shi4[lane] = ok ? __ldcs(hi4 + q) : zero;
      __syncwarp();
      int32_t l[kLinks], h[kLinks];
#pragma unroll
      for (int j = 0; j < kLinks; ++j) {
        l[j] = slo[32 * j + lane];
        h[j] = shi[32 * j + lane];
      }
      descend(tables, levels, width, policy, l, h);
#pragma unroll
      for (int j = 0; j < kLinks; ++j) slo[32 * j + lane] = l[j];
      __syncwarp();
      if (ok) __stcs(out4 + q, slo4[lane]);
      __syncwarp();
    }
    done = quads * kLinks;
  }
  // scalar links: all of them when a pointer is not 16-byte aligned, else
  // the E % 4 tail; a block takes kLinks * blockDim consecutive links,
  // thread t the links t, t + blockDim, ... of them
  const int64_t span = (int64_t)kLinks * blockDim.x;
  for (int64_t base = done + (int64_t)blockIdx.x * span; base < e;
       base += (int64_t)gridDim.x * span) {
    int32_t l[kLinks], h[kLinks];
#pragma unroll
    for (int j = 0; j < kLinks; ++j) {
      const int64_t i = base + (int64_t)j * blockDim.x + threadIdx.x;
      // a lane past the end descends lo = hi = 0, which never moves
      l[j] = i < e ? __ldcs(lo + i) : 0;
      h[j] = i < e ? __ldcs(hi + i) : 0;
    }
    descend(tables, levels, width, policy, l, h);
#pragma unroll
    for (int j = 0; j < kLinks; ++j) {
      const int64_t i = base + (int64_t)j * blockDim.x + threadIdx.x;
      if (i < e) __stcs(out + i, l[j]);
    }
  }
}

}  // namespace

// tables: int32 [levels, width], deepest stride first, contiguous (one
// group); lo, hi, out: int32 [e]; stream: a cudaStream_t (PyTorch's
// current stream)
extern "C" int sheep_fused_jump(const int32_t* tables, int levels,
                                int64_t width, const int32_t* lo,
                                const int32_t* hi, int32_t* out, int64_t e,
                                void* stream) {
  if (e <= 0) return 0;
  if (levels < 1 || width < 1) return (int)cudaErrorInvalidValue;
  static int sms = 0, per_sm = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_jump_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const int vec = ((uintptr_t)lo | (uintptr_t)hi | (uintptr_t)out) % 16 == 0;
  const int64_t per_block = (int64_t)kLinks * kThreads;
  int64_t blocks = (e + per_block - 1) / per_block;
  const int64_t cap = (int64_t)sms * per_sm;
  if (blocks > cap) blocks = cap;
  fused_jump_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tables, levels, width, lo, hi, out, e, vec);
  return (int)cudaGetLastError();
}

// The L2 size in bytes of the current device (cudaDevAttrL2CacheSize), or
// a negative CUDA error code.
extern "C" int64_t sheep_l2_cache_bytes(void) {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrL2CacheSize, dev);
  return err == cudaSuccess ? (int64_t)bytes : -(int64_t)err;
}
