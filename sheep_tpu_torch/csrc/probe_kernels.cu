// probe_kernels.cu: the backend probe's two kernels, written for Hopper
// (sm_90a).
//
// P1, add_one: out = x + 1 over a contiguous int32 buffer.  Replaces the
// Pallas TPU kernel add_one_kernel / the pallas_call lambda in main,
// scripts/pallas_probe.py:37-44 (stage 1 of the backend probe: can the
// backend run a trivial kernel at all).
//
// P2, jump_step: one level of the reduce round's pointer jump,
//     nlo = f[idx(lo)];  out = nlo < hi ? nlo : lo
// Replaces jump_kernel / jump_pl, scripts/pallas_probe.py:67-76 (stage 2:
// the plain 1-D gather on its own, the shape kernel K1 is built from).
// The gather index is jnp's: a negative lo counts from the end (lo + width),
// then the index is clamped into [0, width); the output keeps the lo it
// was given where the step does not move it.
//
// What bounds them on this card: bytes.  P1 reads 4 and writes 4 bytes per
// element (8n).  P2 reads lo and hi and writes out (12n, streamed once) and
// makes one random 4-byte gather into f per element; its bound counts f
// once (16n), but every gather costs a whole 32-byte sector, from the L2
// while f's line is there and from HBM once it is not.  At n = 2^24 f is
// 64 MB against the H100's 50 MB L2, so the gathers, not the streams, set
// the time.  The TPU versions stage whole arrays through VMEM; here nothing
// is staged, since each element is touched once.
//
// P1's design: a streaming kernel reaches the memory rate only with enough
// bytes in flight, so each thread moves 16 bytes a load: four int32 lanes
// as one int4 load and one int4 store when x and out are both 16-byte
// aligned.  Otherwise (a view at an odd storage offset), and for the n % 4
// tail, each thread takes four scalar elements, one blockDim apart so every
// warp access still coalesces.  The grid covers the whole array, one int4
// a thread, so blocks start and retire in address order and the addresses
// in flight stay in one window (a grid capped at the kernel's occupancy,
// each thread striding over the array, ran measurably slower on one H100
// at 2^24 and 2^26, however many loads a thread kept in flight).
//
// P2's design, for an f that outgrows the L2:
// - Four elements a thread, on a grid over the whole array, as P1: lo and
//   hi load as int4 and out stores as int4 when all three are 16-byte
//   aligned, else (and for the e % 4 tail) four scalar elements one
//   blockDim apart.  A thread issues its four gathers before any compare,
//   so four independent gathers are in flight per thread.
// - The streams are evict-first: lo and hi load with __ldcs and out stores
//   with __stcs, so their 12n bytes do not push f's lines out of the L2.
// - Each gather is marked L2 evict_last (createpolicy +
//   ld.global.nc.L2::cache_hint), to keep f's lines over the streams'.
//   Measured on one H100 at 2^24 it ties an unhinted __ldg gather and beats
//   an L2 access-policy window over f (PERF.md): past the L2 the
//   random gathers set the time, whatever keeps f.
// Not the design: partitioning lo by range into L2-sized buckets, so that
// each pass gathers from one L2-sized slice of f.  Putting out back into
// the original order is then a random scatter, which costs a sector per
// element again.
//
// Plain C interface; each launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libprobe_kernels.so probe_kernels.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;  // elements a thread

// unsigned add: wraps at INT32_MAX as torch's int32 x + 1 does
__device__ __forceinline__ int32_t plus_one(int32_t v) {
  return (int32_t)((uint32_t)v + 1u);
}

__global__ void __launch_bounds__(kThreads)
add_one_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
               int64_t n, int vec) {
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t quads = n / kLanes;
    const int4* x4 = reinterpret_cast<const int4*>(x);
    int4* out4 = reinterpret_cast<int4*>(out);
    for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         q < quads; q += nthreads) {
      const int4 v = __ldg(x4 + q);
      out4[q] = make_int4(plus_one(v.x), plus_one(v.y), plus_one(v.z),
                          plus_one(v.w));
    }
    done = quads * kLanes;
  }
  // scalar elements: all of them when a pointer is not 16-byte aligned,
  // else the n % 4 tail
  const int64_t span = (int64_t)kLanes * blockDim.x;
  for (int64_t base = done + (int64_t)blockIdx.x * span; base < n;
       base += (int64_t)gridDim.x * span) {
    int32_t v[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int64_t i = base + (int64_t)j * blockDim.x + threadIdx.x;
      v[j] = i < n ? __ldg(x + i) : 0;
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int64_t i = base + (int64_t)j * blockDim.x + threadIdx.x;
      if (i < n) out[i] = plus_one(v[j]);
    }
  }
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// One gather from f, marked L2 evict_last by the policy.
__device__ __forceinline__ int32_t gather(const int32_t* __restrict__ f,
                                          int64_t width, int32_t l,
                                          uint64_t policy) {
  int64_t i = l < 0 ? (int64_t)l + width : (int64_t)l;
  const int32_t* p = f + (i < 0 ? 0 : (i >= width ? width - 1 : i));
  int32_t v;
  asm("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ int32_t step(int32_t nl, int32_t h, int32_t l) {
  return nl < h ? nl : l;
}

__global__ void __launch_bounds__(kThreads)
jump_step_kernel(const int32_t* __restrict__ f, int64_t width,
                 const int32_t* __restrict__ lo,
                 const int32_t* __restrict__ hi, int32_t* __restrict__ out,
                 int64_t e, int vec) {
  const uint64_t policy = evict_last_policy();
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t quads = e / kLanes;
    const int4* lo4 = reinterpret_cast<const int4*>(lo);
    const int4* hi4 = reinterpret_cast<const int4*>(hi);
    int4* out4 = reinterpret_cast<int4*>(out);
    for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         q < quads; q += nthreads) {
      const int4 l = __ldcs(lo4 + q);
      const int4 h = __ldcs(hi4 + q);
      const int32_t n0 = gather(f, width, l.x, policy);
      const int32_t n1 = gather(f, width, l.y, policy);
      const int32_t n2 = gather(f, width, l.z, policy);
      const int32_t n3 = gather(f, width, l.w, policy);
      __stcs(out4 + q, make_int4(step(n0, h.x, l.x), step(n1, h.y, l.y),
                                 step(n2, h.z, l.z), step(n3, h.w, l.w)));
    }
    done = quads * kLanes;
  }
  // scalar elements: all of them when a pointer is not 16-byte aligned,
  // else the e % 4 tail
  const int64_t span = (int64_t)kLanes * blockDim.x;
  for (int64_t base = done + (int64_t)blockIdx.x * span; base < e;
       base += (int64_t)gridDim.x * span) {
    int32_t l[kLanes], h[kLanes], nl[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int64_t i = base + (int64_t)j * blockDim.x + threadIdx.x;
      l[j] = i < e ? __ldcs(lo + i) : 0;
      h[j] = i < e ? __ldcs(hi + i) : 0;
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) nl[j] = gather(f, width, l[j], policy);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int64_t i = base + (int64_t)j * blockDim.x + threadIdx.x;
      if (i < e) __stcs(out + i, step(nl[j], h[j], l[j]));
    }
  }
}

// Blocks for a launch over n elements: one int4 (or four scalar elements)
// a thread, all in one grid.
int quad_grid(int64_t n, int* blocks) {
  const int64_t per_block = (int64_t)kLanes * kThreads;
  const int64_t b = (n + per_block - 1) / per_block;
  *blocks = (int)(b < INT32_MAX ? b : INT32_MAX);
  return 0;
}

}  // namespace

// x, out: int32 [n], contiguous; stream: a cudaStream_t
extern "C" int sheep_probe_add_one(const int32_t* x, int32_t* out, int64_t n,
                                   void* stream) {
  if (n <= 0) return 0;
  int blocks = 0;
  const int err = quad_grid(n, &blocks);
  if (err) return err;
  const int vec = ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  add_one_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, out, n,
                                                                vec);
  return (int)cudaGetLastError();
}

// f: int32 [width]; lo, hi, out: int32 [e]; all contiguous
extern "C" int sheep_probe_jump_step(const int32_t* f, int64_t width,
                                     const int32_t* lo, const int32_t* hi,
                                     int32_t* out, int64_t e, void* stream) {
  if (e <= 0) return 0;
  if (width < 1) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int err = quad_grid(e, &blocks);
  if (err) return err;
  const int vec = ((uintptr_t)lo | (uintptr_t)hi | (uintptr_t)out) % 16 == 0;
  jump_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      f, width, lo, hi, out, e, vec);
  return (int)cudaGetLastError();
}
