// probe_kernels.cu: the backend probe's two kernels, written for Hopper
// (sm_90a).
//
// P1, add_one: out = x + 1 over a contiguous int32 buffer.  Replaces the
// Pallas TPU kernel add_one_kernel / the pallas_call lambda in main,
// scripts/pallas_probe.py:37-44 (stage 1 of the backend probe: can the
// backend run a trivial kernel at all).
//
// P2, jump_step: one level of the reduce round's pointer jump,
//     nlo = f[clamp(lo)];  out = nlo < hi ? nlo : lo
// Replaces jump_kernel / jump_pl, scripts/pallas_probe.py:67-76 (stage 2:
// the plain 1-D gather on its own, the shape kernel K1 is built from).
// The gather index is clamped into [0, width) as jnp's gathers clamp; the
// output keeps the unclamped lo where the step does not move it.
//
// What bounds them on this card: bytes.  P1 reads 4 and writes 4 bytes per
// element (8n); P2 reads lo, hi and one gathered f entry and writes out
// (16n, counting f once).  Neither does arithmetic to speak of.  The TPU
// versions stage whole arrays through VMEM; here nothing is staged, since
// each element is touched once.
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
// P2's design: one thread per element over a grid-stride loop, neighbouring
// threads on neighbouring addresses so every lo/hi/out access coalesces;
// the gather goes through the read-only path (__ldg).
//
// Plain C interface; each launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libprobe_kernels.so probe_kernels.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// P2's resident blocks per SM at kThreads (2048 threads per SM on Hopper)
constexpr int kBlocksPerSm = 8;

constexpr int kLanes = 4;  // P1's elements a thread

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

__global__ void __launch_bounds__(kThreads)
jump_step_kernel(const int32_t* __restrict__ f, int64_t width,
                 const int32_t* __restrict__ lo,
                 const int32_t* __restrict__ hi, int32_t* __restrict__ out,
                 int64_t e) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < e;
       i += stride) {
    const int32_t l = __ldg(lo + i);
    const int64_t idx = l < 0 ? 0 : (l >= width ? width - 1 : l);
    const int32_t nl = __ldg(f + idx);
    out[i] = nl < __ldg(hi + i) ? nl : l;
  }
}

// Blocks for P2's grid-stride launch over n elements: enough to fill every
// SM, never more than the elements need.
int grid_for(int64_t n, int* blocks) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  int64_t b = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  *blocks = (int)(b < cap ? b : cap);
  return 0;
}

// Blocks for P1's launch over n elements: one int4 (or four scalar
// elements) a thread, all in one grid.
int add_one_grid(int64_t n, int* blocks) {
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
  const int err = add_one_grid(n, &blocks);
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
  const int err = grid_for(e, &blocks);
  if (err) return err;
  jump_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      f, width, lo, hi, out, e);
  return (int)cudaGetLastError();
}
