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
// (16n, counting f once).  Neither does arithmetic to speak of.  Design:
// one thread per element over a grid-stride loop, neighbouring threads on
// neighbouring addresses so every lo/hi/x/out access coalesces; P2's
// gather goes through the read-only path (__ldg).  The TPU versions stage
// whole arrays through VMEM; here nothing is staged, since each element is
// touched once.
//
// Plain C interface; each launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libprobe_kernels.so probe_kernels.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// resident blocks per SM at kThreads (2048 threads per SM on Hopper)
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
add_one_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
               int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    // unsigned add: wraps at INT32_MAX as torch's int32 x + 1 does
    out[i] = (int32_t)((uint32_t)__ldg(x + i) + 1u);
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

// Blocks for a grid-stride launch over n elements: enough to fill every
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

}  // namespace

// x, out: int32 [n], contiguous; stream: a cudaStream_t
extern "C" int sheep_probe_add_one(const int32_t* x, int32_t* out, int64_t n,
                                   void* stream) {
  if (n <= 0) return 0;
  int blocks = 0;
  const int err = grid_for(n, &blocks);
  if (err) return err;
  add_one_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, out, n);
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
