// fused_jump.cu: kernel K1, the fused multi-level pointer-jump descent of
// the reduce round, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _jump_group_kernel / jump_group in
// sheep_tpu/ops/pallas_jump.py:41-88 (the descent half of
// sheep_tpu/ops/forest.py _lift_descend:195-218).  For each link i and for
// each ancestor table T_k = f^(2^k), deepest stride first:
//     lo <- T_k[lo]   where T_k[lo] < hi
// and out[i] = the final lo.  f is the min-up-neighbour table [n+1]; slot n
// absorbs sentinels (T_k[n] == n, and a dead link has lo == hi == n).
//
// What bounds it on this card: bytes.  Each link reads lo and hi once and
// writes lo once (12 bytes), and the L tables (4(n+1) bytes each) are read
// by data-dependent gathers.  There are no FLOPs to speak of.
//
// Design against the TPU version: the TPU kernel keeps a group of tables
// resident in VMEM (12 MB).  One int32 [n+1] table outgrows a block's
// 227 KB of shared memory once n passes ~57k, so here the tables stay in
// global memory and are gathered through L2 (50 MB) with __ldg; the loop-
// carried lo stays in a register across all L levels, so the whole descent
// is one pass over lo/hi instead of the ~2L passes of the plain version.
// One thread per link, grid-stride loop; the tail is bounds-checked here
// (the Pallas version relied on pow2-padded callers).  A lo outside
// [0, n] is clamped for the gather, as the JAX reference's gathers clamp.
//
// Plain C interface; launched on the caller's stream; allocates nothing
// and does not synchronise.  Returns cudaGetLastError() after the launch.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libfused_jump.so fused_jump.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// resident blocks per SM at kThreads (2048 threads per SM on Hopper)
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
fused_jump_kernel(const int32_t* __restrict__ tables, int levels,
                  int64_t width, const int32_t* __restrict__ lo,
                  const int32_t* __restrict__ hi, int32_t* __restrict__ out,
                  int64_t e) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < e;
       i += stride) {
    int32_t l = __ldg(lo + i);
    const int32_t h = __ldg(hi + i);
    const int32_t* t = tables;
    for (int k = 0; k < levels; ++k, t += width) {
      const int64_t idx = l < 0 ? 0 : (l >= width ? width - 1 : l);
      const int32_t nl = __ldg(t + idx);
      if (nl < h) l = nl;
    }
    out[i] = l;
  }
}

}  // namespace

// tables: int32 [levels, width], deepest stride first, contiguous
// lo, hi, out: int32 [e]; stream: a cudaStream_t (PyTorch's current stream)
extern "C" int sheep_fused_jump(const int32_t* tables, int levels,
                                int64_t width, const int32_t* lo,
                                const int32_t* hi, int32_t* out, int64_t e,
                                void* stream) {
  if (e <= 0) return 0;
  if (levels < 1 || width < 1) return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  int64_t blocks = (e + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  fused_jump_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tables, levels, width, lo, hi, out, e);
  return (int)cudaGetLastError();
}
