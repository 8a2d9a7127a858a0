// Sequential biquad scan for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs the crossover bank's IIR
// recurrence as lax.scan (rayverb_tpu/ops/filters.py::biquad_onepass, :157,
// vmapped over bands and channels at :257 and in the fused finalize,
// rayverb_tpu/ops/render.py:990-996). PyTorch has no scan, and a Python
// loop over time would enqueue ~8 kernels per sample, so this step runs on
// the card only as a kernel written by hand.
//
// Contract (identical to rayverb_tpu_torch/ops/filters.py::
// biquad_onepass_plain, bit for bit): for each series s of x (series, t)
// with float32 coefficients coeffs[s] = [b0, b1, b2, a1, a2], direct form
// II transposed from zero state,
//     out = x*b0 + z1
//     z1' = (x*b1 + z2) - a1*out
//     z2' = x*b2 - a2*out
// each multiply and add rounded on its own (no FMA), over the samples
// [0, content) in order, or from content - 1 down to 0 when `reverse`;
// samples at and after `content` are written as +0 (the fused finalize's
// mask after every pass, ops/render.py). y may alias x. With `contents`
// (an (series,) int32 device array) series s takes contents[s] in place of
// `content`: the batched finalize gives each pair its own content length,
// so one launch covers every pair's series (one thread block each).
//
// What bounds it on the H100: the recurrence's dependent chain, not bytes.
// From one output to the next the chain is a multiply, a subtract and an
// add (a1*out, then z1', then the next out), ~12 cycles at ~4 cycles each:
// ~3.2 ms per pass at 524,288 samples at 1.98 GHz, against a byte bound of
// 0.020 ms for the vault's 16 series (67 MB read and written at 3.35 TB/s).
// Splitting one series over threads (a chunked parallel recurrence) would
// cut the chain but changes the rounding; it is later work.
//
// What the design does about it: one thread block per series, so all
// series run their chains at once; one thread runs the chain, reading its
// samples from shared memory (latency hidden by unrolling, the chain never
// waits on device memory). The other seven warps stage the series through
// two shared-memory tiles: while the chain runs over one tile they write
// the previous tile out and load the next, coalesced, so the card's memory
// traffic overlaps the chain.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // warp 0 runs the chain, warps 1-7 stage
constexpr int kStagers = kThreads - 32;
constexpr int kTile = 4096;         // samples per tile; two tiles = 32 KB

__device__ __forceinline__ float step(float x, float b0, float b1, float b2,
                                      float a1, float a2, float& z1,
                                      float& z2) {
  const float out = __fadd_rn(__fmul_rn(x, b0), z1);
  const float nz1 = __fsub_rn(__fadd_rn(__fmul_rn(x, b1), z2), __fmul_rn(a1, out));
  z2 = __fsub_rn(__fmul_rn(x, b2), __fmul_rn(a2, out));
  z1 = nz1;
  return out;
}

// the tile walked k-th: its first sample and length
__device__ __forceinline__ void tile_span(int k, int ntiles, int content,
                                          int reverse, int& start, int& len) {
  const int tk = reverse ? ntiles - 1 - k : k;
  start = tk * kTile;
  len = min(kTile, content - start);
}

__global__ void __launch_bounds__(kThreads)
biquad_scan(const float* x, float* y, const float* __restrict__ coeffs,
            int t, int content_all, const int* __restrict__ contents,
            int reverse) {
  __shared__ float buf[2][kTile];
  const size_t base = (size_t)blockIdx.x * (size_t)t;
  const float* xs = x + base;
  float* ys = y + base;
  const int tid = threadIdx.x;
  const int content = contents ? contents[blockIdx.x] : content_all;

  for (int i = content + tid; i < t; i += kThreads) ys[i] = 0.0f;
  const int ntiles = (content + kTile - 1) / kTile;
  if (ntiles == 0) return;

  int start, len;
  tile_span(0, ntiles, content, reverse, start, len);
  for (int i = tid; i < len; i += kThreads) buf[0][i] = xs[start + i];
  __syncthreads();

  const float* c = coeffs + 5 * (size_t)blockIdx.x;
  const float b0 = c[0], b1 = c[1], b2 = c[2], a1 = c[3], a2 = c[4];
  float z1 = 0.0f, z2 = 0.0f;

  for (int k = 0; k < ntiles; ++k) {
    float* cur = buf[k & 1];
    if (tid == 0) {
      tile_span(k, ntiles, content, reverse, start, len);
      if (!reverse) {
#pragma unroll 8
        for (int i = 0; i < len; ++i) cur[i] = step(cur[i], b0, b1, b2, a1, a2, z1, z2);
      } else {
#pragma unroll 8
        for (int i = len - 1; i >= 0; --i) cur[i] = step(cur[i], b0, b1, b2, a1, a2, z1, z2);
      }
    } else if (tid >= 32) {
      // the other buffer: write tile k-1 out, then load tile k+1 into it.
      // Each slot i is written out and refilled by the same thread, so no
      // barrier is needed between the two.
      float* other = buf[(k + 1) & 1];
      const int j = tid - 32;
      if (k >= 1) {
        int ps, pl;
        tile_span(k - 1, ntiles, content, reverse, ps, pl);
        for (int i = j; i < pl; i += kStagers) ys[ps + i] = other[i];
      }
      if (k + 1 < ntiles) {
        int ns, nl;
        tile_span(k + 1, ntiles, content, reverse, ns, nl);
        for (int i = j; i < nl; i += kStagers) other[i] = xs[ns + i];
      }
    }
    __syncthreads();
  }

  tile_span(ntiles - 1, ntiles, content, reverse, start, len);
  const float* last = buf[(ntiles - 1) & 1];
  for (int i = tid; i < len; i += kThreads) ys[start + i] = last[i];
}

}  // namespace

// C interface for ctypes. x and y: device pointers of contiguous (series, t)
// float32 arrays (y may equal x); coeffs: (series, 5) float32. Samples
// [content, t) of y are written as 0; 0 <= content <= t. contents: null, or
// a device pointer of (series,) int32 per-series lengths in [0, t] (the
// caller checks them) that take the place of `content`. Enqueues one launch
// on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments out of range).
extern "C" int rv_biquad_scan(const void* x, void* y, const void* coeffs,
                              int series, int t, int content,
                              const void* contents, int reverse,
                              void* stream) {
  if (series < 0 || t < 0 || content < 0 || content > t) {
    return (int)cudaErrorInvalidValue;
  }
  if (series == 0 || t == 0) return 0;
  biquad_scan<<<series, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, (const float*)coeffs, t, content,
      (const int*)contents, reverse != 0);
  return (int)cudaGetLastError();
}
