// The trace's two per-bounce sort keys for Hopper (sm_90a), one launch each.
//
// Replaces no TPU kernel: the JAX trace computes these keys in XLA, which
// fuses them (rayverb_tpu/ops/trace.py::_ray_sort_key :110 and the
// direction key of _shadow_rows :258). The port's plain versions,
// rayverb_tpu_torch/ops/trace.py::_ray_sort_key and _dir_morton, run them
// as 127 and 50 elementwise int64 device operations a key (torch.profiler
// on the H100); these kernels compute the same values in one pass over the
// rows.
//
//   - rv_bounce_key: the mix6 bounce key, a 1:1 interleave of the top 16
//     bits of the 27-bit position Morton code (position quantised in the
//     scene's bounds) and of the direction Morton code.
//   - rv_shadow_key: the shadow rows' direction Morton code, 0xFFFFFFFF on
//     a dead row; with pair ids (the multi-pair trace), the int64
//     (alive ? pair : 0x7FFFFFFF) << 32 | key.
//
// A uint32 key leaves as the int32 key ^ 0x80000000: flipping the top bit
// and reading the word as signed keeps the unsigned order, so a stable sort
// of the int32 keys gives the permutation of the uint32 values, and its
// radix sort needs 32 bits, not 64.
//
// Arithmetic: each float step is the plain version's own rounding, written
// with __fsub_rn / __fmul_rn / __fadd_rn so that no multiply and add ever
// contract (NVCC_FLAGS has --fmad=false besides): (pos - lo) * inv_span *
// 511 and (d * 0.5 + 0.5) * 511 are three float32 roundings each, in that
// order; then the clamp to [0, 511] and truncation, as torch.clamp and the
// int64 cast do on finite inputs. The trace's inputs are finite.
//
// What bounds it on the H100: device memory, 28 B a row for the bounce key
// (two float3 rows read, one int32 written) and 17 B for the shadow key,
// ~0.4 us at 50,000 rows at 3.35 TB/s; at the trace's row counts (50,000
// to 1 M) a launch costs more than that, so the design is one thread a row
// and nothing else: the launch is the cost that it removes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// the low 9 bits of x to every third bit (ops/trace.py::_spread9)
__device__ __forceinline__ uint32_t spread9(uint32_t x) {
  x &= 0x1FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

// the low 16 bits of x to every second bit (ops/trace.py::_spread16)
__device__ __forceinline__ uint32_t spread16(uint32_t x) {
  x &= 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// clamp to [0, 511], then truncate (ops/trace.py::_quant9)
__device__ __forceinline__ uint32_t quant9(float x) {
  return (uint32_t)fminf(fmaxf(x, 0.0f), 511.0f);
}

__device__ __forceinline__ uint32_t morton3(uint32_t a, uint32_t b, uint32_t c) {
  return spread9(a) | (spread9(b) << 1) | (spread9(c) << 2);
}

// 27-bit Morton code of a unit direction mapped into [0, 1]^3
// (ops/trace.py::_dir_morton)
__device__ __forceinline__ uint32_t dir_morton(const float* d) {
  uint32_t q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q[k] = quant9(__fmul_rn(__fadd_rn(__fmul_rn(d[k], 0.5f), 0.5f), 511.0f));
  }
  return morton3(q[0], q[1], q[2]);
}

__device__ __forceinline__ int32_t signed_key(uint32_t key) {
  return (int32_t)(key ^ 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
ray_bounce_key(const float* __restrict__ pos, const float* __restrict__ dir,
               const float* __restrict__ lo, const float* __restrict__ inv_span,
               int n, int32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q[k] = quant9(__fmul_rn(__fmul_rn(__fsub_rn(pos[3 * i + k], lo[k]), inv_span[k]),
                            511.0f));
  }
  const uint32_t m = morton3(q[0], q[1], q[2]);
  const uint32_t dm = dir_morton(dir + 3 * i);
  out[i] = signed_key((spread16(m >> 11) << 1) | spread16(dm >> 11));
}

__global__ void __launch_bounds__(kThreads)
ray_shadow_key(const float* __restrict__ d, const uint8_t* __restrict__ alive,
               const int64_t* __restrict__ pair, int n, void* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const bool live = alive[i] != 0;
  const uint32_t key = live ? dir_morton(d + 3 * i) : 0xFFFFFFFFu;
  if (pair == nullptr) {
    ((int32_t*)out)[i] = signed_key(key);
  } else {
    const uint64_t major = live ? (uint64_t)pair[i] : 0x7FFFFFFFull;
    ((int64_t*)out)[i] = (int64_t)((major << 32) | key);
  }
}

unsigned blocks_for(int n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// pos, dir (n, 3) float32; lo, inv_span (3,) float32; out (n,) int32. All
// device pointers; returns the launch's CUDA error (0 on success).
extern "C" int rv_bounce_key(const void* pos, const void* dir, const void* lo,
                             const void* inv_span, int n, void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  ray_bounce_key<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)dir, (const float*)lo, (const float*)inv_span, n,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// d (n, 3) float32; alive (n,) bool; pair (n,) int64 or null; out (n,)
// int32 without pair, int64 with it. Returns the launch's CUDA error.
extern "C" int rv_shadow_key(const void* d, const void* alive, const void* pair, int n,
                             void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  ray_shadow_key<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const uint8_t*)alive, (const int64_t*)pair, n, out);
  return (int)cudaGetLastError();
}
