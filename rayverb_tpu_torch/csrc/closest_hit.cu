// Closest-hit ray/triangle sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel rayverb_tpu/ops/intersect_pallas.py::_kernel
// (launched by _closest_hit_padded, wrapped by closest_hit_pallas): the
// closest valid hit (best_t, best_i) of M rays against the Morton-ordered
// packed Woop table of rayverb_tpu_torch/ops/intersect.py::build_sweep_table.
//
// Contract (identical to the Pallas kernel and to closest_hit_plain):
//   - pair test on packed rows [row_u, row_v, n, orig_idx, bu, bv, bw]:
//     |n.d| < EPSILON is degenerate, strict barycentric bounds, t > EPSILON
//   - best_t starts at the ray's t_max (inclusive), best_i at -1
//   - equal t resolves to the lowest ORIGINAL triangle index
//   - at each triangle block's entry a ray takes part only if its bound is
//     positive, it is undecided (best_t >= t_decide) and its segment
//     [EPSILON, best_t] meets the block's AABB (slab test)
//
// What bounds it on the H100: operations. A pair test is ~40 FP32
// operations (one divide among them) on 13 floats of a triangle row that
// every ray of a thread block shares, so the table's bytes are re-read from
// L2 once per thread block and per needed tile; device-memory traffic is a
// few bytes per ray. What the design does about it: one thread per ray
// keeps each ray's running best in registers; a thread block stages one
// 128-row triangle tile at a time in shared memory (8 KB, float4 loads) and
// every thread then reads the same row at the same time (a broadcast, no
// bank conflicts); a tile that no ray of the block needs, because of its
// AABB, the rays' running best_t or their decided verdicts, is neither
// loaded nor tested (__syncthreads_or). Rays arrive Morton-sorted, so the
// rays of one block share the tiles they need.
//
// Arithmetic is written operation for operation as closest_hit_plain does
// it and the file is built with --fmad=false (no FMA contraction) and IEEE
// division, so the kernel's (best_t, best_i) equal the plain version's bit
// for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;     // rays per thread block
constexpr int kTile = 128;        // triangle rows per tile (SWEEP_BLOCK)
constexpr int kRowFloats = 16;    // packed row width
constexpr float kEps = 1e-4f;     // rayverb_tpu_torch.constants.EPSILON

__device__ __forceinline__ void slab_axis(float o, float dv, float iv,
                                          float lo, float hi, float& tn,
                                          float& tf) {
  float nearv = (lo - o) * iv;
  float farv = (hi - o) * iv;
  float a = fminf(nearv, farv);
  float b = fmaxf(nearv, farv);
  if (fabsf(dv) < 1e-30f) {
    bool inside = (o >= lo) && (o <= hi);
    a = inside ? -INFINITY : INFINITY;
    b = inside ? INFINITY : -INFINITY;
  }
  tn = a;
  tf = b;
}

__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ origins,
                   const float* __restrict__ dirs,
                   const float* __restrict__ t_max,
                   const float* __restrict__ t_decide,
                   const float4* __restrict__ packed,
                   const float* __restrict__ aabb, int m, int nblocks,
                   float* __restrict__ best_t_out,
                   int* __restrict__ best_i_out) {
  __shared__ float4 tile[kTile * kRowFloats / 4];

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = ray < m;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float bt = 0.f, decide = 0.f;
  if (in_range) {
    ox = origins[3 * ray + 0];
    oy = origins[3 * ray + 1];
    oz = origins[3 * ray + 2];
    dx = dirs[3 * ray + 0];
    dy = dirs[3 * ray + 1];
    dz = dirs[3 * ray + 2];
    bt = t_max[ray];
    decide = t_decide[ray];
  }
  const float ivx = 1.0f / dx;
  const float ivy = 1.0f / dy;
  const float ivz = 1.0f / dz;
  const bool live = in_range && (bt > 0.f);
  int bi = -1;

  for (int b = 0; b < nblocks; ++b) {
    bool need = false;
    if (live && bt >= decide) {
      const float* box = aabb + 8 * b;
      float tnx, tfx, tny, tfy, tnz, tfz;
      slab_axis(ox, dx, ivx, box[0], box[3], tnx, tfx);
      slab_axis(oy, dy, ivy, box[1], box[4], tny, tfy);
      slab_axis(oz, dz, ivz, box[2], box[5], tnz, tfz);
      float tn = fmaxf(fmaxf(tnx, tny), tnz);
      float tf = fminf(fminf(tfx, tfy), tfz);
      need = (tf >= fmaxf(tn, kEps)) && (tn <= bt);
    }
    // also the barrier that keeps the previous tile alive until every
    // thread is done with it
    if (!__syncthreads_or(need)) continue;

    const float4* src = packed + (size_t)b * (kTile * kRowFloats / 4);
    for (int i = threadIdx.x; i < kTile * kRowFloats / 4; i += kThreads) {
      tile[i] = src[i];
    }
    __syncthreads();

    if (need) {
      const float* rows = reinterpret_cast<const float*>(tile);
      for (int j = 0; j < kTile; ++j) {
        const float* r = rows + j * kRowFloats;
        float ou = r[0] * ox + r[1] * oy + r[2] * oz + r[10];
        float ov = r[3] * ox + r[4] * oy + r[5] * oz + r[11];
        float ow = r[6] * ox + r[7] * oy + r[8] * oz + r[12];
        float du = r[0] * dx + r[1] * dy + r[2] * dz;
        float dv = r[3] * dx + r[4] * dy + r[5] * dz;
        float dw = r[6] * dx + r[7] * dy + r[8] * dz;
        bool degenerate = fabsf(dw) < kEps;
        float t = -ow / (degenerate ? 1.0f : dw);
        float u = ou + t * du;
        float v = ov + t * dv;
        bool valid = !degenerate && (u >= 0.f) && (u <= 1.f) && (v >= 0.f) &&
                     (u + v <= 1.f) && (t > kEps);
        if (valid && t <= bt) {
          int oi = (int)r[9];
          if (t < bt || (t < INFINITY && (oi < bi || bi < 0))) {
            bt = t;
            bi = oi;
          }
        }
      }
    }
  }
  if (in_range) {
    best_t_out[ray] = bt;
    best_i_out[ray] = bi;
  }
}

}  // namespace

// C interface for ctypes. All pointers are device pointers of contiguous
// float32 (int32 for best_i) arrays: origins and dirs (m, 3), t_max and
// t_decide (m,), packed (nblocks * 128, 16), aabb (nblocks, 8), outputs
// (m,). Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int rv_closest_hit(const void* origins, const void* dirs,
                              const void* t_max, const void* t_decide,
                              const void* packed, const void* aabb, int m,
                              int nblocks, void* best_t, void* best_i,
                              void* stream) {
  if (m <= 0) return 0;
  dim3 grid((m + kThreads - 1) / kThreads);
  closest_hit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)origins, (const float*)dirs, (const float*)t_max,
      (const float*)t_decide, (const float4*)packed, (const float*)aabb, m,
      nblocks, (float*)best_t, (int*)best_i);
  return (int)cudaGetLastError();
}
