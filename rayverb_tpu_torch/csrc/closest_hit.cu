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
// The schedule is an input, shared with closest_hit_plain: each group of
// kRays rays walks its own row of `order` (near to far: closest_hit_order,
// whose plain version is intersect.py::block_order), cut into `slices`
// contiguous runs.
//
// What bounds it on the H100: instruction issue. A pair test is ~40 FP32
// operations (one IEEE divide among them) on 13 floats of a triangle row
// that every ray of a thread block shares; device-memory traffic is a few
// bytes per ray. Built with --fmad=false, every multiply and add is its
// own instruction, so the SM's issue rate (one warp instruction per clock
// and scheduler), not the 67 TFLOP/s FMA peak, is the ceiling: the row
// loop is ~22 instructions per pair for the pre-test and ~86 with the full
// test (cuobjdump -sass; chip_smoke.py prints the counts). Tensor cores do
// not serve: each pair needs six affine forms of depth 3 (K = 4 with the
// offset) and then a divide and compares that depend on them, and the
// contract is bit-exact FP32, which TF32 or a matrix unit's reordered sums
// would break.
//
// What the design does about it:
//   1. Four threads per ray. A thread block holds 32 rays x 4 threads; the
//      4 threads of a ray sit in one warp, each sweeps every 4th row of a
//      tile with its own running best, and at the tile's end they merge by
//      warp shuffles. The merge takes the minimum of key = float bits of
//      best_t << 32 | index (-1 packs as 0xFFFFFFFF): best_t > 0 on a live
//      ray and positive floats order as their bits, so that minimum is the
//      tie rule folded over all 128 rows, in any order. Each thread's chain
//      is a quarter of the tile, with no more pairs executed.
//   2. The table may be split across thread blocks: the grid is (ray
//      groups x table slices), so a small batch still fills the 132 SMs
//      and a batch with few live rays spreads their walks. Each slice
//      culls with its own running best, so slices add executed pairs;
//      sweep_slices (ops/intersect.py) takes 8 for closest-hit batches and
//      for decided batches only as many as keep the card busy, the counts
//      that ran fastest on whole renders' sweeps on the H100. Each slice
//      ends with its best as the same key; accepted t > EPSILON > 0, so
//      the keys' minimum is the tie rule, and its minimum with the seed
//      (t_max, 0xFFFFFFFF) keeps t == t_max winning with any index. The
//      minimum is commutative, so the result does not depend on which
//      slice finishes first.
//   3. The sweep's epilogue writes the caller's Hit itself (t, +inf on a
//      miss; int64 index, 0 on a miss; bool hit: the mapping of
//      rayverb_tpu/ops/intersect_pallas.py:686-690, whose plain version is
//      intersect.py::hit_from_raw), so a closest-hit call is two launches,
//      the order kernel and this one, with no scratch to reset:
//        - one slice: the thread block owns its rays and writes them;
//        - more slices, the last arriver: each slice takes the minimum
//          into a key scratch with one 64-bit atomicMin per ray and then
//          a ticket on its group's arrival counter (one release-acquire
//          atomic); the slice that arrives last exchanges the keys back to
//          all-ones, resets the counter and writes the Hit, so the scratch
//          is clean after every launch.
//      Every thread block arrives, those of dead groups and empty slices
//      too. A merge in a thread block cluster (each slice's keys in
//      shared memory, rank 0 reading its peers') ran 1.5-2.5x slower on
//      the H100 at 8 slices: a cluster's finished slices hold their SMs
//      until its slowest ends. The epilogue adds 2-3 % to the sweep's
//      device time, and takes from each call a memset, a second kernel
//      and four elementwise ops that mapped its outputs (PERF.md).
//   4. Each group walks the blocks near to far (the order table, made on
//      the card by closest_hit_order below), so the first wall's best_t
//      slab-culls the blocks behind it. The table is (groups x nblocks)
//      int32.
//   5. A thread block stages one 128-row triangle tile at a time in shared
//      memory (float4 loads, rows padded to 20 floats so that the 4 rows a
//      ray's threads read at once fall in distinct banks); a tile that no
//      ray of the block needs is neither loaded nor tested
//      (__syncthreads_or). Each thread takes its rows four at a time: their
//      n.o and n.d forms are independent chains, and the divide and the
//      rest of the test run only for rows that pass divide_may_accept, an
//      exact pre-test that never rejects a pair the full test accepts.
//   6. Executed pair tests (kTile per block a ray takes part in, per slice)
//      are counted per ray. The epilogue adds them by row kind into a
//      (8,) accumulator, the sweep's row ranges (at most kRanges, each
//      with its kind) given as an argument: a warp sums each kind's rows
//      (redux.sync) and adds the sum with one atomicAdd per kind. Slice 0
//      adds the rows that entered live (t_max > 0) by kind after them, in
//      the same way. Where the caller asks for per-ray counts, they are
//      added with one atomicAdd per ray and slice.
//
// Arithmetic is written operation for operation as closest_hit_plain does
// it, the file is built with --fmad=false (no FMA contraction) and IEEE
// division, so the kernel's Hit and counters equal hit_from_raw of the
// plain version's (best_t, best_i) and its counters bit for bit on the
// same schedule.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRays = 32;         // rays per thread block (SWEEP_RAYS)
constexpr int kSplit = 4;         // threads per ray: each takes every 4th row
constexpr int kThreads = kRays * kSplit;
constexpr int kTile = 128;        // triangle rows per tile (SWEEP_BLOCK)
constexpr int kRowFloats = 16;    // packed row width
// floats per row in shared memory: with 20, the rows that the 4 threads
// of a ray read at once fall in distinct banks
constexpr int kStride = 20;
constexpr int kUnroll = 4;        // rows per thread and step of the row loop
// thread blocks of the sweep per SM: holds it to 56 registers a thread,
// what the row loop needs without spilling (64 would allow only 8)
constexpr int kSweepBlocksPerSm = 9;
constexpr float kEps = 1e-4f;     // rayverb_tpu_torch.constants.EPSILON
constexpr float kSlack = 1.0f + 0x1p-20f;
// groups (warps) of an order thread block, at most
constexpr int kOrderWarpsMax = 8;
// row kinds of the executed-pair accumulator, and row ranges of a sweep
constexpr int kKinds = 4;
constexpr int kRanges = 3;

// rows [start[r], end[r]) of a sweep count as kind[r] (-1: no range)
struct KindRanges {
  int start[kRanges];
  int end[kRanges];
  int kind[kRanges];
};

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

// False only when the full test must reject the pair: t = -ow/dw can be
// > EPSILON only for nonzero ow and dw of opposite signs (NaN fails, as it
// fails the full test), and |ow| > best_t*|dw|*(1 + 2^-20) proves
// fl(-ow/dw) > best_t: the two roundings of the product lose at most
// 2^-23 relative, so the exact quotient exceeds best_t*(1 + 2^-21), beyond
// the next float after best_t. That holds while best_t*|dw| is normal,
// which it is whenever a pair can be accepted (|dw| >= EPSILON and best_t
// >= t > EPSILON); an infinite or NaN product (best_t = inf) compares
// false and leaves the pair to the full test. A PyTorch twin of this test
// is held to that property in tests/test_torch_sweep_schedule.py.
__device__ __forceinline__ bool divide_may_accept(float ow, float dw,
                                                  float bt) {
  const bool opposite = (ow > 0.f && dw < 0.f) || (ow < 0.f && dw > 0.f);
  const bool beyond = fabsf(ow) > bt * fabsf(dw) * kSlack;
  return fabsf(dw) >= kEps && opposite && !beyond;
}

__device__ __forceinline__ unsigned long long pack_key(float t, int i) {
  return ((unsigned long long)__float_as_uint(t) << 32) | (unsigned int)i;
}

// The ray's bound: +inf where the caller gave no t_max.
__device__ __forceinline__ float ray_bound(const float* __restrict__ t_max,
                                           int ray) {
  return t_max != nullptr ? t_max[ray] : INFINITY;
}

// One arrival on a group's counter: returns the count before it. Release
// and acquire at device scope: the thread block's atomicMins, ordered
// before this by the barrier before it, are performed before the ticket
// is taken, and the slice that draws the last ticket sees every other
// slice's (the barrier after it hands that on to its other threads).
__device__ __forceinline__ unsigned int take_ticket(unsigned int* counter) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(counter), "r"(1u)
               : "memory");
  return old;
}

// The Hit of one ray from its slices' merged key and the seed (t_max,
// 0xFFFFFFFF): intersect.py::hit_from_raw of unpack_keys(min(key, seed)).
__device__ __forceinline__ void write_hit(unsigned long long key,
                                          float bound, int ray,
                                          float* __restrict__ hit_t,
                                          long long* __restrict__ hit_index,
                                          bool* __restrict__ hit_found) {
  key = min(key, pack_key(bound, -1));
  const unsigned int lo = (unsigned int)key;
  const int bi = lo == 0xFFFFFFFFu ? -1 : (int)lo;
  const bool found = bi >= 0;
  hit_t[ray] = found ? __uint_as_float((unsigned int)(key >> 32)) : INFINITY;
  hit_index[ray] = found ? (long long)bi : 0;
  hit_found[ray] = found;
}

__global__ void __launch_bounds__(kThreads, kSweepBlocksPerSm)
closest_hit_sweep(const float* __restrict__ origins,
                  const float* __restrict__ dirs,
                  const float* __restrict__ t_max,
                  const float* __restrict__ t_decide,
                  const float4* __restrict__ packed,
                  const float* __restrict__ aabb,
                  const int* __restrict__ order, int m, int nblocks,
                  int slices, unsigned long long* __restrict__ keys,
                  unsigned int* __restrict__ arrivals,
                  unsigned long long* __restrict__ executed,
                  unsigned long long* __restrict__ kind_sums,
                  const KindRanges ranges,
                  float* __restrict__ hit_t,
                  long long* __restrict__ hit_index,
                  bool* __restrict__ hit_found) {
  __shared__ float4 tile[kTile * kStride / 4];

  const int group = blockIdx.x;
  const int slice = blockIdx.y;
  // lanes 4r .. 4r+3 of a warp hold one ray, each its own rows of a tile
  const int part = threadIdx.x % kSplit;
  const int ray = group * kRays + threadIdx.x / kSplit;
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
    bt = ray_bound(t_max, ray);
    decide = t_decide != nullptr ? t_decide[ray] : 0.f;
  }
  const float ivx = 1.0f / dx;
  const float ivy = 1.0f / dy;
  const float ivz = 1.0f / dz;
  const bool live = in_range && (bt > 0.f);
  int bi = -1;
  unsigned long long count = 0;

  // positions [first, end) of this slice in the group's order row (the
  // plain version's slice_bounds)
  const int first = slice * nblocks / slices;
  const int end = (slice + 1) * nblocks / slices;
  const int* row_order = order + (size_t)group * nblocks;

  for (int p = first; p < end; ++p) {
    const int b = row_order[p];
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
      tile[(i / 4) * (kStride / 4) + i % 4] = src[i];
    }
    __syncthreads();

    if (need) {
      count += kTile;
      const float* rows = reinterpret_cast<const float*>(tile);
      for (int j = part; j < kTile; j += kSplit * kUnroll) {
        float ow[kUnroll], dw[kUnroll];
        bool maybe[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const float* r = rows + (j + kSplit * k) * kStride;
          ow[k] = r[6] * ox + r[7] * oy + r[8] * oz + r[12];
          dw[k] = r[6] * dx + r[7] * dy + r[8] * dz;
          maybe[k] = divide_may_accept(ow[k], dw[k], bt);
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (!maybe[k]) continue;
          const float* r = rows + (j + kSplit * k) * kStride;
          float ou = r[0] * ox + r[1] * oy + r[2] * oz + r[10];
          float ov = r[3] * ox + r[4] * oy + r[5] * oz + r[11];
          float du = r[0] * dx + r[1] * dy + r[2] * dz;
          float dv = r[3] * dx + r[4] * dy + r[5] * dz;
          // maybe[k] implies |dw| >= EPSILON: not degenerate
          float t = -ow[k] / dw[k];
          float u = ou + t * du;
          float v = ov + t * dv;
          bool valid = (u >= 0.f) && (u <= 1.f) && (v >= 0.f) &&
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
    // the ray's 4 threads merge their bests: each began the tile at the
    // same (bt, bi) and folded its rows by the tie rule, so the minimum
    // key over the 4 is the fold over all 128 rows (bi = -1 packs last)
    unsigned long long key = pack_key(bt, bi);
    key = min(key, __shfl_xor_sync(0xFFFFFFFFu, key, 1));
    key = min(key, __shfl_xor_sync(0xFFFFFFFFu, key, 2));
    bt = __uint_as_float((unsigned int)(key >> 32));
    bi = (int)(unsigned int)key;
  }

  // the epilogue: thread `part` 0 of each ray counts and writes; every
  // thread block reaches it (no early return above)
  const bool writer = part == 0 && in_range;
  if (writer && executed != nullptr && count != 0) {
    atomicAdd(executed + ray, count);
  }
  if (kind_sums != nullptr) {
    // every thread of the warp reaches here; a warp's 8 rays sum below
    // 8 x nblocks x kTile, which 32 bits hold for any table that fits
    // the card
    int kind = -1;
    for (int r = 0; r < kRanges; ++r) {
      if (ray >= ranges.start[r] && ray < ranges.end[r]) kind = ranges.kind[r];
    }
    const unsigned int mine = writer && kind >= 0 ? (unsigned int)count : 0u;
    // a live row counts once, in slice 0
    const unsigned int mine_live = writer && kind >= 0 && live && slice == 0;
    for (int k = 0; k < kKinds; ++k) {
      const unsigned int sum = __reduce_add_sync(0xFFFFFFFFu, kind == k ? mine : 0u);
      const unsigned int rows = __reduce_add_sync(0xFFFFFFFFu, kind == k ? mine_live : 0u);
      if (threadIdx.x % 32 == 0) {
        if (sum != 0) atomicAdd(kind_sums + k, (unsigned long long)sum);
        if (rows != 0) atomicAdd(kind_sums + kKinds + k, (unsigned long long)rows);
      }
    }
  }
  // this slice's key; a slice without a hit leaves all-ones (the seed's
  // minimum then gives the miss). The seed's bound is read again here
  // rather than kept in a register through the loop
  const unsigned long long own = bi >= 0 ? pack_key(bt, bi) : ~0ull;
  if (slices == 1) {
    if (writer) {
      write_hit(own, ray_bound(t_max, ray), ray, hit_t, hit_index, hit_found);
    }
    return;
  }
  __shared__ unsigned int last;
  if (writer && bi >= 0) atomicMin(keys + ray, own);
  __syncthreads();
  if (threadIdx.x == 0) {
    last = take_ticket(arrivals + group) == (unsigned int)(slices - 1);
  }
  __syncthreads();
  if (!last) return;
  if (writer) {
    write_hit(atomicExch(keys + ray, ~0ull), ray_bound(t_max, ray), ray,
              hit_t, hit_index, hit_found);
  }
  if (threadIdx.x == 0) arrivals[group] = 0u;
}

// The near-to-far block order of each group of kRays rays: one warp per
// group, blockDim.x / 32 groups per thread block. Replaces the order table
// that closest_hit_pallas computes with XLA
// (rayverb_tpu/ops/intersect_pallas.py:604-646); its plain version is
// intersect.py::block_order, which this kernel equals bit for bit.
//
// The group's first live ray (t_max > 0; the first row of a dead group)
// ranks every block by where its line enters the block's AABB (0 from
// inside, +inf when it misses), key = rank bits * nblocks + block index,
// and the row is the keys in ascending order. Every key of rank +inf is
// larger than every finite one and those keys order by block index, so
// the row is the k finite-rank keys sorted, then the +inf blocks in
// ascending index. The kernel sorts only those k keys: the blocks the line
// meets, 0-37 of the hall's 1,024 per group and 8-11 on average on the
// north star's batches (chip_smoke.py prints k).
//
// What bounds it on the H100: the (groups x nblocks) int32 row written to
// device memory (128 MB at 1 M rays x 1,024 blocks, 0.040 ms at 3.35
// TB/s), then one slab test per (group, block) (~40 FP32 operations,
// ~0.02 ms at 67 TFLOP/s). What the design does about it:
//   1. One warp per group and no thread-block barrier: the representative
//      is found with a ballot, the warps of a thread block run apart.
//   2. Lane l ranks blocks l, l + 32, ...: the AABBs are read coalesced
//      through the read-only path (24 of their 32 bytes), and the warps of
//      an SM walk them in the same order, so that L1 can serve them.
//   3. The finite keys are compacted by ballot and popc prefix sums into
//      the warp's key buffer; one bit per block (the finite mask) places
//      each +inf block at k + (its index - finite blocks below it), which
//      a second pass writes, coalesced, once k is known.
//   4. k <= 32: a bitonic sort in registers across the warp (shuffles,
//      padded with all-ones keys). Larger k: a bitonic sort of the next
//      power of two in the key buffer, separated by __syncwarp only.
//   5. The key buffer holds nblocks keys in shared memory, so no k
//      overflows it; only a table whose buffer does not fit in shared
//      memory (intersect_cuda.order_launch: past ~28,600 blocks) sorts in
//      a device-memory scratch of (groups, nblocks) keys instead.
// k is data-dependent and never read by the host: each warp takes its own
// path.
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kInfBits = 0x7F800000u;  // float bits of +inf

// 32-bit words of a warp's finite mask, in whole 8-byte units
__host__ __device__ __forceinline__ size_t order_mask_units(int nblocks) {
  return ((size_t)(nblocks + 31) / 32 + 1) / 2;
}

// shared memory of one warp, in 8-byte units: the key buffer (none when
// the keys go to device memory), then the finite mask
__host__ __device__ __forceinline__ size_t order_warp_units(int nblocks,
                                                            bool spill) {
  return (spill ? 0 : (size_t)nblocks) + order_mask_units(nblocks);
}

// ascending bitonic sort of one key per lane
__device__ __forceinline__ unsigned long long warp_sort32(
    unsigned long long v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, v, j);
      // the lower lane of a pair keeps the smaller key in an ascending run
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      v = keep_min ? min(v, other) : max(v, other);
    }
  }
  return v;
}

// ascending bitonic sort of keys[0, p) by one warp, p a power of two >= 64;
// each lane takes pairs q = lane, lane + 32, ... of a stage: i is q with a
// zero bit inserted at j, its partner i | j
__device__ void warp_sort_buffer(unsigned long long* keys, int p, int lane) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = lane; q < p / 2; q += 32) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const unsigned long long a = keys[i];
        const unsigned long long c = keys[i | j];
        if ((a > c) == ((i & k) == 0)) {
          keys[i] = c;
          keys[i | j] = a;
        }
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kOrderWarpsMax * 32)
closest_hit_order(const float* __restrict__ origins,
                  const float* __restrict__ dirs,
                  const float* __restrict__ t_max,
                  const float4* __restrict__ aabb, int m, int nblocks,
                  int* __restrict__ order, unsigned long long* spill) {
  extern __shared__ unsigned long long order_smem[];
  const int lane = threadIdx.x & 31;
  const int group = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (group >= (m + kRays - 1) / kRays) return;  // whole warps
  const unsigned below = (1u << lane) - 1u;  // lanes under this one
  const int words = (nblocks + 31) / 32;
  unsigned long long* own =
      order_smem +
      (threadIdx.x >> 5) * order_warp_units(nblocks, spill != nullptr);
  unsigned long long* keys =
      spill != nullptr ? spill + (size_t)group * nblocks : own;
  unsigned* finite_mask = reinterpret_cast<unsigned*>(
      own + (spill != nullptr ? 0 : nblocks));

  const int ray = group * kRays + lane;
  const unsigned live = __ballot_sync(
      kFull, ray < m && (t_max == nullptr || t_max[ray] > 0.f));
  const int rep =
      min(group * kRays + (live != 0u ? __ffs(live) - 1 : 0), m - 1);
  const float ox = origins[3 * rep + 0];
  const float oy = origins[3 * rep + 1];
  const float oz = origins[3 * rep + 2];
  const float dx = dirs[3 * rep + 0];
  const float dy = dirs[3 * rep + 1];
  const float dz = dirs[3 * rep + 2];
  const float ivx = 1.0f / dx;
  const float ivy = 1.0f / dy;
  const float ivz = 1.0f / dz;

  // pass 1: rank, compact the finite keys, keep the finite mask
  unsigned k = 0;
#pragma unroll 4
  for (int w = 0; w < words; ++w) {
    const int b = 32 * w + lane;
    unsigned bits = kInfBits;
    if (b < nblocks) {
      // box = (lo x, lo y, lo z, hi x | hi y, hi z, pad, pad)
      const float4 a = __ldg(aabb + 2 * b);
      const float2 c =
          __ldg(reinterpret_cast<const float2*>(aabb + 2 * b + 1));
      float tnx, tfx, tny, tfy, tnz, tfz;
      slab_axis(ox, dx, ivx, a.x, a.w, tnx, tfx);
      slab_axis(oy, dy, ivy, a.y, c.x, tny, tfy);
      slab_axis(oz, dz, ivz, a.z, c.y, tnz, tfz);
      const float tn = fmaxf(fmaxf(tnx, tny), tnz);
      const float tf = fminf(fminf(tfx, tfy), tfz);
      const float rank = (tf >= fmaxf(tn, kEps)) ? fmaxf(tn, 0.f) : INFINITY;
      // non-negative float bits order as the floats do (& clears -0.0's sign)
      bits = __float_as_uint(rank) & 0x7FFFFFFFu;
    }
    // partition on the bits: a met block whose rank overflowed to +inf
    // ties with the misses and goes by index, as the full sort puts it
    const bool finite = bits != kInfBits;
    const unsigned ballot = __ballot_sync(kFull, finite);
    if (finite) {
      keys[k + __popc(ballot & below)] =
          (unsigned long long)bits * (unsigned)nblocks + (unsigned)b;
    }
    if (lane == 0) finite_mask[w] = ballot;
    k += __popc(ballot);
  }
  __syncwarp();

  // pass 2: the +inf blocks in ascending index after the k finite ones
  int* row = order + (size_t)group * nblocks;
  unsigned finite_below = 0;  // finite blocks in the words before w
  for (int w = 0; w < words; ++w) {
    const unsigned ballot = finite_mask[w];
    const int b = 32 * w + lane;
    if (b < nblocks && ((ballot >> lane) & 1u) == 0u) {
      row[k + b - (finite_below + __popc(ballot & below))] = b;
    }
    finite_below += __popc(ballot);
  }

  // the k finite keys, sorted; key % nblocks is the block (a power of two)
  const unsigned long long index_mask = (unsigned long long)(nblocks - 1);
  if (k == 0) return;
  if (k <= 32) {
    unsigned long long v = lane < (int)k ? keys[lane] : ~0ull;
    v = warp_sort32(v, lane);
    if (lane < (int)k) row[lane] = (int)(v & index_mask);
    return;
  }
  int p = 64;
  while (p < (int)k) p <<= 1;  // <= nblocks: the buffer holds it
  for (int i = (int)k + lane; i < p; i += 32) keys[i] = ~0ull;
  __syncwarp();
  warp_sort_buffer(keys, p, lane);
  for (int i = lane; i < (int)k; i += 32) {
    row[i] = (int)(keys[i] & index_mask);
  }
}

}  // namespace

// C interface for ctypes: the near-to-far block order of each group of 32
// rays (closest_hit_order). origins and dirs (m, 3), t_max (m,) or null
// (every ray live), aabb
// (nblocks, 8) float32 (16-byte aligned), order (ceil(m / 32), nblocks)
// int32; nblocks a power of two. `warps` groups per thread block and
// `smem` bytes of dynamic shared memory, as intersect_cuda.order_launch
// chooses them; spill is null, and each warp sorts its keys in shared
// memory, or (ceil(m / 32), nblocks) 64-bit scratch in device memory for
// tables whose keys do not fit there. Returns cudaErrorInvalidValue
// unless smem is warps x one warp's layout, else enqueues on `stream` and
// returns the first CUDA error of the enqueue (0 if none).
extern "C" int rv_block_order(const void* origins, const void* dirs,
                              const void* t_max, const void* aabb, int m,
                              int nblocks, int warps, int smem, void* order,
                              void* spill, void* stream) {
  if (m <= 0) return 0;
  if (nblocks <= 0 || (nblocks & (nblocks - 1)) != 0 || warps < 1 ||
      warps > kOrderWarpsMax || smem < 0 ||
      (size_t)smem != 8 * (size_t)warps *
                          order_warp_units(nblocks, spill != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        closest_hit_order, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = (m + kRays - 1) / kRays;
  closest_hit_order<<<(groups + warps - 1) / warps, warps * 32, smem,
                      (cudaStream_t)stream>>>(
      (const float*)origins, (const float*)dirs, (const float*)t_max,
      (const float4*)aabb, m, nblocks, (int*)order,
      (unsigned long long*)spill);
  return (int)cudaGetLastError();
}

// C interface for ctypes. All pointers are device pointers of contiguous
// arrays: origins and dirs (m, 3) float32; t_max and t_decide (m,)
// float32, or null (+inf and 0 for every ray); packed (nblocks * 128, 16)
// float32, aabb (nblocks, 8) float32, order (ceil(m / 32), nblocks)
// int32; keys (m,) 64-bit all-ones and arrivals (ceil(m / 32),) 32-bit
// zeros, the merge's scratch for slices > 1, which the launch leaves as
// it found them (null for one slice); executed (m,) int64 added to (or
// null: no per-ray counters); kind_sums (8,) int64, the executed pair
// tests and then the live rows, added to by row kind (or null: no such
// counters) over the row ranges `ranges`, a host array
// of kRanges (start, end, kind) triples (kind -1: unused; null: none);
// the Hit: hit_t (m,) float32, hit_index (m,) int64, hit_found (m,)
// bool. Returns cudaErrorInvalidValue without the scratch where slices >
// 1 or for a kind outside [0, 4), else enqueues one launch on `stream`
// and returns the first CUDA error of the enqueue (0 if none).
extern "C" int rv_closest_hit(const void* origins, const void* dirs,
                              const void* t_max, const void* t_decide,
                              const void* packed, const void* aabb,
                              const void* order, int m, int nblocks,
                              int slices, void* keys, void* arrivals,
                              void* executed, void* kind_sums,
                              const int* ranges, void* hit_t,
                              void* hit_index, void* hit_found,
                              void* stream) {
  if (m <= 0) return 0;
  if (slices < 1 || slices > nblocks ||
      (slices > 1 && (keys == nullptr || arrivals == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  KindRanges kr;
  for (int r = 0; r < kRanges; ++r) {
    kr.start[r] = ranges != nullptr ? ranges[3 * r] : 0;
    kr.end[r] = ranges != nullptr ? ranges[3 * r + 1] : 0;
    kr.kind[r] = ranges != nullptr ? ranges[3 * r + 2] : -1;
    if (kr.kind[r] >= kKinds) return (int)cudaErrorInvalidValue;
  }
  dim3 grid((m + kRays - 1) / kRays, slices);
  closest_hit_sweep<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)origins, (const float*)dirs, (const float*)t_max,
      (const float*)t_decide, (const float4*)packed, (const float*)aabb,
      (const int*)order, m, nblocks, slices, (unsigned long long*)keys,
      (unsigned int*)arrivals, (unsigned long long*)executed,
      (unsigned long long*)kind_sums, kr, (float*)hit_t,
      (long long*)hit_index, (bool*)hit_found);
  return (int)cudaGetLastError();
}
