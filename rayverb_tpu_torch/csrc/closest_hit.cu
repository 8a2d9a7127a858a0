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
// kRays rays walks its own row of `order` (near to far and culled:
// closest_hit_order, whose plain versions are intersect.py::block_order,
// block_keep and cull_order), cut into `slices` contiguous runs, of each
// of which it walks the first counts[group][slice] entries.
//
// What bounds it on the H100: instruction issue. The walk takes only the
// entries the order kernel kept (design point 4), each a box test by the
// group's 128 threads and a block barrier, so the pair tests and tile
// loads are most of the work; a pair test is ~40 FP32
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
//      slab-culls the blocks behind it. The order kernel also culls: it
//      keeps only the blocks that some ray of the group can need at its
//      bound, puts them first in each slice's run, and counts them
//      (groups x slices int32). A slice walks only those, so the blocks no
//      ray can reach cost neither a box test nor a barrier; on the north
//      star's hall a group needed a few percent of its 1,024 blocks.
//   5. A thread block stages one 128-row triangle tile at a time in shared
//      memory (float4 loads, rows padded to 20 floats so that the 4 rows a
//      ray's threads read at once fall in distinct banks); a kept block
//      that no ray of the thread block needs at its running best is
//      neither loaded nor tested (__syncthreads_or). Each thread takes its
//      rows four at a time: their n.o and n.d forms are independent
//      chains, and the divide and the rest of the test run only for rows
//      that pass divide_may_accept, an exact pre-test that never rejects
//      a pair the full test accepts.
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
// blocks per superblock of the order kernel's cull (a warp's lanes)
constexpr int kSuperBlocks = 32;
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
// A ray's line: origin, direction and the direction's reciprocals.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origins,
                                        const float* __restrict__ dirs,
                                        int ray) {
  Ray r;
  r.ox = origins[3 * ray + 0];
  r.oy = origins[3 * ray + 1];
  r.oz = origins[3 * ray + 2];
  r.dx = dirs[3 * ray + 0];
  r.dy = dirs[3 * ray + 1];
  r.dz = dirs[3 * ray + 2];
  r.ivx = 1.0f / r.dx;
  r.ivy = 1.0f / r.dy;
  r.ivz = 1.0f / r.dz;
  return r;
}

// The sweep's entry test of a ray against the box [lo, hi]: its segment
// [EPSILON, bt] meets the box (slab test).
__device__ __forceinline__ bool box_need(const Ray& r, float lx, float ly,
                                         float lz, float hx, float hy,
                                         float hz, float bt) {
  float tnx, tfx, tny, tfy, tnz, tfz;
  slab_axis(r.ox, r.dx, r.ivx, lx, hx, tnx, tfx);
  slab_axis(r.oy, r.dy, r.ivy, ly, hy, tny, tfy);
  slab_axis(r.oz, r.dz, r.ivz, lz, hz, tnz, tfz);
  const float tn = fmaxf(fmaxf(tnx, tny), tnz);
  const float tf = fminf(fminf(tfx, tfy), tfz);
  return (tf >= fmaxf(tn, kEps)) && (tn <= bt);
}

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
                  const int* __restrict__ order,
                  const int* __restrict__ counts, int m, int nblocks,
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

  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, INFINITY, INFINITY, INFINITY};
  float bt = 0.f, decide = 0.f;
  if (in_range) {
    r = load_ray(origins, dirs, ray);
    bt = ray_bound(t_max, ray);
    decide = t_decide != nullptr ? t_decide[ray] : 0.f;
  }
  const float ox = r.ox, oy = r.oy, oz = r.oz;
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  const bool live = in_range && (bt > 0.f);
  int bi = -1;
  unsigned long long count = 0;

  // this slice's run of the group's order row starts at `first` (the
  // plain version's slice_bounds); the walk takes its kept entries, which
  // the order kernel put first
  const int first = slice * nblocks / slices;
  const int end = first + counts[(size_t)group * slices + slice];
  const int* row_order = order + (size_t)group * nblocks;

  for (int p = first; p < end; ++p) {
    const int b = row_order[p];
    bool need = false;
    if (live && bt >= decide) {
      const float* box = aabb + 8 * b;
      need = box_need(r, box[0], box[1], box[2], box[3], box[4], box[5], bt);
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

// The near-to-far block order of each group of kRays rays, and its cull:
// one warp per group, blockDim.x / 32 groups per thread block. Replaces
// the order table that closest_hit_pallas computes with XLA
// (rayverb_tpu/ops/intersect_pallas.py:604-646); its plain versions are
// intersect.py::block_order (the order) and block_keep with cull_order
// (the cull), which this kernel equals bit for bit.
//
// The order: the group's first live ray (t_max > 0; the first row of a
// dead group) ranks every block by where its line enters the block's AABB
// (0 from inside, +inf when it misses), key = rank bits * nblocks + block
// index, and the order is the keys in ascending order. Every key of rank
// +inf is larger than every finite one and those keys order by block
// index, so the order is the k finite-rank keys sorted, then the +inf
// blocks in ascending index. The kernel sorts only those k keys: the
// blocks the line meets, 0-37 of the hall's 1,024 per group and 8-11 on
// average on the north star's batches (chip_smoke.py prints k).
//
// The cull: a block is kept when some ray of the group passes the sweep's
// entry test on it at the ray's bound (live, bound >= t_decide, box_need
// at bt = bound). A ray's running best only falls from its bound, so a
// block that no ray passes there is never swept, by any slice at any
// position. Each slice's run [f, e) of the order is written with its kept
// blocks first and then the others, each in the order's order, and counts
// (groups x slices) says how many are kept: the sweep walks only those, in
// the order the whole run has them, so every ray executes the same tiles
// as on the whole run.
//
// What bounds it on the H100: the cull's box tests. Without a coarser
// level they would be 32 x nblocks per group (~1 G at 1 M rays x 1,024
// blocks, ~50 instructions each: ~60 ms a north-star IR at the card's
// issue rate). With superblocks of 32 blocks (intersect.py::super_aabb,
// boxes that hold their blocks' boxes, built once with the sweep table)
// it is nblocks / 32 superblock tests per ray, then one fine test per
// block of a superblock and ray that met it. Then the (groups x nblocks)
// int32 order written to device memory (128 MB at 1 M rays x 1,024
// blocks, 0.040 ms at 3.35 TB/s). What the design does about it:
//   1. One warp per group and no thread-block barrier: the representative
//      is found with a ballot, the warps of a thread block run apart.
//   2. Lane l ranks blocks l, l + 32, ...: the AABBs are read coalesced
//      through the read-only path (24 of their 32 bytes), and the warps of
//      an SM walk them in the same order, so that L1 can serve them.
//   3. The finite keys are compacted by ballot and popc prefix sums into
//      the warp's key buffer; one bit per block (the finite mask) places
//      each +inf block at k + (its index - finite blocks below it) once k
//      is known.
//   4. k <= 32: a bitonic sort in registers across the warp (shuffles,
//      padded with all-ones keys). Larger k: a bitonic sort of the next
//      power of two in the key buffer, separated by __syncwarp only. The
//      sorted blocks, then the +inf ones, are written as int32 over the
//      key buffer's first bytes, which then holds the order.
//   5. The cull: lane l holds ray l. A ballot per superblock gives the
//      rays whose segment meets its box; where there are any, lane l
//      tests block 32 s + l against each of them in turn (the ray
//      shuffled in), and a ballot gives the superblock's word of kept
//      blocks, written over the finite mask. A superblock's box holds its
//      blocks' boxes, and rounding is monotone in (lo - o) * iv, fminf and
//      fmaxf are monotone and the |d| < 1e-30 branch depends on the
//      origin's side of the box alone, so a ray that passes a block's test
//      passes its superblock's: the coarse level rejects nothing that the
//      fine test keeps (tests/test_torch_sweep_schedule.py holds a
//      PyTorch twin to that).
//   6. Each slice's run is written in two passes over it: a ballot count
//      of its kept blocks, then each block at its place by ballot prefix
//      sums, coalesced.
//   7. The key buffer holds nblocks keys in shared memory, so no k
//      overflows it; only a table whose buffer does not fit in shared
//      memory (intersect_cuda.order_launch: past ~28,600 blocks) sorts in
//      a device-memory scratch of (groups, nblocks) keys instead.
// k and the kept blocks are data-dependent and never read by the host:
// each warp takes its own path. A stats call adds the kept entries and
// groups x nblocks into two 64-bit counters (one atomicAdd each a group).
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

// ray `src`'s line and bound, from the lane that holds them
__device__ __forceinline__ Ray shfl_ray(const Ray& r, int src) {
  Ray q;
  q.ox = __shfl_sync(kFull, r.ox, src);
  q.oy = __shfl_sync(kFull, r.oy, src);
  q.oz = __shfl_sync(kFull, r.oz, src);
  q.dx = __shfl_sync(kFull, r.dx, src);
  q.dy = __shfl_sync(kFull, r.dy, src);
  q.dz = __shfl_sync(kFull, r.dz, src);
  q.ivx = __shfl_sync(kFull, r.ivx, src);
  q.ivy = __shfl_sync(kFull, r.ivy, src);
  q.ivz = __shfl_sync(kFull, r.ivz, src);
  return q;
}

// box_need against box b of a (lo x, lo y, lo z, hi x | hi y, hi z, pad,
// pad) table, read through the read-only path
__device__ __forceinline__ bool table_need(const Ray& r,
                                           const float4* __restrict__ boxes,
                                           int b, float bt) {
  const float4 a = __ldg(boxes + 2 * b);
  const float2 c = __ldg(reinterpret_cast<const float2*>(boxes + 2 * b + 1));
  return box_need(r, a.x, a.y, a.z, a.w, c.x, c.y, bt);
}

__global__ void __launch_bounds__(kOrderWarpsMax * 32)
closest_hit_order(const float* __restrict__ origins,
                  const float* __restrict__ dirs,
                  const float* __restrict__ t_max,
                  const float* __restrict__ t_decide,
                  const float4* __restrict__ aabb,
                  const float4* __restrict__ super_aabb, int m, int nblocks,
                  int slices, int* __restrict__ order,
                  int* __restrict__ counts,
                  unsigned long long* __restrict__ entry_sums,
                  unsigned long long* spill) {
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

  // the k finite keys, sorted, as blocks at rowbuf[0, k): the key
  // buffer's first bytes hold the row; key % nblocks is the block (a
  // power of two)
  int* rowbuf = reinterpret_cast<int*>(keys);
  const unsigned long long index_mask = (unsigned long long)(nblocks - 1);
  if (k > 0 && k <= 32) {
    unsigned long long v = lane < (int)k ? keys[lane] : ~0ull;
    v = warp_sort32(v, lane);
    __syncwarp();  // every lane has read its key
    if (lane < (int)k) rowbuf[lane] = (int)(v & index_mask);
  } else if (k > 32) {
    int p = 64;
    while (p < (int)k) p <<= 1;  // <= nblocks: the buffer holds it
    for (int i = (int)k + lane; i < p; i += 32) keys[i] = ~0ull;
    __syncwarp();
    warp_sort_buffer(keys, p, lane);
    // in place, 32 at a time: the ints of positions [i0, i0 + 32) overlay
    // keys [i0 / 2, i0 / 2 + 16), which this step or an earlier one read
    for (int i0 = 0; i0 < (int)k; i0 += 32) {
      const int i = i0 + lane;
      const int blk = i < (int)k ? (int)(keys[i] & index_mask) : 0;
      __syncwarp();
      if (i < (int)k) rowbuf[i] = blk;
      __syncwarp();
    }
  }
  __syncwarp();

  // pass 2: the +inf blocks in ascending index after the k finite ones
  unsigned finite_below = 0;  // finite blocks in the words before w
  for (int w = 0; w < words; ++w) {
    const unsigned ballot = finite_mask[w];
    const int b = 32 * w + lane;
    if (b < nblocks && ((ballot >> lane) & 1u) == 0u) {
      rowbuf[k + b - (finite_below + __popc(ballot & below))] = b;
    }
    finite_below += __popc(ballot);
  }
  __syncwarp();

  // the cull: keep[w] (over the finite mask) marks the blocks that some
  // ray of the group needs at its bound; lane l holds ray l, and blocks of
  // `per` go to the fine test only where a ray meets their superblock's
  // box, which holds each of theirs
  unsigned* keep = finite_mask;
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, INFINITY, INFINITY, INFINITY};
  float bound = 0.f;
  bool cand = false;
  if (ray < m) {
    r = load_ray(origins, dirs, ray);
    bound = ray_bound(t_max, ray);
    const float decide = t_decide != nullptr ? t_decide[ray] : 0.f;
    cand = bound > 0.f && bound >= decide;
  }
  const int per = min(nblocks, kSuperBlocks);
  for (int s = 0; s < nblocks / per; ++s) {
    unsigned rays =
        __ballot_sync(kFull, cand && table_need(r, super_aabb, s, bound));
    unsigned word = 0u;
    if (rays != 0u) {
      // lane l tests block s * per + l against each ray that met the
      // superblock
      const bool have = lane < per;
      const int b = s * per + (have ? lane : 0);
      bool mark = false;
      do {
        const int src = __ffs(rays) - 1;
        rays &= rays - 1u;
        const Ray q = shfl_ray(r, src);
        const float qb = __shfl_sync(kFull, bound, src);
        mark = mark || table_need(q, aabb, b, qb);
      } while (rays != 0u);
      word = __ballot_sync(kFull, have && mark);
    }
    if (lane == 0) keep[s] = word;
  }
  __syncwarp();

  // the row: each slice's run [f, e) of the order, its kept blocks first
  // and then the rest, each in the order's order
  int* row = order + (size_t)group * nblocks;
  unsigned long long kept_all = 0;
  for (int s = 0; s < slices; ++s) {
    const int f = s * nblocks / slices;
    const int e = (s + 1) * nblocks / slices;
    int total = 0;
    for (int p0 = f; p0 < e; p0 += 32) {
      const int b = p0 + lane < e ? rowbuf[p0 + lane] : 0;
      total += __popc(__ballot_sync(
          kFull, p0 + lane < e && ((keep[b >> 5] >> (b & 31)) & 1u)));
    }
    int kept = 0, rest = 0;
    for (int p0 = f; p0 < e; p0 += 32) {
      const bool valid = p0 + lane < e;
      const int b = valid ? rowbuf[p0 + lane] : 0;
      const bool mine = valid && ((keep[b >> 5] >> (b & 31)) & 1u);
      const unsigned kb = __ballot_sync(kFull, mine);
      const unsigned rb = __ballot_sync(kFull, valid && !mine);
      if (mine) {
        row[f + kept + __popc(kb & below)] = b;
      } else if (valid) {
        row[f + total + rest + __popc(rb & below)] = b;
      }
      kept += __popc(kb);
      rest += __popc(rb);
    }
    if (lane == 0) counts[(size_t)group * slices + s] = total;
    kept_all += (unsigned)total;
  }
  if (entry_sums != nullptr && lane == 0) {
    atomicAdd(entry_sums, kept_all);
    atomicAdd(entry_sums + 1, (unsigned long long)nblocks);
  }
}

}  // namespace

// C interface for ctypes: the near-to-far block order of each group of 32
// rays and its cull (closest_hit_order). origins and dirs (m, 3), t_max
// and t_decide (m,) or null (+inf and 0 for every ray), aabb (nblocks, 8)
// and super_aabb (max(1, nblocks / 32), 8), each superblock's box, float32
// (16-byte aligned); nblocks a power of two. Writes order (ceil(m / 32),
// nblocks) int32, block_order's row with each of `slices` runs culled (its
// kept blocks first), and counts (ceil(m / 32), slices) int32, the kept
// blocks of each run; entry_sums, where not null, two int64 counters added
// to: the kept entries and groups x nblocks. `warps` groups per thread block
// and `smem` bytes of dynamic shared memory, as intersect_cuda.order_launch
// chooses them; spill is null, and each warp sorts its keys in shared
// memory, or (ceil(m / 32), nblocks) 64-bit scratch in device memory for
// tables whose keys do not fit there. Returns cudaErrorInvalidValue
// unless smem is warps x one warp's layout, without super_aabb, order or
// counts, or for slices outside [1, nblocks]; else enqueues on `stream` and returns the first CUDA error of the
// enqueue (0 if none).
extern "C" int rv_block_order(const void* origins, const void* dirs,
                              const void* t_max, const void* t_decide,
                              const void* aabb, const void* super_aabb,
                              int m, int nblocks, int slices, int warps,
                              int smem, void* order, void* counts,
                              void* entry_sums, void* spill, void* stream) {
  if (m <= 0) return 0;
  if (nblocks <= 0 || (nblocks & (nblocks - 1)) != 0 || warps < 1 ||
      warps > kOrderWarpsMax || smem < 0 ||
      (size_t)smem != 8 * (size_t)warps *
                          order_warp_units(nblocks, spill != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (super_aabb == nullptr || order == nullptr || counts == nullptr ||
      slices < 1 || slices > nblocks) {
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
      (const float*)t_decide, (const float4*)aabb, (const float4*)super_aabb,
      m, nblocks, slices, (int*)order, (int*)counts,
      (unsigned long long*)entry_sums, (unsigned long long*)spill);
  return (int)cudaGetLastError();
}

// C interface for ctypes. All pointers are device pointers of contiguous
// arrays: origins and dirs (m, 3) float32; t_max and t_decide (m,)
// float32, or null (+inf and 0 for every ray); packed (nblocks * 128, 16)
// float32, aabb (nblocks, 8) float32, order (ceil(m / 32), nblocks)
// int32, counts (ceil(m / 32), slices) int32, the entries each slice
// walks from the start of its run; keys (m,) 64-bit
// all-ones and arrivals (ceil(m / 32),) 32-bit
// zeros, the merge's scratch for slices > 1, which the launch leaves as
// it found them (null for one slice); executed (m,) int64 added to (or
// null: no per-ray counters); kind_sums (8,) int64, the executed pair
// tests and then the live rows, added to by row kind (or null: no such
// counters) over the row ranges `ranges`, a host array
// of kRanges (start, end, kind) triples (kind -1: unused; null: none);
// the Hit: hit_t (m,) float32, hit_index (m,) int64, hit_found (m,)
// bool. Returns cudaErrorInvalidValue without counts, without the scratch
// where slices > 1 or for a kind outside [0, 4), else enqueues one launch on `stream`
// and returns the first CUDA error of the enqueue (0 if none).
extern "C" int rv_closest_hit(const void* origins, const void* dirs,
                              const void* t_max, const void* t_decide,
                              const void* packed, const void* aabb,
                              const void* order, const void* counts,
                              int m, int nblocks, int slices, void* keys,
                              void* arrivals,
                              void* executed, void* kind_sums,
                              const int* ranges, void* hit_t,
                              void* hit_index, void* hit_found,
                              void* stream) {
  if (m <= 0) return 0;
  if (counts == nullptr || slices < 1 || slices > nblocks ||
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
      (const int*)order, (const int*)counts, m, nblocks, slices,
      (unsigned long long*)keys,
      (unsigned int*)arrivals, (unsigned long long*)executed,
      (unsigned long long*)kind_sums, kr, (float*)hit_t,
      (long long*)hit_index, (bool*)hit_found);
  return (int)cudaGetLastError();
}
