// Chunked biquad scan for Hopper (sm_90a).
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
// [0, n) in order, or from n - 1 down to 0 when `reverse`, n = content
// (or contents[s], an (series,) int32 device array of per-series lengths:
// one launch covers every pair of a batched finalize); samples at and
// after n are written as +0. y must not overlap x.
//
// The schedule, a chunked parallel recurrence (the plain version repeats
// it operation for operation). The pass-order samples of a series are cut
// into chunks of kChunk, counted from the pass's first sample (sample 0,
// or n - 1 in reverse), and the chunks into tiles of kLanes. Since the
// recurrence is linear in its state, the state after a chunk from start S
// is P S plus the chunk's end state from zero, P = A^kChunk, A = [[-a1, 1],
// [-a2, 0]] the state's map over one sample of zero input.
//   A. each chunk runs from zero state to its end state e_c;
//   B. the carry: a tile's aggregate E_j is the chain T <- P T + e_c over
//      its chunks from 0; a tile's start is the chain S <- Q S + E_i from
//      0 over the tiles before it (Q = A^(kChunk * kLanes)); a chunk's
//      start is the chain U <- P U + e_c from its tile's start over the
//      chunks before it in the tile;
//   C. each chunk runs again from its start and writes its outputs.
// P and Q come from float64 repeated squaring with no FMA
// (transitions()), and the carry runs in float64: for the lowest band's
// poles the entries of P are ~100x the state they carry and their products
// cancel, so a float32 carry was 2.5x less accurate against float64
// lfilter than the sequential scan on the vault's bank; in float64 its
// error is 0.996x the sequential scan's (the same arithmetic without the
// chunks) at 65,536 samples (tests/test_torch_filters.py), and 0.86x the
// earlier sequential kernel's at 524,288 on the card (PERF.md). A chunk's
// start is rounded to float32 once. Chunk 0 starts from exact zeros, so it
// is the sequential pass.
//
// What bounds it on the H100: bytes, once the schedule is parallel. One
// pass reads and writes 8 bytes a sample (15.6 MB at the modular vault's
// 16 x 122,248: 4.7 us at 3.35 TB/s); each lane's own chain is 2 x kChunk
// steps of ~12 dependent cycles (a multiply, an add and a subtract from
// one output to the next), ~3 us at 1.98 GHz, plus 2 x 32 float64 carry
// steps through the warp and one per tile before it. Tensor cores have no
// role: the recurrence is a chain of 2 x 2 updates.
//
// What the design does about it: one warp lane per chunk, one warp per
// tile and per thread block, S x ceil(t / (kChunk * kLanes)) blocks. A
// block stages its tile into shared memory with 4-byte cp.async (x is
// read from device memory once, for phases A and C), each chunk in a row
// of kChunk + 1 floats so that the lanes' walks along their own rows hit
// 32 different banks; the carry passes between lanes by shuffles, in lane
// order; phase C overwrites the row with the outputs, which the warp then
// stores coalesced. Between tiles of a series the carry is a single-pass
// chained scan: a block takes a ticket from atomicAdd, so blocks start in
// ticket order and a block waits only on tiles whose blocks have started;
// each block publishes its aggregate E_j behind a flag, and each folds
// its predecessors' aggregates itself, in tile order from zero, so no
// block waits on another's fold. The ticket, a count of finished blocks
// and the flags live in a scratch that the wrapper keeps per device and
// stream, zero between launches: the last block to finish clears them.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 256;                     // samples per chunk: one lane
constexpr int kLanes = 32;                      // chunks per tile: one warp, one block
constexpr int kStride = kChunk + 1;             // a chunk's row in shared memory
constexpr int kTileSamples = kChunk * kLanes;   // 8,192
constexpr unsigned kFull = 0xffffffffu;

struct Mat {
  double m00, m01, m10, m11;
};

__device__ __forceinline__ float step(float x, float b0, float b1, float b2,
                                      float a1, float a2, float& z1,
                                      float& z2) {
  const float out = __fadd_rn(__fmul_rn(x, b0), z1);
  const float nz1 = __fsub_rn(__fadd_rn(__fmul_rn(x, b1), z2), __fmul_rn(a1, out));
  z2 = __fsub_rn(__fmul_rn(x, b2), __fmul_rn(a2, out));
  z1 = nz1;
  return out;
}

// (z1, z2) <- M (z1, z2) + (e1, e2) in float64, each multiply and add
// rounded on its own (filters._carry)
__device__ __forceinline__ void carry(const Mat& m, double& z1, double& z2,
                                      double e1, double e2) {
  const double n1 = __dadd_rn(__dadd_rn(__dmul_rn(m.m00, z1), __dmul_rn(m.m01, z2)), e1);
  const double n2 = __dadd_rn(__dadd_rn(__dmul_rn(m.m10, z1), __dmul_rn(m.m11, z2)), e2);
  z1 = n1;
  z2 = n2;
}

// P = A^kChunk and Q = A^(kChunk * kLanes) by float64 repeated squaring
// (filters.chunk_transitions)
__device__ void transitions(float a1, float a2, Mat& p, Mat& q) {
  double m00 = -(double)a1, m01 = 1.0, m10 = -(double)a2, m11 = 0.0;
  auto square = [&]() {
    const double n00 = __dadd_rn(__dmul_rn(m00, m00), __dmul_rn(m01, m10));
    const double n01 = __dadd_rn(__dmul_rn(m00, m01), __dmul_rn(m01, m11));
    const double n10 = __dadd_rn(__dmul_rn(m10, m00), __dmul_rn(m11, m10));
    const double n11 = __dadd_rn(__dmul_rn(m10, m01), __dmul_rn(m11, m11));
    m00 = n00;
    m01 = n01;
    m10 = n10;
    m11 = n11;
  };
  for (int i = 1; i < kChunk; i <<= 1) square();
  p = {m00, m01, m10, m11};
  for (int i = 1; i < kLanes; i <<= 1) square();
  q = {m00, m01, m10, m11};
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// walks `len` samples of a chunk's row from state (z1, z2); writes the
// outputs over the inputs when `write`
template <bool write>
__device__ __forceinline__ void walk(float* row, int len, float b0, float b1,
                                     float b2, float a1, float a2, float& z1,
                                     float& z2) {
  if (len == kChunk) {
#pragma unroll 16
    for (int k = 0; k < kChunk; ++k) {
      const float out = step(row[k], b0, b1, b2, a1, a2, z1, z2);
      if (write) row[k] = out;
    }
  } else {
    for (int k = 0; k < len; ++k) {
      const float out = step(row[k], b0, b1, b2, a1, a2, z1, z2);
      if (write) row[k] = out;
    }
  }
}

// a tile of the pass: series s, tile j, the series' length n, the tile's
// pass-order samples [first, first + len) (len <= 0: none)
struct Tile {
  int s, j, len;
  long long n, first;
  const float* xs;
  float* ys;
};

__device__ __forceinline__ Tile tile_at(unsigned block, int tiles, const float* x,
                                        float* y, int t, int content_all,
                                        const int* contents) {
  Tile tl;
  tl.s = (int)(block / (unsigned)tiles);
  tl.j = (int)(block - (unsigned)tl.s * (unsigned)tiles);
  tl.n = contents ? contents[tl.s] : content_all;
  tl.first = (long long)tl.j * kTileSamples;
  tl.len = (int)max(0LL, min((long long)kTileSamples, tl.n - tl.first));
  tl.xs = x + (size_t)tl.s * (size_t)t;
  tl.ys = y + (size_t)tl.s * (size_t)t;
  return tl;
}

// the tile's share of the series' tail [n, t), written +0
__device__ __forceinline__ void zero_tail(const Tile& tl, int t, int lane) {
  const long long tail = tl.n + tl.first;
  const long long tail_end = min((long long)t, tail + kTileSamples);
  for (long long i = tail + lane; i < tail_end; i += kLanes) tl.ys[i] = 0.0f;
}

__device__ __forceinline__ long long sample_at(const Tile& tl, int reverse, int p) {
  return reverse ? tl.n - 1 - tl.first - p : tl.first + p;
}

// pass-order sample p of the tile goes to row p / kChunk of buf
__device__ __forceinline__ void load_tile(float* buf, const Tile& tl, int reverse,
                                          int lane) {
#pragma unroll 8
  for (int p = lane; p < tl.len; p += kLanes) {
    cp_async4(&buf[(p / kChunk) * kStride + p % kChunk], tl.xs + sample_at(tl, reverse, p));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

__device__ __forceinline__ void store_tile(const float* buf, const Tile& tl,
                                           int reverse, int lane) {
  __syncwarp();
#pragma unroll 8
  for (int p = lane; p < tl.len; p += kLanes) {
    tl.ys[sample_at(tl, reverse, p)] = buf[(p / kChunk) * kStride + p % kChunk];
  }
}

// the tile's aggregate: P carried over the lanes' end states from zero
__device__ __forceinline__ double2 aggregate(const Mat& pm, double e1, double e2) {
  double t1 = 0.0, t2 = 0.0;
  for (int i = 0; i < kLanes; ++i) {
    carry(pm, t1, t2, __shfl_sync(kFull, e1, i), __shfl_sync(kFull, e2, i));
  }
  return make_double2(t1, t2);
}

// this lane's chunk start: P carried from the tile's start (c1, c2) over the
// lanes before it, rounded to float32
__device__ __forceinline__ void lane_start(const Mat& pm, double c1, double c2,
                                           double e1, double e2, int lane,
                                           float& z1, float& z2) {
  double u1 = c1, u2 = c2;
  for (int i = 0; i + 1 < kLanes; ++i) {
    carry(pm, c1, c2, __shfl_sync(kFull, e1, i), __shfl_sync(kFull, e2, i));
    if (lane == i + 1) {
      u1 = c1;
      u2 = c2;
    }
  }
  z1 = __double2float_rn(u1);
  z2 = __double2float_rn(u2);
}

// sync: [ticket, finished blocks, flag per block]; agg: E_j per block
__global__ void __launch_bounds__(kLanes)
biquad_scan(const float* __restrict__ x, float* __restrict__ y,
            const float* __restrict__ coeffs, int t, int content_all,
            const int* __restrict__ contents, int reverse, int tiles,
            unsigned* sync, double2* agg) {
  __shared__ float buf[kLanes * kStride];
  const int lane = threadIdx.x;
  unsigned* flags = sync + 2;
  unsigned ticket = 0;
  if (lane == 0) ticket = atomicAdd(&sync[0], 1u);
  ticket = __shfl_sync(kFull, ticket, 0);
  const Tile tl = tile_at(ticket, tiles, x, y, t, content_all, contents);
  zero_tail(tl, t, lane);
  if (tl.len > 0) {
    load_tile(buf, tl, reverse, lane);
    const float* c = coeffs + 5 * (size_t)tl.s;
    const float b0 = c[0], b1 = c[1], b2 = c[2], a1 = c[3], a2 = c[4];
    float* row = buf + lane * kStride;
    const int clen = max(0, min(kChunk, tl.len - lane * kChunk));

    // A: the chunk from zero state
    float z1 = 0.0f, z2 = 0.0f;
    walk<false>(row, clen, b0, b1, b2, a1, a2, z1, z2);
    const double e1 = z1, e2 = z2;

    // B, in float64: the tile's aggregate, published for the tiles after
    // it; the tile's start, the aggregates of the tiles before it folded in
    // tile order from zero, 32 at a time; the lane's start
    Mat pm, qm;
    transitions(a1, a2, pm, qm);
    const double2 mine = aggregate(pm, e1, e2);
    if (lane == 0) {
      agg[ticket] = mine;
      __threadfence();
      store_release(&flags[ticket], 1u);
    }
    double c1 = 0.0, c2 = 0.0;
    for (int r = 0; r < tl.j; r += kLanes) {
      double2 a = make_double2(0.0, 0.0);
      if (r + lane < tl.j) {
        const unsigned at = ticket - (unsigned)tl.j + (unsigned)(r + lane);
        while (load_acquire(&flags[at]) == 0u) __nanosleep(32);
        a = __ldcg(&agg[at]);
      }
      const int m = min(kLanes, tl.j - r);
      for (int i = 0; i < m; ++i) {
        carry(qm, c1, c2, __shfl_sync(kFull, a.x, i), __shfl_sync(kFull, a.y, i));
      }
    }
    lane_start(pm, c1, c2, e1, e2, lane, z1, z2);

    // C: the chunk from its start, outputs over the inputs, stored coalesced
    walk<true>(row, clen, b0, b1, b2, a1, a2, z1, z2);
    store_tile(buf, tl, reverse, lane);
  }

  // the last block to finish leaves the scratch zero for the next launch:
  // every block has taken its ticket and read its last flag by then
  unsigned last = 0;
  if (lane == 0) {
    __threadfence();
    last = atomicAdd(&sync[1], 1u) == gridDim.x - 1;
  }
  if (__shfl_sync(kFull, last, 0)) {
    __threadfence();
    for (unsigned i = lane; i < gridDim.x; i += kLanes) flags[i] = 0u;
    if (lane == 0) {
      sync[0] = 0u;
      sync[1] = 0u;
    }
  }
}

}  // namespace

// C interface for ctypes. x and y: device pointers of contiguous (series, t)
// float32 arrays that do not overlap; coeffs: (series, 5) float32. Samples
// [content, t) of y are written as 0; 0 <= content <= t. contents: null, or
// a device pointer of (series,) int32 per-series lengths in [0, t] (the
// caller checks them) that take the place of `content`. sync: a zeroed
// device array of 2 + `capacity` uint32, agg: of 2 x `capacity` float64,
// capacity >= series x ceil(t / (kChunk x kLanes)), the launch's blocks;
// launches that share them must run one after another (one stream). Enqueues
// one launch on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments out of range).
extern "C" int rv_biquad_scan(const void* x, void* y, const void* coeffs,
                              int series, int t, int content,
                              const void* contents, int reverse, void* sync,
                              void* agg, long long capacity, void* stream) {
  if (series < 0 || t < 0 || content < 0 || content > t) {
    return (int)cudaErrorInvalidValue;
  }
  if (series == 0 || t == 0) return 0;
  const long long tiles = ((long long)t + kTileSamples - 1) / kTileSamples;
  const long long blocks = (long long)series * tiles;
  if (blocks > capacity || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  biquad_scan<<<(unsigned)blocks, kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, (const float*)coeffs, t, content,
      (const int*)contents, reverse != 0, (int)tiles, (unsigned*)sync,
      (double2*)agg);
  return (int)cudaGetLastError();
}
