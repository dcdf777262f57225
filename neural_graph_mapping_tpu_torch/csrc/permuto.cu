// Hopper (sm_90a) kernels for the permutohedral hash encoding (training
// encode and table gradient, the fused encode + MLP pair, the gather route's
// lookup and histogram, and the render path's tile-sorted MoE encodes) and
// the keyframe-visibility lookup, with a plain C interface for ctypes.
//
// Build (neural_graph_mapping_tpu_torch/ops/cuda_build.py does this at first
// use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libngm_permuto.so permuto.cu
//
// -fmad=false keeps every multiply and add separately rounded, exactly as
// the plain PyTorch version (one elementwise kernel per operation) rounds
// them, so the lattice corners the kernels pick are bit-identical to the
// plain version's; a fused multiply-add would move a point sitting on a
// rounding boundary to a neighbouring corner.
//
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so the caller can
// raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kDim = 3;             // lattice dimension d (points are 3D)
constexpr int kCorners = kDim + 1;  // simplex corners per level
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;  // the card's limit on gridDim.y

// Per-level lattice constants. Passed by value as a kernel parameter: the
// card keeps kernel parameters in its constant bank (__constant__ memory),
// so every warp reads them as a broadcast, and no copy precedes a launch.
struct LevelConsts {
  int n_levels;
  float scale[kMaxLevels];
  float shift[kMaxLevels][kDim];
  float elev[kDim];
  uint32_t mask[kMaxLevels];  // level capacity - 1 (capacities are 2^k)
};

__device__ __constant__ uint32_t kHashPrimes[kDim] = {1u, 2654435761u, 805459861u};

// The permutohedral lattice of one point at one level: hash-table indices of
// the d+1 enclosing simplex corners and their barycentric weights. Same
// arithmetic, in the same order, as lattice_keys_and_weights_soa in
// ops/permuto.py (Adams, Baek, Davis 2010): elevate onto the sum-zero
// hyperplane, round to the nearest remainder-0 point (rintf: half to even,
// like torch.round and jnp.round), rank the residuals, fix points rounded
// off the hyperplane, then weights and corner hashes.
__device__ __forceinline__ void lattice_level(
    float x, float y, float z, const LevelConsts& c, int l,
    uint32_t idx[kCorners], float w[kCorners]) {
  const float cf[kDim] = {
      (x / c.scale[l] + c.shift[l][0]) * c.elev[0],
      (y / c.scale[l] + c.shift[l][1]) * c.elev[1],
      (z / c.scale[l] + c.shift[l][2]) * c.elev[2],
  };
  float suffix[kDim + 1];
  suffix[kDim] = 0.0f;
  for (int i = kDim - 1; i >= 0; --i) suffix[i] = suffix[i + 1] + cf[i];
  float elevated[kCorners];
  elevated[0] = suffix[0];
  for (int i = 1; i <= kDim; ++i) elevated[i] = suffix[i] - (float)i * cf[i - 1];

  const float down = 1.0f / (float)(kDim + 1);
  float rem0[kCorners];
  float diff[kCorners];
  int rank[kCorners];
  float rem_sum = 0.0f;
  for (int i = 0; i < kCorners; ++i) {
    rem0[i] = rintf(elevated[i] * down) * (float)(kDim + 1);
    diff[i] = elevated[i] - rem0[i];
    rank[i] = 0;
    rem_sum = rem_sum + rem0[i];
  }
  for (int i = 0; i < kCorners; ++i) {
    for (int j = i + 1; j < kCorners; ++j) {
      if (diff[i] < diff[j]) {
        rank[i] += 1;
      } else {
        rank[j] += 1;
      }
    }
  }
  const int s = (int)rintf(rem_sum * down);
  for (int i = 0; i < kCorners; ++i) {
    const int r = rank[i] + s;
    if (r < 0) {
      rank[i] = r + (kDim + 1);
      rem0[i] = rem0[i] + (float)(kDim + 1);
    } else if (r > kDim) {
      rank[i] = r - (kDim + 1);
      rem0[i] = rem0[i] - (float)(kDim + 1);
    } else {
      rank[i] = r;
    }
  }

  float bary[kDim + 2] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < kCorners; ++i) {
    const float v = (elevated[i] - rem0[i]) * down;
    bary[kDim - rank[i]] = bary[kDim - rank[i]] + v;
    bary[kDim + 1 - rank[i]] = bary[kDim + 1 - rank[i]] - v;
  }
  bary[0] = (bary[0] + 1.0f) + bary[kDim + 1];

  for (int k = 0; k < kCorners; ++k) {
    uint32_t h = 0u;
    for (int i = 0; i < kDim; ++i) {
      const int offset = rank[i] < (kDim + 1 - k) ? k : k - (kDim + 1);
      const int key = (int)rem0[i] + offset;
      h ^= (uint32_t)key * kHashPrimes[i];  // wraps mod 2^32, as uint32 does
    }
    idx[k] = h & c.mask[l];
    w[k] = bary[k];
  }
}

// All levels of one point from one field's feature-major (2, L, T) table:
// o[(2l + f) * stride + p] = sum_k w_k * tab[f, l, idx_k].
__device__ __forceinline__ void encode_point(const float* __restrict__ tab, int T,
                                             float x, float y, float z,
                                             const LevelConsts& c,
                                             float* __restrict__ o,
                                             size_t stride, int p) {
  const int L = c.n_levels;
  for (int l = 0; l < L; ++l) {
    uint32_t idx[kCorners];
    float w[kCorners];
    lattice_level(x, y, z, c, l, idx, w);
    const float* t0 = tab + (size_t)l * T;
    const float* t1 = tab + (size_t)(L + l) * T;
    float acc0 = 0.0f;
    float acc1 = 0.0f;
    for (int k = 0; k < kCorners; ++k) {
      acc0 = acc0 + w[k] * __ldg(t0 + idx[k]);
      acc1 = acc1 + w[k] * __ldg(t1 + idx[k]);
    }
    o[(size_t)(2 * l) * stride + p] = acc0;
    o[(size_t)(2 * l + 1) * stride + p] = acc1;
  }
}

// Replaces permuto_pallas.encode_fwd (_encode_fwd_kernel): the fused
// permutohedral encode, out[b, 2l+f, p] = sum_k w_k * table[b, f, l, idx_k].
//
// Bound: random 8-byte gathers. At the training shape (32 fields x 12,288
// points x 16 levels x 4 corners x 2 features, ~50 M gathers per call) the
// kernel is latency-bound on L2 hits: the 32 training tables are 16 MiB and
// stay resident in the 50 MB L2, and the coordinates and the output stream
// once, coalesced. Design: one thread per (field, point), all levels in
// registers, no shared memory; consecutive threads take consecutive points
// so every coordinate load and every output store is one coalesced
// transaction per warp. The TPU's 128-lane chunk sweep and bf16 pair
// packing existed to emulate a gather the TPU lacks and are not carried over.
__global__ void encode_fwd_kernel(const float* __restrict__ table,
                                  const float* __restrict__ coords,
                                  float* __restrict__ out, int P, int T,
                                  __grid_constant__ const LevelConsts c) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= P) return;
  const size_t cbase = (size_t)b * kDim * P;
  const float x = coords[cbase + p];
  const float y = coords[cbase + P + p];
  const float z = coords[cbase + 2 * (size_t)P + p];
  const int L = c.n_levels;
  encode_point(table + (size_t)b * 2 * L * T, T, x, y, z, c,
               out + (size_t)b * 2 * L * P, P, p);
}

// -- shared-memory histograms (encode_bwd_table, table_grad) -----------------
//
// Both table gradients sum per-pair values into (2, n) f32 histograms. A
// block keeps one histogram row pair in shared memory, adds into it with
// shared-memory atomics, and writes it to device memory once, as the TPU
// kernels keep their histogram in VMEM across point tiles. Atomics make the
// summation order vary from run to run, so results agree with the plain
// version to rounding, not bit for bit.

constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kNoKey = 0xffffffffu;  // a lane with nothing to add
// Histograms of up to 12,288 entries a row ((2, T) f32 up to 96 KB) are
// staged in shared memory; larger ones take the direct variants.
constexpr int kMaxStagedBytes = 96 * 1024;
// Least pairs (gather_pairs, table_grad) or points (encode_bwd_table) a
// staged block serves: below them, staging the table or zeroing and
// flushing the histogram costs more than the block's own work.
constexpr int kStagedPairs = 8192;
constexpr int kStagedPoints = 4096;
constexpr int kFillBlocksPerSm = 4;  // 4 x 8 warps: enough to stream at full rate
int g_sm_count = 132;                // the card's SMs, read by ngm_permuto_init

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// Blocks along a histogram row: one while the rows alone give every SM
// kFillBlocksPerSm blocks, else as many as reach that, each summing at
// least min_chunk of the row's n pairs or points (at most 65,535).
int hist_chunks(int64_t rows, int n, int min_chunk) {
  const int64_t fill = (int64_t)kFillBlocksPerSm * g_sm_count;
  const int64_t chunks = std::min<int64_t>(fill / std::max<int64_t>(rows, 1), n / min_chunk);
  return (int)std::max<int64_t>(1, std::min<int64_t>(chunks, kMaxGridY));
}

// Adds (v0, v1) at entry `key` of the shared-memory rows h0 and h1, for all
// 32 lanes of the warp at once (every lane must call it: the shuffles take
// the full warp); a lane whose key is kNoKey adds nothing.
//
// A float atomicAdd to shared memory is a compare-and-swap loop on this
// card (ATOMS.CAST.SPIN in the SASS), so lanes that add to one address retry
// one after another: 32 lanes on one coarse cell cost 32 rounds. So a
// warp in which some lane holds the same key as its next lane
// (points that sit next to each other share coarse cells) first groups its
// lanes by key (__match_any_sync) and sums each group by a tree of shuffles
// (log2 of the largest group steps); only the lowest lane of a group adds.
// Warps without such a pair, the fine levels' usual case, add directly and
// pay one shuffle and one vote: grouping a warp whose keys all differ costs
// more than the adds it would save (__match_any_sync is slow).
__device__ __forceinline__ void hist_add(float* h0, float* h1, uint32_t key,
                                         float v0, float v1) {
  const unsigned lane = threadIdx.x & 31u;
  const uint32_t next_key = __shfl_down_sync(kFullMask, key, 1);
  if (__any_sync(kFullMask, key != kNoKey && lane < 31u && next_key == key)) {
    const unsigned peers = __match_any_sync(kFullMask, key);
    int rank = __popc(peers & ((1u << lane) - 1u));  // place among its peers
    const bool leader = rank == 0;
    unsigned above = key == kNoKey ? 0u : peers & ~((2u << lane) - 1u);
    while (__any_sync(kFullMask, above != 0u)) {
      const int next = __ffs(above) - 1;  // the next live peer above, or -1
      const float t0 = __shfl_sync(kFullMask, v0, next & 31);
      const float t1 = __shfl_sync(kFullMask, v1, next & 31);
      if (next >= 0) {
        v0 = v0 + t0;
        v1 = v1 + t1;
      }
      above &= ~__ballot_sync(kFullMask, rank & 1);  // odd places are summed up
      rank >>= 1;
    }
    if (!leader) return;
  }
  if (key != kNoKey) {
    atomicAdd(h0 + key, v0);
    atomicAdd(h1 + key, v1);
  }
}

// row[0:n) = h[0:n) up to cap, 0 past it, written by the block's threads;
// 16-byte stores where the row allows them.
__device__ __forceinline__ void store_hist_row(float* __restrict__ row,
                                               const float* h, int cap, int n) {
  if (n % 4 == 0 && aligned16(row)) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
      const float4 v = make_float4(i < cap ? h[i] : 0.0f, i + 1 < cap ? h[i + 1] : 0.0f,
                                   i + 2 < cap ? h[i + 2] : 0.0f, i + 3 < cap ? h[i + 3] : 0.0f);
      *reinterpret_cast<float4*>(row + i) = v;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) row[i] = i < cap ? h[i] : 0.0f;
  }
}

// row[0:n) += h[0:n), the nonzero entries only, into a zeroed output (a
// row split over several blocks).
__device__ __forceinline__ void add_hist_row(float* row, const float* h, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = h[i];
    if (v != 0.0f) atomicAdd(row + i, v);
  }
}

// Replaces permuto_pallas.encode_bwd_table (_encode_bwd_kernel): recompute
// the lattice and accumulate w_k * g[b, 2l+f, p] into grad[b, f, l, idx_k].
//
// Bound: bytes, 50 MB of cotangent and 4.7 MB of coordinates in and the
// 16.8 MB gradient out at the training shape (32 fields x 12,288 points,
// L = 16, T = 4096: 0.021 ms at 3.35 TB/s), then the 6.3 M lattice
// evaluations (~0.014 ms of f32 work). What limited the first design, one
// thread per (field, point) adding all 50 M corner values into device
// memory with global atomics, was the L2's atomic units serialising the
// coarse levels (512 and 1,024 entries), where many points of a field share
// an entry. Design, as the TPU kernel keeps each field's (2, L, T) gradient
// in VMEM across its point tiles: a block owns one (field, level) and a
// chunk of points (grid x = field * L + level, y = chunks by hist_chunks)
// and keeps that level's (2, cap_l) histogram in shared memory, 32 KB at
// cap 4,096 and 4 KB at the coarsest level. Each thread takes every
// kBwdThreads-th point: the level's two cotangents (streamed) and the
// point's coordinates, coalesced from (B, 3, P), the next point's loads
// issued before this point's work; lattice_level for this one level
// (unchanged, so the corners match encode_fwd and the plain version bit
// for bit), skipped by a warp whose points all have zero cotangents; and
// 4 corners x 2 features of shared-memory adds (hist_add). A block's
// points form one long serial loop a thread, so the block is 16 warps wide
// and the loop carries no load latency. The price of the level grid is
// that the coordinates are read once a level: 16 x 4.7 MB at the training
// shape, from L2, where the 4.7 MB stay resident. A block that owns its
// level's whole point range writes grad[b, f, l, 0:T) with plain stores,
// the histogram up to cap_l and zeros past it, so the output needs no
// memset; blocks of a split range add their nonzero entries into a zeroed
// output. With the histogram on chip, what bounds the kernel is the lattice
// arithmetic it shares with encode_fwd_kernel (both take about the same
// time on an H100). The TPU's one-hot(idx>>6) x one-hot(idx&63) matmuls
// built the same histogram on the MXU and are not carried over.
constexpr int kBwdThreads = 512;  // 16 warps a (field, level) block

// One point's inputs at level l: its two cotangents and its coordinates
// (zeros at or past end).
struct BwdPoint {
  float g0, g1, x, y, z;
};

__device__ __forceinline__ BwdPoint load_bwd_point(const float* xyz, const float* g0p,
                                                   const float* g1p, int P, int p, int end) {
  BwdPoint q = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (p < end) {
    q.g0 = __ldcs(g0p + p);
    q.g1 = __ldcs(g1p + p);
    q.x = xyz[p];
    q.y = xyz[P + p];
    q.z = xyz[2 * (size_t)P + p];
  }
  return q;
}

__global__ void __launch_bounds__(kBwdThreads) encode_bwd_table_staged_kernel(
    const float* __restrict__ coords, const float* __restrict__ g,
    float* __restrict__ grad, int P, int T, int chunk,
    __grid_constant__ const LevelConsts c) {
  extern __shared__ __align__(16) float hist[];  // (2, cap_l)
  const int L = c.n_levels;
  const int b = blockIdx.x / L;
  const int l = blockIdx.x - b * L;
  const int cap = (int)c.mask[l] + 1;
  float* h0 = hist;
  float* h1 = hist + cap;
  for (int i = threadIdx.x; i < 2 * cap; i += blockDim.x) hist[i] = 0.0f;
  const int begin = blockIdx.y * chunk;
  const int end = min(P, begin + chunk);
  const float* xyz = coords + (size_t)b * kDim * P;
  const float* g0p = g + ((size_t)b * 2 * L + 2 * l) * P;
  const float* g1p = g0p + P;
  int p = begin + threadIdx.x;
  BwdPoint q = load_bwd_point(xyz, g0p, g1p, P, p, end);  // while the histogram is zeroed
  __syncthreads();
  for (int base = begin; base < end; base += blockDim.x, p += blockDim.x) {  // the same trips for every warp
    const BwdPoint next = load_bwd_point(xyz, g0p, g1p, P, p + blockDim.x, end);
    const bool add = q.g0 != 0.0f || q.g1 != 0.0f;
    if (__any_sync(kFullMask, add)) {
      uint32_t idx[kCorners];
      float w[kCorners];
      lattice_level(q.x, q.y, q.z, c, l, idx, w);
#pragma unroll
      for (int k = 0; k < kCorners; ++k) {
        hist_add(h0, h1, add ? idx[k] : kNoKey, w[k] * q.g0, w[k] * q.g1);
      }
    }
    q = next;
  }
  __syncthreads();
  float* r0 = grad + ((size_t)b * 2 * L + l) * T;  // grad[b, 0, l, :]
  float* r1 = r0 + (size_t)L * T;                  // grad[b, 1, l, :]
  if (gridDim.y == 1) {
    store_hist_row(r0, h0, cap, T);
    store_hist_row(r1, h1, cap, T);
  } else {
    add_hist_row(r0, h0, cap);
    add_hist_row(r1, h1, cap);
  }
}

// The direct variant, for tables whose (2, T) histogram is above
// kMaxStagedBytes (T > 12,288; the C entry point chooses for the whole
// call): one thread per (field, point), every corner value added into the
// zeroed gradient with a global atomicAdd (the first design, and the
// original CUDA extension's).
__global__ void encode_bwd_table_kernel(const float* __restrict__ coords,
                                        const float* __restrict__ g,
                                        float* __restrict__ grad, int P, int T,
                                        __grid_constant__ const LevelConsts c) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= P) return;
  const size_t cbase = (size_t)b * kDim * P;
  const float x = coords[cbase + p];
  const float y = coords[cbase + P + p];
  const float z = coords[cbase + 2 * (size_t)P + p];
  const int L = c.n_levels;
  const float* gb = g + (size_t)b * 2 * L * P;
  float* gr = grad + (size_t)b * 2 * L * T;
  for (int l = 0; l < L; ++l) {
    const float g0 = gb[(size_t)(2 * l) * P + p];
    const float g1 = gb[(size_t)(2 * l + 1) * P + p];
    if (g0 == 0.0f && g1 == 0.0f) continue;  // nothing to add
    uint32_t idx[kCorners];
    float w[kCorners];
    lattice_level(x, y, z, c, l, idx, w);
    float* r0 = gr + (size_t)l * T;
    float* r1 = gr + (size_t)(L + l) * T;
    for (int k = 0; k < kCorners; ++k) {
      atomicAdd(r0 + idx[k], w[k] * g0);
      atomicAdd(r1 + idx[k], w[k] * g1);
    }
  }
}

// Loads and stores that stream: read or written once, evict first, so they
// do not push the scattered reads' sectors out of L2.
__device__ __forceinline__ int64_t load_index(const int64_t* p) {
  return (int64_t)__ldcs(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ longlong2 load_index_pair(const int64_t* p) {
  return __ldcs(reinterpret_cast<const longlong2*>(p));
}

constexpr int kLookups = 4;  // lookups a thread of the gather kernels takes at once

// Replaces permuto_pallas.batched_gather (_batched_gather_kernel):
// out[b, m] = values[b, idx[b, m]], exact (no max-pooling).
//
// Bound: DRAM latency of scattered reads. At the training shape (1000
// keyframe slots x 19,200 pixels of depth, 76.8 MB, more than the 50 MB L2;
// 640 lookups a slot) each lookup is one dependent 4-byte read that moves a
// whole 32-byte sector, so the least traffic is 640k sectors (20.5 MB) plus
// 7.7 MB of indices and outputs, ~8.4 us at 3.35 TB/s; the byte bound of 4
// useful bytes a lookup (3.1 us) is out of reach. What limits a simple
// kernel is how few reads it has in flight. Design: grid y = slot (a slot
// loop past the 65,535 limit of gridDim.y), grid x = groups of kLookups
// lookups, so no thread divides; each thread loads its four indices as two
// 16-byte streaming loads, issues all four scattered reads before it uses
// the first, and writes one 16-byte streaming store. Rows whose base is not
// 16-byte aligned (M % 4 != 0, or unaligned pointers) take the scalar
// variant, which also takes a short last group. Index bounds are the
// caller's contract, as in JAX. The TPU's lane-gather chunk sweep is not
// carried over.
template <bool kVec>
__global__ void batched_gather_kernel(const float* __restrict__ values,
                                      const int64_t* __restrict__ idx,
                                      float* __restrict__ out, int B, int N, int M) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) * kLookups;
  if (m >= M) return;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float* vals = values + (size_t)b * N;
    const int64_t* ib = idx + (size_t)b * M + m;
    float* ob = out + (size_t)b * M + m;
    if (kVec) {
      const longlong2 i01 = load_index_pair(ib);
      const longlong2 i23 = load_index_pair(ib + 2);
      float4 v;
      v.x = __ldg(vals + i01.x);
      v.y = __ldg(vals + i01.y);
      v.z = __ldg(vals + i23.x);
      v.w = __ldg(vals + i23.y);
      __stcs(reinterpret_cast<float4*>(ob), v);
    } else {
      const int n = min(kLookups, M - m);
      int64_t i[kLookups];
      float v[kLookups];
#pragma unroll
      for (int k = 0; k < kLookups; ++k) i[k] = k < n ? load_index(ib + k) : 0;
#pragma unroll
      for (int k = 0; k < kLookups; ++k) v[k] = k < n ? __ldg(vals + i[k]) : 0.0f;
#pragma unroll
      for (int k = 0; k < kLookups; ++k) {
        if (k < n) __stcs(ob + k, v[k]);
      }
    }
  }
}

// -- render path: tile-sorted mixture-of-experts encodes ---------------------
//
// The render dispatch (ops/dispatch.py tiled_dispatch_sorted) packs every
// (sample, field) pair into kTile-pair tiles, each owned by one field
// (tile_experts[t]). Tiles at or past *num_live (a device scalar, so the
// host never waits for it) hold only invalid pairs and padding: their
// output is never written and every consumer masks it by select.
//
// Bound: the same random 8-byte table gathers as encode_fwd_kernel, now
// ~1.07 G per 8,388,608-pair render block (16 levels x 4 corners x 2
// features a pair), plus the 1.07 GB (tiles, 2L, 1024) f32 output, which is
// the least traffic the block needs (~0.32 ms at 3.35 TB/s). Consecutive
// tiles mostly share a field, so a field's 512 KiB table is reused from L2;
// even 1000 fields' tables (512 MB) are gathered straight from device
// memory through L2 without staging. Design: one block of kThreads threads
// per quarter tile (grid = tiles x kTile / kThreads), one thread per pair,
// the tile's field read once per thread from tile_experts; coordinates and
// outputs are coalesced along the tile's lanes. The TPU kernel's table DMA
// per grid step and its 128-lane sweep are not carried over.
constexpr int kTile = 1024;  // pairs per tile (permuto_pallas.TILE_M)

// Replaces permuto_pallas.encode_fwd_moe (_encode_fwd_moe_kernel): the MoE
// encode from carried field-local coordinates (tiles, 3, kTile).
__global__ void encode_fwd_moe_kernel(const float* __restrict__ tables,
                                      const float* __restrict__ coords,
                                      const int* __restrict__ tile_experts,
                                      const int* __restrict__ num_live,
                                      float* __restrict__ out, int T,
                                      __grid_constant__ const LevelConsts c) {
  const int t = blockIdx.x;
  if (t >= __ldg(num_live)) return;
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  const int L = c.n_levels;
  const float* xyz = coords + (size_t)t * kDim * kTile;
  const int e = __ldg(tile_experts + t);
  encode_point(tables + (size_t)e * 2 * L * T, T, xyz[lane], xyz[kTile + lane],
               xyz[2 * kTile + lane], c, out + (size_t)t * 2 * L * kTile, kTile,
               lane);
}

// Launch constants of the ray rebuild (everything but the camera/extrinsics
// vector, which lives on the device because it comes from the pose).
struct RayConsts {
  int block_offset;  // pixel index of the block's first ray
  int log2_ks;       // log2(k * samples per ray): pair index -> ray
  int width;         // image width (exact integer row split)
  float coord_scale;  // field-local scaling (scale_mode)
  float coord_shift;
};

// Replaces permuto_pallas.encode_fwd_moe_rays (_encode_fwd_moe_rays_kernel):
// the MoE encode that rebuilds each sample point from its k-minor pair index
// and span distance, in the TPU kernel's order of operations:
//   ray = orig >> log2_ks; pixel = block_offset + ray; row = pixel / width
//   (an exact integer division, no f32 reciprocal); direction
//   (R @ ((j - cx)/fx, -(i - cy)/fy, -1)) / norm; world = origin + dir * dist;
//   local = conj(q) * (world - p_field) * coord_scale + coord_shift.
// rayp (16,) f32 on the device: R row-major (9), origin (3), 1/fx, 1/fy, cx,
// cy. poses (N, 7): position, wxyz quaternion. The norm is 1 / sqrtf(...)
// (IEEE sqrt and division, no rsqrtf approximation) so the coordinates are
// bit-identical to the plain version's and land on the same simplex corners.
__global__ void encode_fwd_moe_rays_kernel(const float* __restrict__ tables,
                                           const int* __restrict__ orig,
                                           const float* __restrict__ dist,
                                           const int* __restrict__ tile_experts,
                                           const int* __restrict__ num_live,
                                           const float* __restrict__ rayp,
                                           const float* __restrict__ poses,
                                           float* __restrict__ out, int T,
                                           __grid_constant__ const RayConsts rc,
                                           __grid_constant__ const LevelConsts c) {
  const int t = blockIdx.x;
  if (t >= __ldg(num_live)) return;
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  const size_t i = (size_t)t * kTile + lane;
  const int e = __ldg(tile_experts + t);
  const int ray = (int)((uint32_t)orig[i] >> rc.log2_ks);
  const int pix = ray + rc.block_offset;
  const int iy_i = pix / rc.width;
  const float iy = (float)iy_i;
  const float jx = (float)(pix - iy_i * rc.width);
  const float dx = (jx - __ldg(rayp + 14)) * __ldg(rayp + 12);
  const float dy = -(iy - __ldg(rayp + 15)) * __ldg(rayp + 13);
  const float inv_n = 1.0f / sqrtf(dx * dx + dy * dy + 1.0f);
  const float dwx = (__ldg(rayp + 0) * dx + __ldg(rayp + 1) * dy - __ldg(rayp + 2)) * inv_n;
  const float dwy = (__ldg(rayp + 3) * dx + __ldg(rayp + 4) * dy - __ldg(rayp + 5)) * inv_n;
  const float dwz = (__ldg(rayp + 6) * dx + __ldg(rayp + 7) * dy - __ldg(rayp + 8)) * inv_n;
  const float d = dist[i];
  const float* pose = poses + (size_t)e * 7;
  const float px = __ldg(rayp + 9) + dwx * d - __ldg(pose + 0);
  const float py = __ldg(rayp + 10) + dwy * d - __ldg(pose + 1);
  const float pz = __ldg(rayp + 11) + dwz * d - __ldg(pose + 2);
  // inverse quaternion rotate (conjugate), as fields.world_to_local_soa
  const float qw = __ldg(pose + 3);
  const float qx = -__ldg(pose + 4);
  const float qy = -__ldg(pose + 5);
  const float qz = -__ldg(pose + 6);
  const float tx = 2.0f * (qy * pz - qz * py);
  const float ty = 2.0f * (qz * px - qx * pz);
  const float tz = 2.0f * (qx * py - qy * px);
  const float xs = (px + qw * tx + (qy * tz - qz * ty)) * rc.coord_scale + rc.coord_shift;
  const float ys = (py + qw * ty + (qz * tx - qx * tz)) * rc.coord_scale + rc.coord_shift;
  const float zs = (pz + qw * tz + (qx * ty - qy * tx)) * rc.coord_scale + rc.coord_shift;
  const int L = c.n_levels;
  encode_point(tables + (size_t)e * 2 * L * T, T, xs, ys, zs, c,
               out + (size_t)t * 2 * L * kTile, kTile, lane);
}

// -- gather route: per-(row, pair) lookups and their histogram ----------------
//
// A "row" is one (field, level): a (2, T) feature-major table slice and M
// hash indices (K corners x P points, flattened). gather_blend in
// ops/permuto.py takes this route for every shape the fused encode does not
// take (2D fields, point gradients).

// Replaces permuto_pallas.gather_pairs (_gather_kernel):
// out[r, f, m] = table[r, f, idx[r, m]], exact (a pure copy).
//
// Bound: bytes. Each pair streams an 8-byte index in and two 4-byte
// features out; at the 2D field set's shape (512 rows x 36,864 pairs,
// T = 4096) that is 302 MB, against 16 MB of tables, so the least time is
// the streams at the memory rate (0.095 ms at 3.35 TB/s). Reading the table
// through L2 costs two 32-byte sectors a pair (37.7M sector reads, ~1.2 GB
// of L2 traffic), and the tables compete in L2 with the streams. Design, as
// the TPU kernel stages each row's table in VMEM: a block serves one (row,
// chunk of at least kStagedPairs pairs); one thread copies the row's
// contiguous (2, T) table into shared memory with one bulk asynchronous
// copy completing on an mbarrier, while every thread loads its first
// indices; then every lookup reads shared memory. Each thread takes
// kLookups pairs a step: two 16-byte streaming index loads, the next step's
// indices loaded before this step's lookups, and one 16-byte streaming
// store into each feature row. Rows with M % 4 != 0 take the scalar
// variant. Index bounds are the caller's contract, as in JAX; the TPU's
// one-hot(idx>>6) x one-hot(idx&63) matmul existed because the TPU has no
// fast gather and is not carried over.
//
// The direct variant (gather_pairs_direct_kernel) reads the table through
// L2 and is the kernel's design for shapes where staging does not pay or
// does not fit: a table above kMaxStagedBytes (T > 12,288), an odd T or an
// unaligned table (the bulk copy moves 16-byte multiples between 16-byte
// aligned addresses), or rows so short that copying the table moves more
// bytes than the pairs' sectors would (T >= 8 M). The C entry point chooses
// by shape (gather_pairs_staged below).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Indices of one step of kLookups pairs at m (those at or past end read 0).
template <bool kVec>
__device__ __forceinline__ void load_step(const int64_t* ib, int m, int end,
                                          int64_t i[kLookups]) {
  if (kVec) {
    if (m < end) {
      const longlong2 a = load_index_pair(ib + m);
      const longlong2 b = load_index_pair(ib + m + 2);
      i[0] = a.x;
      i[1] = a.y;
      i[2] = b.x;
      i[3] = b.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLookups; ++k) i[k] = m + k < end ? load_index(ib + m + k) : 0;
  }
}

// Dynamic shared memory: the (2, T) table, then the mbarrier (8T is a
// multiple of 16, so the barrier is 8-byte aligned).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) gather_pairs_staged_kernel(
    const float* __restrict__ table, const int64_t* __restrict__ idx,
    float* __restrict__ out, int T, int M, int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float* stab = reinterpret_cast<const float*>(smem);
  const uint32_t bytes = 8u * (uint32_t)T;
  const uint32_t bar = smem_addr(smem + bytes);
  const int64_t r = blockIdx.x;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(smem)), "l"(table + r * 2 * T), "r"(bytes), "r"(bar) : "memory");
  }
  const int begin = blockIdx.y * chunk;
  const int end = min(M, begin + chunk);
  const int step = blockDim.x * kLookups;
  const int64_t* ib = idx + r * M;
  float* o0 = out + r * 2 * M;
  float* o1 = o0 + M;
  int m = begin + threadIdx.x * kLookups;
  int64_t i[kLookups] = {0, 0, 0, 0};
  load_step<kVec>(ib, m, end, i);  // while the table is in flight
  __syncthreads();                 // the barrier is initialised
  mbarrier_wait(bar, 0);
  for (; m < end; m += step) {
    int64_t next[kLookups] = {0, 0, 0, 0};
    load_step<kVec>(ib, m + step, end, next);
    float f0[kLookups];
    float f1[kLookups];
#pragma unroll
    for (int k = 0; k < kLookups; ++k) {
      f0[k] = stab[i[k]];
      f1[k] = stab[T + i[k]];
    }
    if (kVec) {
      __stcs(reinterpret_cast<float4*>(o0 + m), make_float4(f0[0], f0[1], f0[2], f0[3]));
      __stcs(reinterpret_cast<float4*>(o1 + m), make_float4(f1[0], f1[1], f1[2], f1[3]));
    } else {
#pragma unroll
      for (int k = 0; k < kLookups; ++k) {
        if (m + k < end) {
          __stcs(o0 + m + k, f0[k]);
          __stcs(o1 + m + k, f1[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kLookups; ++k) i[k] = next[k];
  }
}

// The direct variant: one thread per (row, m), grid x over m and grid y
// over rows (a row loop past the grid's y limit), both features read
// through L2.
__global__ void gather_pairs_direct_kernel(const float* __restrict__ table,
                                           const int64_t* __restrict__ idx,
                                           float* __restrict__ out, int T, int M,
                                           int rows) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* tab = table + r * 2 * T;
    const int64_t i = idx[r * M + m];
    float* o = out + r * 2 * M + m;
    o[0] = __ldg(tab + i);
    o[M] = __ldg(tab + T + i);
  }
}

bool gather_pairs_staged(const float* table, int T, int M) {
  return T > 0 && T % 2 == 0 && 8LL * T <= kMaxStagedBytes && (int64_t)T < 8LL * M &&
         aligned16(table);
}

// One step of kLookups pairs at m: indices and both values (pairs at or
// past end read index 0 and values 0, which add nothing).
template <bool kVec>
__device__ __forceinline__ void load_pairs(const int64_t* ib, const float* g0,
                                           const float* g1, int m, int end,
                                           int64_t i[kLookups], float v0[kLookups],
                                           float v1[kLookups]) {
  if (kVec) {
    if (m < end) {  // end and m are multiples of kLookups
      const longlong2 a = load_index_pair(ib + m);
      const longlong2 b = load_index_pair(ib + m + 2);
      const float4 x = __ldcs(reinterpret_cast<const float4*>(g0 + m));
      const float4 y = __ldcs(reinterpret_cast<const float4*>(g1 + m));
      i[0] = a.x;
      i[1] = a.y;
      i[2] = b.x;
      i[3] = b.y;
      v0[0] = x.x;
      v0[1] = x.y;
      v0[2] = x.z;
      v0[3] = x.w;
      v1[0] = y.x;
      v1[1] = y.y;
      v1[2] = y.z;
      v1[3] = y.w;
    } else {
#pragma unroll
      for (int k = 0; k < kLookups; ++k) {
        i[k] = 0;
        v0[k] = 0.0f;
        v1[k] = 0.0f;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLookups; ++k) {
      const bool in = m + k < end;
      i[k] = in ? load_index(ib + m + k) : 0;
      v0[k] = in ? __ldcs(g0 + m + k) : 0.0f;
      v1[k] = in ? __ldcs(g1 + m + k) : 0.0f;
    }
  }
}

// Replaces permuto_pallas.table_grad (_table_grad_kernel):
// grad[r, f, idx[r, m]] += gv[r, f, m] into a (rows, 2, T) output.
//
// Bound: bytes. Each pair streams an 8-byte index and two 4-byte values in;
// at the 2D field set's shape (512 rows x 36,864 pairs, T = 4096) that is
// 302 MB, plus the 16.8 MB histogram out, so the least time is 0.095 ms at
// 3.35 TB/s. The first design (now the direct variant) added every value
// into device memory with a global atomic, 37.7 M a call, which the L2's
// atomic units serialise where a coarse level puts many pairs on one entry.
// Design, as the TPU kernel keeps one (field, level) row in VMEM across its
// pair tiles: a block owns one row (grid x, so more than 65,535 rows need no
// loop) and a chunk of its pairs (grid y, hist_chunks), and keeps the row's
// (2, T) histogram in shared memory, which it zeroes itself (32 KB at
// T = 4096). Each thread takes kLookups pairs a step,
// as gather_pairs_staged_kernel: two 16-byte streaming index loads and one
// 16-byte streaming load of each value row, the next step's loads issued
// before this step's adds; the adds go to shared memory, aggregated within
// the warp (hist_add); a pair whose two values are zero adds nothing. Rows
// with M % 4 != 0 or unaligned inputs take the scalar loads. A block that
// owns its whole row writes all 2T entries with coalesced 16-byte stores,
// so the output needs no memset; where a row is split over blocks (few
// rows, many pairs), each adds its nonzero entries into a zeroed output.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) table_grad_staged_kernel(
    const int64_t* __restrict__ idx, const float* __restrict__ gv,
    float* __restrict__ grad, int T, int M, int chunk) {
  extern __shared__ __align__(16) float hist[];  // (2, T)
  const int64_t r = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * T; i += blockDim.x) hist[i] = 0.0f;
  const int begin = blockIdx.y * chunk;
  const int end = min(M, begin + chunk);
  const int step = blockDim.x * kLookups;
  const int64_t* ib = idx + r * M;
  const float* g0 = gv + r * 2 * M;
  const float* g1 = g0 + M;
  int m = begin + threadIdx.x * kLookups;
  int64_t i[kLookups];
  float v0[kLookups];
  float v1[kLookups];
  load_pairs<kVec>(ib, g0, g1, m, end, i, v0, v1);  // while the histogram is zeroed
  __syncthreads();
  for (int base = begin; base < end; base += step, m += step) {  // the same trips for every warp
    int64_t ni[kLookups];
    float n0[kLookups];
    float n1[kLookups];
    load_pairs<kVec>(ib, g0, g1, m + step, end, ni, n0, n1);
#pragma unroll
    for (int k = 0; k < kLookups; ++k) {
      const bool add = v0[k] != 0.0f || v1[k] != 0.0f;
      hist_add(hist, hist + T, add ? (uint32_t)i[k] : kNoKey, v0[k], v1[k]);
    }
#pragma unroll
    for (int k = 0; k < kLookups; ++k) {
      i[k] = ni[k];
      v0[k] = n0[k];
      v1[k] = n1[k];
    }
  }
  __syncthreads();
  float* row = grad + r * 2 * T;
  if (gridDim.y == 1) {
    store_hist_row(row, hist, 2 * T, 2 * T);
  } else {
    add_hist_row(row, hist, 2 * T);
  }
}

// The direct variant, for (2, T) histograms above kMaxStagedBytes
// (T > 12,288): one thread per (row, m) on the grid of
// gather_pairs_direct_kernel, both values added into the zeroed output with
// global atomics (the first design); pairs whose two values are zero are
// skipped.
__global__ void table_grad_kernel(const int64_t* __restrict__ idx,
                                  const float* __restrict__ gv,
                                  float* __restrict__ grad, int T, int M,
                                  int rows) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const float g0 = gv[r * 2 * M + m];
    const float g1 = gv[r * 2 * M + M + m];
    if (g0 == 0.0f && g1 == 0.0f) continue;
    const int64_t i = idx[r * M + m];
    float* gr = grad + r * 2 * T;
    atomicAdd(gr + i, g0);
    atomicAdd(gr + T + i, g1);
  }
}

// -- fused encode + MLP (the fused training route) ---------------------------
//
// The field MLP of the production shape: D = 2L features -> H hidden units
// (ReLU) -> O outputs, one hidden layer, no skip. Compile-time maxima (the
// production widths) keep every per-point vector in registers: loops run
// over the maxima, fully unrolled, and the shared weights are zero-padded,
// so padding units add exact zeros. The host entry points refuse larger
// widths.
constexpr int kMlpMaxLevels = 16;
constexpr int kMlpMaxD = 2 * kMlpMaxLevels;
constexpr int kMlpMaxH = 32;
constexpr int kMlpMaxO = 4;
constexpr int kMlpThreads = 128;
constexpr int kMlpPad = kMlpThreads + 1;  // shared row stride: no bank conflicts

// One field's weights, zero-padded to the maxima, into shared memory:
// sw0[d][j] (w0 is (D, H)), sb0[j], sw1[j][q] (w1 is (H, O)).
__device__ __forceinline__ void load_mlp_weights(
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ w1, int D, int H, int O,
    float (*sw0)[kMlpMaxH], float* sb0, float (*sw1)[kMlpMaxO]) {
  for (int e = threadIdx.x; e < kMlpMaxD * kMlpMaxH; e += blockDim.x) {
    const int d = e / kMlpMaxH;
    const int j = e - d * kMlpMaxH;
    sw0[d][j] = (d < D && j < H) ? w0[d * H + j] : 0.0f;
  }
  for (int e = threadIdx.x; e < kMlpMaxH * kMlpMaxO; e += blockDim.x) {
    const int j = e / kMlpMaxO;
    const int q = e - j * kMlpMaxO;
    sw1[j][q] = (j < H && q < O) ? w1[j * O + q] : 0.0f;
  }
  for (int j = threadIdx.x; j < kMlpMaxH; j += blockDim.x) sb0[j] = j < H ? b0[j] : 0.0f;
}

// Replaces permuto_pallas.encode_mlp_fwd (_encode_mlp_fwd_kernel):
// out[b, :, p] = w1^T relu(w0^T f + b0) + b1 with f = the encode of
// encode_fwd_kernel, and f written once as the (B, D, P) residual.
//
// Bound: the encode's random table gathers (as encode_fwd_kernel) plus the
// residual and outputs streamed once; the MLP's 2 x (D x H + H x O) f32
// operations a point are a few percent of the card's f32 rate at the
// training shape. Design: one thread per (field, point), grid y = field; the
// field's weights in shared memory (read as broadcasts), the D features and
// H hidden units in registers; plain fmaf products, no tensor cores. The
// TPU kernel's slab relayouts and ones-row bias folding are not carried
// over: the biases are added directly.
__global__ void __launch_bounds__(kMlpThreads) encode_mlp_fwd_kernel(
    const float* __restrict__ table, const float* __restrict__ coords,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ w1, const float* __restrict__ b1,
    float* __restrict__ out, float* __restrict__ feats, int P, int T, int H,
    int O, __grid_constant__ const LevelConsts c) {
  __shared__ float sw0[kMlpMaxD][kMlpMaxH];
  __shared__ float sb0[kMlpMaxH];
  __shared__ float sw1[kMlpMaxH][kMlpMaxO];
  const int b = blockIdx.y;
  const int L = c.n_levels;
  const int D = 2 * L;
  load_mlp_weights(w0 + (size_t)b * D * H, b0 + (size_t)b * H, w1 + (size_t)b * H * O,
                   D, H, O, sw0, sb0, sw1);
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t cbase = (size_t)b * kDim * P;
  const float x = coords[cbase + p];
  const float y = coords[cbase + P + p];
  const float z = coords[cbase + 2 * (size_t)P + p];
  const float* tab = table + (size_t)b * 2 * L * T;
  float* fo = feats + (size_t)b * D * P;
  float f[kMlpMaxD];
#pragma unroll
  for (int l = 0; l < kMlpMaxLevels; ++l) {
    float acc0 = 0.0f;
    float acc1 = 0.0f;
    if (l < L) {  // the blend of encode_point, kept in registers
      uint32_t idx[kCorners];
      float w[kCorners];
      lattice_level(x, y, z, c, l, idx, w);
      const float* t0 = tab + (size_t)l * T;
      const float* t1 = tab + (size_t)(L + l) * T;
      for (int k = 0; k < kCorners; ++k) {
        acc0 = acc0 + w[k] * __ldg(t0 + idx[k]);
        acc1 = acc1 + w[k] * __ldg(t1 + idx[k]);
      }
      fo[(size_t)(2 * l) * P + p] = acc0;
      fo[(size_t)(2 * l + 1) * P + p] = acc1;
    }
    f[2 * l] = acc0;
    f[2 * l + 1] = acc1;
  }
  float o[kMlpMaxO];
#pragma unroll
  for (int q = 0; q < kMlpMaxO; ++q) o[q] = q < O ? b1[(size_t)b * O + q] : 0.0f;
#pragma unroll
  for (int j = 0; j < kMlpMaxH; ++j) {
    float a = sb0[j];
#pragma unroll
    for (int d = 0; d < kMlpMaxD; ++d) a = fmaf(sw0[d][j], f[d], a);
    a = fmaxf(a, 0.0f);
#pragma unroll
    for (int q = 0; q < kMlpMaxO; ++q) o[q] = fmaf(sw1[j][q], a, o[q]);
  }
  float* ob = out + (size_t)b * O * P;
#pragma unroll
  for (int q = 0; q < kMlpMaxO; ++q) {
    if (q < O) ob[(size_t)q * P + p] = o[q];
  }
}

// Replaces permuto_pallas.encode_mlp_bwd (_encode_mlp_bwd_kernel): the MLP
// backward from the residual f and the head cotangent g, then the table
// histogram driven by dL/df, which stays in registers and never reaches
// device memory. The histogram keeps the first design of encode_bwd_table:
// every corner value goes into the zeroed gradient with a global atomicAdd
// (today encode_bwd_table_kernel, the direct variant), not the staged
// per-level histogram of encode_bwd_table_staged_kernel.
//
// Bound: the histogram's global atomics, which the L2 serialises on the
// coarse levels, after streaming the residual, g and the coordinates once.
// Design: one thread per (field, point), grid y = field, kMlpThreads points
// a block. Each thread
// recomputes its pre-activations, then the block reduces its points' weight
// gradients in shared memory: the columns h / dL/da0, f and g of its points
// go to shared memory (row stride kMlpPad, conflict-free), every thread
// sums a few weight entries over the block's points, and adds each to the
// zeroed global gradient with one atomicAdd a block. Points past P carry a
// zero cotangent, so they add nothing, and take no part in the histogram.
__global__ void __launch_bounds__(kMlpThreads) encode_mlp_bwd_kernel(
    const float* __restrict__ coords, const float* __restrict__ feats,
    const float* __restrict__ g, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ w1,
    float* __restrict__ grad_table, float* __restrict__ dw0,
    float* __restrict__ db0, float* __restrict__ dw1, float* __restrict__ db1,
    int P, int T, int H, int O, __grid_constant__ const LevelConsts c) {
  __shared__ float sw0[kMlpMaxD][kMlpMaxH];
  __shared__ float sb0[kMlpMaxH];
  __shared__ float sw1[kMlpMaxH][kMlpMaxO];
  __shared__ float sF[kMlpMaxD][kMlpPad];  // features of the block's points
  __shared__ float sA[kMlpMaxH][kMlpPad];  // h, then dL/da0
  __shared__ float sG[kMlpMaxO][kMlpPad];  // head cotangent
  const int b = blockIdx.y;
  const int L = c.n_levels;
  const int D = 2 * L;
  const int t = threadIdx.x;
  const int n = blockDim.x;
  load_mlp_weights(w0 + (size_t)b * D * H, b0 + (size_t)b * H, w1 + (size_t)b * H * O,
                   D, H, O, sw0, sb0, sw1);
  const int p = blockIdx.x * blockDim.x + t;
  const bool live = p < P;
  const float* fb = feats + (size_t)b * D * P;
  const float* gb = g + (size_t)b * O * P;
  float f[kMlpMaxD];
#pragma unroll
  for (int d = 0; d < kMlpMaxD; ++d) {
    f[d] = (live && d < D) ? fb[(size_t)d * P + p] : 0.0f;
    sF[d][t] = f[d];
  }
  float gg[kMlpMaxO];
#pragma unroll
  for (int q = 0; q < kMlpMaxO; ++q) {
    gg[q] = (live && q < O) ? gb[(size_t)q * P + p] : 0.0f;
    sG[q][t] = gg[q];
  }
  __syncthreads();  // the weights are in shared memory
  float a0[kMlpMaxH];
#pragma unroll
  for (int j = 0; j < kMlpMaxH; ++j) {
    float a = sb0[j];
#pragma unroll
    for (int d = 0; d < kMlpMaxD; ++d) a = fmaf(sw0[d][j], f[d], a);
    a0[j] = a;
    sA[j][t] = fmaxf(a, 0.0f);
  }
  __syncthreads();
  // dw1[j][q] = sum_points h[j] g[q]; db1[q] = sum_points g[q]
  for (int e = t; e < (H + 1) * O; e += n) {
    const int j = e / O;
    const int q = e - j * O;
    float s = 0.0f;
    if (j < H) {
      for (int u = 0; u < n; ++u) s = fmaf(sA[j][u], sG[q][u], s);
      atomicAdd(dw1 + (size_t)b * H * O + j * O + q, s);
    } else {
      for (int u = 0; u < n; ++u) s = s + sG[q][u];
      atomicAdd(db1 + (size_t)b * O + q, s);
    }
  }
  __syncthreads();  // every thread is done reading h
#pragma unroll
  for (int j = 0; j < kMlpMaxH; ++j) {
    float dh = 0.0f;
#pragma unroll
    for (int q = 0; q < kMlpMaxO; ++q) dh = fmaf(sw1[j][q], gg[q], dh);
    a0[j] = a0[j] > 0.0f ? dh : 0.0f;  // now dL/da0
    sA[j][t] = a0[j];
  }
  __syncthreads();
  // dw0[d][j] = sum_points f[d] da0[j]; db0[j] = sum_points da0[j]
  for (int e = t; e < (D + 1) * H; e += n) {
    const int d = e / H;
    const int j = e - d * H;
    float s = 0.0f;
    if (d < D) {
      for (int u = 0; u < n; ++u) s = fmaf(sF[d][u], sA[j][u], s);
      atomicAdd(dw0 + (size_t)b * D * H + d * H + j, s);
    } else {
      for (int u = 0; u < n; ++u) s = s + sA[j][u];
      atomicAdd(db0 + (size_t)b * H + j, s);
    }
  }
  if (!live) return;
  const size_t cbase = (size_t)b * kDim * P;
  const float x = coords[cbase + p];
  const float y = coords[cbase + P + p];
  const float z = coords[cbase + 2 * (size_t)P + p];
  float* gr = grad_table + (size_t)b * 2 * L * T;
#pragma unroll
  for (int l = 0; l < kMlpMaxLevels; ++l) {
    if (l < L) {
      float g0 = 0.0f;  // dL/df of the level's two features
      float g1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kMlpMaxH; ++j) {
        g0 = fmaf(sw0[2 * l][j], a0[j], g0);
        g1 = fmaf(sw0[2 * l + 1][j], a0[j], g1);
      }
      if (g0 == 0.0f && g1 == 0.0f) continue;  // nothing to add
      uint32_t idx[kCorners];
      float w[kCorners];
      lattice_level(x, y, z, c, l, idx, w);
      float* r0 = gr + (size_t)l * T;
      float* r1 = gr + (size_t)(L + l) * T;
      for (int k = 0; k < kCorners; ++k) {
        atomicAdd(r0 + idx[k], w[k] * g0);
        atomicAdd(r1 + idx[k], w[k] * g1);
      }
    }
  }
}

int fill_consts(LevelConsts* c, int L, const float* scales, const float* shifts,
                const float* elev, const int* caps) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  c->n_levels = L;
  for (int l = 0; l < L; ++l) {
    c->scale[l] = scales[l];
    for (int i = 0; i < kDim; ++i) c->shift[l][i] = shifts[l * kDim + i];
    c->mask[l] = (uint32_t)(caps[l] - 1);
  }
  for (int i = 0; i < kDim; ++i) c->elev[i] = elev[i];
  return 0;
}

bool mlp_widths_ok(int L, int H, int O) {
  return L >= 1 && L <= kMlpMaxLevels && H >= 1 && H <= kMlpMaxH && O >= 1 && O <= kMlpMaxO;
}

// Blocks along each row of a staged histogram, or 0 where the (2, T)
// histogram does not fit the staged budget and the direct variant runs.
// A function of the shapes only.
int table_grad_chunks(int rows, int T, int M) {
  if (T < 1 || 8LL * T > kMaxStagedBytes) return 0;
  return hist_chunks(rows, M, kStagedPairs);
}

int encode_bwd_table_chunks(int B, int L, int P, int T) {
  if (T < 1 || 8LL * T > kMaxStagedBytes) return 0;
  return hist_chunks((int64_t)B * L, P, kStagedPoints);
}

// What the caller must allocate for a call with `chunks` blocks a row: 0 and
// 2 add into a zeroed output (the direct variant; a staged row split over
// blocks), 1 writes every entry (one staged block a row).
int plan_of(int chunks) { return chunks <= 1 ? chunks : 2; }

}  // namespace

extern "C" {

int ngm_encode_fwd(const float* table, const float* coords, float* out, int B,
                   int P, int L, int T, const float* scales, const float* shifts,
                   const float* elev, const int* caps, void* stream) {
  LevelConsts c;
  const int err = fill_consts(&c, L, scales, shifts, elev, caps);
  if (err) return err;
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  encode_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(table, coords,
                                                                 out, P, T, c);
  return (int)cudaGetLastError();
}

// 0: ngm_encode_bwd_table takes the direct variant; 1: staged, one block a
// (field, level), which writes every entry (the output needs no zeroing);
// 2: staged, the points split over blocks (a zeroed output).
int ngm_encode_bwd_table_plan(int B, int L, int P, int T) {
  return plan_of(encode_bwd_table_chunks(B, L, P, T));
}

// coords (B, 3, P), g (B, 2L, P) -> grad (B, 2, L, T), zeroed by the caller
// unless ngm_encode_bwd_table_plan gives 1.
int ngm_encode_bwd_table(const float* coords, const float* g, float* grad, int B,
                         int P, int L, int T, const float* scales,
                         const float* shifts, const float* elev, const int* caps,
                         void* stream) {
  LevelConsts c;
  const int err = fill_consts(&c, L, scales, shifts, elev, caps);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int chunks = encode_bwd_table_chunks(B, L, P, T);
  if (chunks == 0) {
    const dim3 grid((P + kThreads - 1) / kThreads, B);
    encode_bwd_table_kernel<<<grid, kThreads, 0, s>>>(coords, g, grad, P, T, c);
  } else {
    const int chunk = (P + chunks - 1) / chunks;
    const dim3 grid((unsigned)((int64_t)B * L), (P + chunk - 1) / chunk);
    const size_t smem = 8 * (size_t)T;
    encode_bwd_table_staged_kernel<<<grid, kBwdThreads, smem, s>>>(coords, g, grad, P, T, chunk, c);
  }
  return (int)cudaGetLastError();
}

// Once, after the library is loaded: reads the card's SM count (hist_chunks)
// and lets the staged kernels use more than 48 KB of dynamic shared memory.
int ngm_permuto_init() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount, dev);
  }
  const void* staged[] = {
      reinterpret_cast<const void*>(&gather_pairs_staged_kernel<true>),
      reinterpret_cast<const void*>(&gather_pairs_staged_kernel<false>),
      reinterpret_cast<const void*>(&table_grad_staged_kernel<true>),
      reinterpret_cast<const void*>(&table_grad_staged_kernel<false>),
      reinterpret_cast<const void*>(&encode_bwd_table_staged_kernel),
  };
  for (const void* kernel : staged) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxStagedBytes + 16);
    }
  }
  return (int)err;
}

// values (B, N) f32, idx (B, M) int64 -> out (B, M).
int ngm_batched_gather(const float* values, const int64_t* idx, float* out, int B,
                       int N, int M, void* stream) {
  const int groups = (M + kLookups - 1) / kLookups;
  const int threads = std::min(kThreads, (groups + 31) / 32 * 32);  // no empty warps at short M
  const dim3 grid((groups + threads - 1) / threads, B < kMaxGridY ? B : kMaxGridY);
  const cudaStream_t s = (cudaStream_t)stream;
  if (M % kLookups == 0 && aligned16(idx) && aligned16(out)) {
    batched_gather_kernel<true><<<grid, threads, 0, s>>>(values, idx, out, B, N, M);
  } else {
    batched_gather_kernel<false><<<grid, threads, 0, s>>>(values, idx, out, B, N, M);
  }
  return (int)cudaGetLastError();
}

// tables (N, 2, L, T), coords (tiles, 3, kTile), tile_experts (tiles,) int32,
// num_live () int32 on the device -> out (tiles, 2L, kTile).
int ngm_encode_fwd_moe(const float* tables, const float* coords,
                       const int* tile_experts, const int* num_live, float* out,
                       int tiles, int L, int T, const float* scales,
                       const float* shifts, const float* elev, const int* caps,
                       void* stream) {
  LevelConsts c;
  const int err = fill_consts(&c, L, scales, shifts, elev, caps);
  if (err) return err;
  const dim3 grid(tiles, kTile / kThreads);
  encode_fwd_moe_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tables, coords, tile_experts, num_live, out, T, c);
  return (int)cudaGetLastError();
}

// tables (N, 2, L, T), orig (tiles, kTile) int32 k-minor pair indices, dist
// (tiles, kTile), tile_experts (tiles,), num_live (), rayp (16,), poses
// (N, 7), all on the device -> out (tiles, 2L, kTile).
int ngm_encode_fwd_moe_rays(const float* tables, const int* orig,
                            const float* dist, const int* tile_experts,
                            const int* num_live, const float* rayp,
                            const float* poses, float* out, int tiles, int L,
                            int T, int block_offset, int log2_ks, int width,
                            float coord_scale, float coord_shift,
                            const float* scales, const float* shifts,
                            const float* elev, const int* caps, void* stream) {
  LevelConsts c;
  const int err = fill_consts(&c, L, scales, shifts, elev, caps);
  if (err) return err;
  if (width < 1 || log2_ks < 0 || log2_ks > 30) return (int)cudaErrorInvalidValue;
  const RayConsts rc = {block_offset, log2_ks, width, coord_scale, coord_shift};
  const dim3 grid(tiles, kTile / kThreads);
  encode_fwd_moe_rays_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tables, orig, dist, tile_experts, num_live, rayp, poses, out, T, rc, c);
  return (int)cudaGetLastError();
}

// 1 if ngm_gather_pairs takes the staged variant for this table, else 0.
int ngm_gather_pairs_staged(const float* table, int T, int M) {
  return gather_pairs_staged(table, T, M) ? 1 : 0;
}

// table (rows, 2, T), idx (rows, M) int64 -> out (rows, 2, M).
int ngm_gather_pairs(const float* table, const int64_t* idx, float* out, int rows,
                     int T, int M, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (gather_pairs_staged(table, T, M)) {
    // grid x = rows (up to 2^31 - 1), y = chunks of at least kStagedPairs
    // pairs, a multiple of kLookups
    const int chunks = std::max(1, std::min(kMaxGridY, M / kStagedPairs));
    const int chunk = ((M + chunks - 1) / chunks + kLookups - 1) / kLookups * kLookups;
    const dim3 grid(rows, (M + chunk - 1) / chunk);
    const size_t smem = 8 * (size_t)T + 16;
    if (M % kLookups == 0 && aligned16(idx) && aligned16(out)) {
      gather_pairs_staged_kernel<true><<<grid, kThreads, smem, s>>>(table, idx, out, T, M, chunk);
    } else {
      gather_pairs_staged_kernel<false><<<grid, kThreads, smem, s>>>(table, idx, out, T, M, chunk);
    }
  } else {
    const dim3 grid((M + kThreads - 1) / kThreads, rows < kMaxGridY ? rows : kMaxGridY);
    gather_pairs_direct_kernel<<<grid, kThreads, 0, s>>>(table, idx, out, T, M, rows);
  }
  return (int)cudaGetLastError();
}

// 0: ngm_table_grad takes the direct variant; 1: staged, one block a row,
// which writes every entry (the output needs no zeroing); 2: staged, rows
// split over blocks (a zeroed output).
int ngm_table_grad_plan(int rows, int T, int M) {
  return plan_of(table_grad_chunks(rows, T, M));
}

// idx (rows, M) int64, gv (rows, 2, M) -> grad (rows, 2, T), zeroed by the
// caller unless ngm_table_grad_plan gives 1.
int ngm_table_grad(const int64_t* idx, const float* gv, float* grad, int rows, int T,
                   int M, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int chunks = table_grad_chunks(rows, T, M);
  if (chunks == 0) {
    const dim3 grid((M + kThreads - 1) / kThreads, rows < kMaxGridY ? rows : kMaxGridY);
    table_grad_kernel<<<grid, kThreads, 0, s>>>(idx, gv, grad, T, M, rows);
  } else {
    // grid x = rows (up to 2^31 - 1), y = chunks, each a multiple of kLookups
    const int chunk = ((M + chunks - 1) / chunks + kLookups - 1) / kLookups * kLookups;
    const dim3 grid(rows, (M + chunk - 1) / chunk);
    const size_t smem = 8 * (size_t)T;
    if (M % kLookups == 0 && aligned16(idx) && aligned16(gv)) {
      table_grad_staged_kernel<true><<<grid, kThreads, smem, s>>>(idx, gv, grad, T, M, chunk);
    } else {
      table_grad_staged_kernel<false><<<grid, kThreads, smem, s>>>(idx, gv, grad, T, M, chunk);
    }
  }
  return (int)cudaGetLastError();
}

// table (B, 2, L, T), coords (B, 3, P), w0 (B, 2L, H), b0 (B, H), w1 (B, H, O),
// b1 (B, O) -> out (B, O, P), feats (B, 2L, P).
int ngm_encode_mlp_fwd(const float* table, const float* coords, const float* w0,
                       const float* b0, const float* w1, const float* b1, float* out,
                       float* feats, int B, int P, int L, int T, int H, int O,
                       const float* scales, const float* shifts, const float* elev,
                       const int* caps, void* stream) {
  if (!mlp_widths_ok(L, H, O)) return (int)cudaErrorInvalidValue;
  LevelConsts c;
  const int err = fill_consts(&c, L, scales, shifts, elev, caps);
  if (err) return err;
  const dim3 grid((P + kMlpThreads - 1) / kMlpThreads, B);
  encode_mlp_fwd_kernel<<<grid, kMlpThreads, 0, (cudaStream_t)stream>>>(
      table, coords, w0, b0, w1, b1, out, feats, P, T, H, O, c);
  return (int)cudaGetLastError();
}

// coords (B, 3, P), feats (B, 2L, P), g (B, O, P), w0, b0, w1 as above ->
// grad_table (B, 2, L, T), dw0 (B, 2L, H), db0 (B, H), dw1 (B, H, O),
// db1 (B, O), every output zeroed by the caller.
int ngm_encode_mlp_bwd(const float* coords, const float* feats, const float* g,
                       const float* w0, const float* b0, const float* w1,
                       float* grad_table, float* dw0, float* db0, float* dw1,
                       float* db1, int B, int P, int L, int T, int H, int O,
                       const float* scales, const float* shifts, const float* elev,
                       const int* caps, void* stream) {
  if (!mlp_widths_ok(L, H, O)) return (int)cudaErrorInvalidValue;
  LevelConsts c;
  const int err = fill_consts(&c, L, scales, shifts, elev, caps);
  if (err) return err;
  const dim3 grid((P + kMlpThreads - 1) / kMlpThreads, B);
  encode_mlp_bwd_kernel<<<grid, kMlpThreads, 0, (cudaStream_t)stream>>>(
      coords, feats, g, w0, b0, w1, grad_table, dw0, db0, dw1, db1, P, T, H, O, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
