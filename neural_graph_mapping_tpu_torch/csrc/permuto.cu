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

// The field MLP of the production shape: D = 2L features -> H hidden units
// (ReLU) -> O outputs, one hidden layer, no skip. Compile-time maxima (the
// production widths) keep every per-point vector in registers: loops run
// over the maxima, fully unrolled, and the shared weights are zero-padded,
// so padding units add exact zeros. The host entry points refuse larger
// widths. The fused training route and the render's MoE encode with its
// MLP epilogue take these widths.
constexpr int kMlpMaxLevels = 16;
constexpr int kMlpMaxD = 2 * kMlpMaxLevels;
constexpr int kMlpMaxH = 32;
constexpr int kMlpMaxO = 4;

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

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

// The corner hash's primes, one a coordinate (immediates once unrolled).
__host__ __device__ constexpr uint32_t hash_prime(int i) {
  return i == 0 ? 1u : (i == 1 ? 2654435761u : 805459861u);
}

// Rounds an elevated point to the nearest remainder-0 lattice point and
// ranks the residuals from the largest (rank 0; equal residuals in index
// order) -> rem0, rank, and the remainder sum.
__device__ __forceinline__ float lattice_round_and_rank(const float elevated[kCorners],
                                                        float rem0[kCorners], int rank[kCorners]) {
  const float down = 1.0f / (float)(kDim + 1);
  float diff[kCorners];
  float rem_sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kCorners; ++i) {
    rem0[i] = rintf(elevated[i] * down) * (float)(kDim + 1);
    diff[i] = elevated[i] - rem0[i];
    rank[i] = 0;
    rem_sum = rem_sum + rem0[i];
  }
#pragma unroll
  for (int i = 0; i < kCorners; ++i) {
#pragma unroll
    for (int j = i + 1; j < kCorners; ++j) {
      const int smaller = diff[i] < diff[j];
      rank[i] += smaller;
      rank[j] += 1 - smaller;
    }
  }
  return rem_sum;
}

// Corner indices and barycentric weights of one point at one level.
struct Corners {
  uint32_t idx[kCorners];
  float w[kCorners];
};

// lattice_level for the points its short form cannot take: the plain
// version's own form, fix-up by branches and the barycentric sums as
// bary[b] = (bary[b] + (hit ? v : 0)) - (hit' ? v : 0) over the corners in
// order. Out of line, so a kernel that unrolls several levels carries one
// copy of it, not one a level (the direct encode_fwd: 1,725 SASS
// instructions, 2,289 with the copies inline).
__device__ __noinline__ Corners lattice_level_select_form(float e0, float e1, float e2, float e3,
                                                          uint32_t mask) {
  const float elevated[kCorners] = {e0, e1, e2, e3};
  const float down = 1.0f / (float)(kDim + 1);
  float rem0[kCorners];
  int rank[kCorners];
  const int s = (int)rintf(lattice_round_and_rank(elevated, rem0, rank) * down);
#pragma unroll
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
#pragma unroll
  for (int i = 0; i < kCorners; ++i) {
    const float v = (elevated[i] - rem0[i]) * down;
#pragma unroll
    for (int b = 0; b < kDim + 2; ++b) {
      bary[b] = (bary[b] + (kDim - rank[i] == b ? v : 0.0f)) - (kDim + 1 - rank[i] == b ? v : 0.0f);
    }
  }
  bary[0] = (bary[0] + 1.0f) + bary[kDim + 1];

  Corners out;
#pragma unroll
  for (int k = 0; k < kCorners; ++k) {
    uint32_t h = 0u;
#pragma unroll
    for (int i = 0; i < kDim; ++i) {
      const int offset = rank[i] < (kDim + 1 - k) ? k : k - (kDim + 1);
      const int key = (int)rem0[i] + offset;
      h ^= (uint32_t)key * hash_prime(i);  // wraps mod 2^32, as uint32 does
    }
    out.idx[k] = h & mask;
    out.w[k] = bary[k];
  }
  return out;
}

// The permutohedral lattice of one point at one level: hash-table indices of
// the d+1 enclosing simplex corners and their barycentric weights. Same
// arithmetic, in the same order, as lattice_keys_and_weights_soa in
// ops/permuto.py (Adams, Baek, Davis 2010): elevate onto the sum-zero
// hyperplane, round to the nearest remainder-0 point (rintf: half to even,
// like torch.round and jnp.round), rank the residuals, fix points rounded
// off the hyperplane, then weights and corner hashes.
//
// Every array here is indexed by compile-time constants once the loops are
// unrolled, so all of it lives in registers (an array indexed by a runtime
// rank went to local memory, PERF.md §6). The kernels that call this spent
// most of their time issuing its instructions (PERF.md §6: 410 SASS
// instructions a level, issued at 85% of an H100's rate in the ray
// encode), so the steps are written to take few of them (~280 a level on
// the usual path) and give the same floats:
// - The fix-up is selects, not branches.
// - The ranks are a permutation of 0..d, and the fix-up shifts them
//   cyclically, so bin b of the barycentric sums receives exactly one +v
//   (from the corner of rank d - b) and one -v (rank d + 1 - b); the
//   plain version's select form adds only exact zeros besides, so
//   bary[b] = (0 + v_a) - v_b, rounded once, whichever comes first. The
//   corner of each rank is picked by three selects (the inverse
//   permutation) instead of 40 select-and-add pairs.
// - The corner hashes add a rank-dependent offset to each rounded
//   coordinate: offset_i(k) = ((rank_i + k) mod (d + 1)) - rank_i.
// The ranks are a permutation where every residual is a number (else a
// comparison with NaN breaks the order) and the shift s is in [-(d+1), d+1]
// (else the fix-up leaves ranks outside 0..d): both hold where the
// remainder sum is within (d+1)^2, and it is within 2(d+1) unless the
// elevated sums lose whole units (coordinates some 2^22 lattice cells
// out). Any other point takes lattice_level_select_form.
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
#pragma unroll
  for (int i = kDim - 1; i >= 0; --i) suffix[i] = suffix[i + 1] + cf[i];
  float elevated[kCorners];
  elevated[0] = suffix[0];
#pragma unroll
  for (int i = 1; i <= kDim; ++i) elevated[i] = suffix[i] - (float)i * cf[i - 1];

  const float down = 1.0f / (float)(kDim + 1);
  float rem0[kCorners];
  int rank[kCorners];
  const float rem_sum = lattice_round_and_rank(elevated, rem0, rank);
  if (!(fabsf(rem_sum) <= (float)(kCorners * (kDim + 1)))) {
    const Corners plain = lattice_level_select_form(elevated[0], elevated[1], elevated[2], elevated[3],
                                                    c.mask[l]);
#pragma unroll
    for (int k = 0; k < kCorners; ++k) {
      idx[k] = plain.idx[k];
      w[k] = plain.w[k];
    }
    return;
  }
  const int s = (int)rintf(rem_sum * down);
#pragma unroll
  for (int i = 0; i < kCorners; ++i) {
    const int r = rank[i] + s;
    const bool low = r < 0;
    const bool high = r > kDim;
    rank[i] = r & kDim;  // r + 4, r - 4 or r: r is in [-4, 7]
    const float up = rem0[i] + (float)(kDim + 1);
    const float dn = rem0[i] - (float)(kDim + 1);
    rem0[i] = low ? up : (high ? dn : rem0[i]);
  }
  float v[kCorners];
#pragma unroll
  for (int i = 0; i < kCorners; ++i) v[i] = (elevated[i] - rem0[i]) * down;
  float by_rank[kCorners];  // by_rank[q] = v of the corner of rank q
#pragma unroll
  for (int q = 0; q < kCorners; ++q) {
    float t = v[kDim];
#pragma unroll
    for (int i = kDim - 1; i >= 0; --i) t = rank[i] == q ? v[i] : t;
    by_rank[q] = t;
  }
  // bary[0] = ((0 + v_rank3) + 1) + (0 - v_rank0): adding the exact zeros
  // leaves v_rank3 + 1 and subtracts v_rank0 once
  w[0] = (by_rank[kDim] + 1.0f) - by_rank[0];
#pragma unroll
  for (int k = 1; k < kCorners; ++k) w[k] = (0.0f + by_rank[kDim - k]) - by_rank[kDim + 1 - k];
#pragma unroll
  for (int k = 0; k < kCorners; ++k) {
    uint32_t h = 0u;
#pragma unroll
    for (int i = 0; i < kDim; ++i) {
      const uint32_t key = (uint32_t)(int)rem0[i] - (uint32_t)rank[i] + (uint32_t)((rank[i] + k) & kDim);
      h ^= key * hash_prime(i);  // wraps mod 2^32, as uint32 does
    }
    idx[k] = h & c.mask[l];
  }
}

// p itself, hidden from the compiler's address arithmetic: a read at
// opaque(p) + i is one address instruction, where the compiler would
// otherwise rebuild p's 64-bit sum at every read.
template <class T>
__device__ __forceinline__ const T* opaque(const T* p) {
  asm("" : "+l"(p));
  return p;
}

// One level of one point from one field's feature-major (2, L, T) table,
// read through L2: f_f = sum_k w_k * tab[f, l, idx_k]. Feature 1's row is
// addressed from feature 0's by a 32-bit offset (one address instruction a
// read).
__device__ __forceinline__ void level_features(const float* __restrict__ tab, int T, int L, int l,
                                               float x, float y, float z, const LevelConsts& c,
                                               float& acc0, float& acc1) {
  uint32_t idx[kCorners];
  float w[kCorners];
  lattice_level(x, y, z, c, l, idx, w);
  const float* t0 = opaque(tab + (size_t)l * T);
  const uint32_t f1 = (uint32_t)L * (uint32_t)T;
  acc0 = 0.0f;
  acc1 = 0.0f;
#pragma unroll
  for (int k = 0; k < kCorners; ++k) {
    acc0 = acc0 + w[k] * __ldg(t0 + idx[k]);
    acc1 = acc1 + w[k] * __ldg(t0 + (idx[k] + f1));
  }
}

// level_features stored: o[(2l + f) * stride + p].
__device__ __forceinline__ void encode_level(const float* __restrict__ tab, int T, int L, int l,
                                             float x, float y, float z, const LevelConsts& c,
                                             float* __restrict__ o, size_t stride, int p) {
  float acc0, acc1;
  level_features(tab, T, L, l, x, y, z, c, acc0, acc1);
  o[(size_t)(2 * l) * stride + p] = acc0;
  o[(size_t)(2 * l + 1) * stride + p] = acc1;
}

// All levels of one point (the MoE encodes).
__device__ __forceinline__ void encode_point(const float* __restrict__ tab, int T,
                                             float x, float y, float z,
                                             const LevelConsts& c,
                                             float* __restrict__ o,
                                             size_t stride, int p) {
  const int L = c.n_levels;
  for (int l = 0; l < L; ++l) encode_level(tab, T, L, l, x, y, z, c, o, stride, p);
}

// Replaces permuto_pallas.encode_fwd (_encode_fwd_kernel): the fused
// permutohedral encode, out[b, 2l+f, p] = sum_k w_k * table[b, f, l, idx_k].
//
// Bound: bytes, the 16 MiB of training tables, the coordinates and the
// features out once (0.021 ms at 3.35 TB/s at the training shape, 32 fields
// x 12,288 points x 16 levels). What limited the first design (one thread a
// (field, point) walking all 16 levels) was, measured by A/B on an H100,
// first the lattice's bary array, which a runtime index put in local
// memory (24 bytes of stack, 12 LDL and 12 STL a level): 2.2-2.8x a
// design's time; then its ~50 M random 4-byte table reads a call through
// L2, each a 32-byte sector (two a corner, whose two features lie L x T
// floats apart): ~1.4x. Design, as the TPU kernel holds a field's table in
// VMEM: encode_fwd_staged_kernel gives a block one (field, level) and a
// chunk of points (grid x = field * L + level, y = chunks by hist_chunks,
// as encode_bwd_table_staged_kernel) and copies that level's two feature
// rows, (2, cap_l) f32, 4-32 KB, into shared memory with coalesced 16-byte
// loads; every corner is then read from shared memory. Each thread takes
// every blockDim-th point: coordinates coalesced from (B, 3, P) (read once
// a level, from L2, where the 4.7 MB stay), the next point's loads issued
// before this point's work, lattice_level for the block's level, and one
// coalesced store a feature. Tables whose (2, T) rows exceed
// kMaxStagedBytes (T > 12,288) take the direct variant, encode_fwd_kernel:
// one thread a (field, point, group of kFwdDirectLevels levels), grid
// (points, level groups, fields), corners read through L2; 4 levels a
// thread was the fastest of 1, 2, 4 and 16 in an A/B on an H100 (PERF.md §6).
// Its blocks take 1024 points: the larger the block, the fewer (field,
// level group) tables an SM's blocks read at once and the more of their
// corners its L1 holds; 256, 384, 512, 768 and 1024 threads took 0.274,
// 0.252, 0.227, 0.184 and 0.158 ms at 32 fields x 12,288 points, T = 16,384
// (PERF.md §6).
// The TPU's 128-lane chunk sweep and bf16 pair packing existed to emulate a
// gather the TPU lacks and are not carried over.
constexpr int kFwdThreads = 512;  // 16 warps a (field, level) block
constexpr int kFwdDirectLevels = 4;
constexpr int kFwdDirectThreads = 1024;

__global__ void __launch_bounds__(kFwdThreads) encode_fwd_staged_kernel(
    const float* __restrict__ table, const float* __restrict__ coords,
    float* __restrict__ out, int P, int T, int chunk,
    __grid_constant__ const LevelConsts c) {
  extern __shared__ __align__(16) float stab[];  // (2, cap_l)
  const int L = c.n_levels;
  const int b = blockIdx.x / L;
  const int l = blockIdx.x - b * L;
  const int cap = (int)c.mask[l] + 1;
  const float* t0 = table + ((size_t)b * 2 * L + l) * T;  // table[b, 0, l, :]
  const float* t1 = t0 + (size_t)L * T;                   // table[b, 1, l, :]
  if (cap % 4 == 0 && aligned16(t0) && aligned16(t1)) {
    for (int i = 4 * threadIdx.x; i < cap; i += 4 * blockDim.x) {
      *reinterpret_cast<float4*>(stab + i) = __ldg(reinterpret_cast<const float4*>(t0 + i));
      *reinterpret_cast<float4*>(stab + cap + i) = __ldg(reinterpret_cast<const float4*>(t1 + i));
    }
  } else {
    for (int i = threadIdx.x; i < cap; i += blockDim.x) {
      stab[i] = __ldg(t0 + i);
      stab[cap + i] = __ldg(t1 + i);
    }
  }
  const int begin = blockIdx.y * chunk;
  const int end = min(P, begin + chunk);
  const float* xyz = coords + (size_t)b * kDim * P;
  float* o0 = out + ((size_t)b * 2 * L + 2 * l) * P;
  float* o1 = o0 + P;
  int p = begin + threadIdx.x;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (p < end) {  // while the table is copied
    x = xyz[p];
    y = xyz[P + p];
    z = xyz[2 * (size_t)P + p];
  }
  __syncthreads();
  for (; p < end; p += blockDim.x) {
    const int pn = p + blockDim.x;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (pn < end) {
      nx = xyz[pn];
      ny = xyz[P + pn];
      nz = xyz[2 * (size_t)P + pn];
    }
    uint32_t idx[kCorners];
    float w[kCorners];
    lattice_level(x, y, z, c, l, idx, w);
    float acc0 = 0.0f;
    float acc1 = 0.0f;
#pragma unroll
    for (int k = 0; k < kCorners; ++k) {
      acc0 = acc0 + w[k] * stab[idx[k]];
      acc1 = acc1 + w[k] * stab[cap + idx[k]];
    }
    o0[p] = acc0;
    o1[p] = acc1;
    x = nx;
    y = ny;
    z = nz;
  }
}

__global__ void __launch_bounds__(kFwdDirectThreads) encode_fwd_kernel(
    const float* __restrict__ table, const float* __restrict__ coords, float* __restrict__ out, int P,
    int T, __grid_constant__ const LevelConsts c) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int l0 = blockIdx.y * kFwdDirectLevels;
  const int b = blockIdx.z;
  if (p >= P) return;
  const size_t cbase = (size_t)b * kDim * P;
  const float x = coords[cbase + p];
  const float y = coords[cbase + P + p];
  const float z = coords[cbase + 2 * (size_t)P + p];
  const int L = c.n_levels;
  const float* tab = table + (size_t)b * 2 * L * T;
  float* o = out + (size_t)b * 2 * L * P;
#pragma unroll
  for (int i = 0; i < kFwdDirectLevels; ++i) {
    if (l0 + i < L) encode_level(tab, T, L, l0 + i, x, y, z, c, o, P, p);
  }
}

// Writes lattice_level's corners for N points x L levels: idx and w
// (L, kCorners, N), the layout of lattice_keys_and_weights_soa, so a test
// can hold the kernels' lattice against the plain version bit for bit.
__global__ void lattice_debug_kernel(const float* __restrict__ coords, int32_t* __restrict__ idx,
                                     float* __restrict__ w, int N,
                                     __grid_constant__ const LevelConsts c) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (n >= N) return;
  uint32_t ii[kCorners];
  float ww[kCorners];
  lattice_level(coords[n], coords[N + n], coords[2 * (size_t)N + n], c, l, ii, ww);
#pragma unroll
  for (int k = 0; k < kCorners; ++k) {
    idx[((size_t)l * kCorners + k) * N + n] = (int32_t)ii[k];
    w[((size_t)l * kCorners + k) * N + n] = ww[k];
  }
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
// Histograms of up to 24,576 f32 entries (96 KB: (2, T) rows up to
// T = 12,288, (F, T) rows up to F * T = 24,576) are staged in shared memory;
// larger ones take the direct variants.
constexpr int kMaxStagedBytes = 96 * 1024;
bool staged_fits(int T, int F = 2) { return T >= 1 && 4LL * F * T <= kMaxStagedBytes; }
// Feature counts the gather route's staged designs are compiled for (the
// direct variants take any count).
bool staged_features(int F) { return F == 1 || F == 2 || F == 4 || F == 8; }
// Least pairs (gather_pairs, table_grad) or points (encode_bwd_table) a
// staged block serves: below them, staging the table or zeroing and
// flushing the histogram costs more than the block's own work.
constexpr int kStagedPairs = 8192;
constexpr int kStagedPoints = 4096;
constexpr int kFillBlocksPerSm = 4;  // 4 x 8 warps: enough to stream at full rate
int g_sm_count = 132;                // the card's SMs, read by ngm_permuto_init

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

// hist_add for kF rows (h[c], v[c]): table_grad at F != 2. The two-row
// form above stays as it was for the production F = 2 and for
// encode_bwd_table: at F = 2 this template compiled to more instructions
// (block-uniform address arithmetic off the uniform datapath) and ran ~1%
// slower in turns on the H100.
template <int kF>
__device__ __forceinline__ void hist_add_rows(float* const (&h)[kF], uint32_t key, float (&v)[kF]) {
  const unsigned lane = threadIdx.x & 31u;
  const uint32_t next_key = __shfl_down_sync(kFullMask, key, 1);
  if (__any_sync(kFullMask, key != kNoKey && lane < 31u && next_key == key)) {
    const unsigned peers = __match_any_sync(kFullMask, key);
    int rank = __popc(peers & ((1u << lane) - 1u));  // place among its peers
    const bool leader = rank == 0;
    unsigned above = key == kNoKey ? 0u : peers & ~((2u << lane) - 1u);
    while (__any_sync(kFullMask, above != 0u)) {
      const int next = __ffs(above) - 1;  // the next live peer above, or -1
      float t[kF];
#pragma unroll
      for (int c = 0; c < kF; ++c) t[c] = __shfl_sync(kFullMask, v[c], next & 31);
      if (next >= 0) {
#pragma unroll
        for (int c = 0; c < kF; ++c) v[c] = v[c] + t[c];
      }
      above &= ~__ballot_sync(kFullMask, rank & 1);  // odd places are summed up
      rank >>= 1;
    }
    if (!leader) return;
  }
  if (key != kNoKey) {
#pragma unroll
    for (int c = 0; c < kF; ++c) atomicAdd(h[c] + key, v[c]);
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
// output. With the histogram on chip, its adds (a compare-and-swap loop
// each, hist_add) are the suspect for what bounds the kernel, not yet
// measured on their own (PERF.md §7): encode_fwd_staged_kernel, which runs
// the same lattice on the same grid and reads where this kernel adds, takes
// a third of its time on an H100. The TPU's one-hot(idx>>6) x
// one-hot(idx&63) matmuls built the same histogram on the MXU and are not
// carried over.
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
// One kernel body, encode_fwd_moe_kernel, replaces both TPU kernels. It is
// templated on where a pair's field-local point comes from: CarriedPoints,
// the (tiles, 3, kTile) coordinates the caller carries
// (permuto_pallas.encode_fwd_moe), or RayPoints, rebuilt from the pair's
// index and span distance (permuto_pallas.encode_fwd_moe_rays).
//
// Bound: bytes, the live tiles' inputs and their (tiles, 2L, kTile) f32
// output (~0.25 ms at 3.35 TB/s for the smoke's 8,388,608-pair render
// block). What they spend their time on is the lattice, ~280 SASS
// instructions a (pair, level) (the ray encode issued them at ~75% of the
// card's rate in its earlier staged design, PERF.md §6), then the corner
// reads. Design: a block of kTile threads takes one tile, a
// thread one pair and every level, the corners read through L1 and L2.
// Consecutive tiles mostly share a field (the dispatch sorts them; a
// render block's field runs are ~200 tiles long), and an SM's two blocks
// hold two tiles, so the SM reads one or two fields' tables at a time and
// its L1 keeps their corners. That block size decided the design: in an
// A/B on an H100 (PERF.md §6) the same kernel in 256-thread blocks (four a
// tile, the first design) took 1.26 ms on the render block, a staged design
// (a block's points and two levels' rows at a time in shared memory, the
// ray encode's earlier design) 1.03-1.06 ms, and 1024-thread blocks
// 0.96-1.03 ms; at T = 16,384, 2.44 and 1.44-1.51 ms; with a field change
// at every tile the staged design lost 31%, the direct one nothing. The
// TPU kernel's table DMA per grid step and its 128-lane sweep are not
// carried over.
//
// The kernel is templated too on its epilogue: StoreFeatures writes the
// (tiles, 2L, kTile) features; MlpHead runs the field's MLP on them and
// writes (tiles, O, kTile). The render's MLP had been a chain of batched
// products, bias adds and ReLUs over every tile of the dispatch, each pass
// writing and reading (tiles, 32, kTile) f32: ~9 GB a render block, bound
// by bytes at >= 2.8 ms, for 0.25 ms of f32 arithmetic. MlpHead's design:
// the block copies its field's w0 (transposed, a hidden unit's weights in
// one row), b0, w1 and b1 into 4.6 KB of shared memory with cp.async while
// the encode runs; each thread keeps its pair's 2L features in registers
// (the levels unrolled), then after one barrier streams the hidden units:
// h_j = relu(b0_j + sum_d w0[d][j] f_d) in fp32 FMAs, added at once into O
// output registers. Every thread of a warp reads the same shared words, a
// broadcast. Only the O outputs are written, coalesced. It fits the
// launch's 64 registers a thread with no spill. In an A/B on an H100 (700
// W; 9,193 tiles, 7,000 live, 40 fields, random rays) the encode with its
// MLP took 2.01-2.04 ms, against 5.49-5.51 ms for the feature store (1.35
// ms) followed by mlp_fm's passes; unrolling the hidden-unit loop 1, 2, 4
// or 8 times, or two partial sums a unit, all read 2.06-2.14 ms. A 640x480
// render fell from 341-343 to 232-243 ms (PERF.md §6).
constexpr int kTile = 1024;  // pairs per tile (permuto_pallas.TILE_M), threads a block

// Launch constants of the ray rebuild (everything but the camera/extrinsics
// vector, which lives on the device because it comes from the pose).
struct RayConsts {
  int block_offset;  // pixel index of the block's first ray
  int log2_ks;       // log2(k * samples per ray): pair index -> ray
  int width;         // image width (exact integer row split)
  float coord_scale;  // field-local scaling (scale_mode)
  float coord_shift;
};

// One pair's field-local point, rebuilt from its k-minor pair index and
// span distance in the TPU kernel's order of operations:
//   ray = orig >> log2_ks; pixel = block_offset + ray; row = pixel / width
//   (an exact integer division, no f32 reciprocal); direction
//   (R @ ((j - cx)/fx, -(i - cy)/fy, -1)) / norm; world = origin + dir * dist;
//   local = conj(q) * (world - p_field) * coord_scale + coord_shift.
// rayp (16,) f32 on the device: R row-major (9), origin (3), 1/fx, 1/fy, cx,
// cy. pose (7,): position, wxyz quaternion. The norm is 1 / sqrtf(...)
// (IEEE sqrt and division, no rsqrtf approximation) so the coordinates are
// bit-identical to the plain version's and land on the same simplex corners.
__device__ __forceinline__ void ray_point(int orig, float d, const float* __restrict__ rayp,
                                          const float* __restrict__ pose, const RayConsts& rc,
                                          float& xs, float& ys, float& zs) {
  const int ray = (int)((uint32_t)orig >> rc.log2_ks);
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
  xs = (px + qw * tx + (qy * tz - qz * ty)) * rc.coord_scale + rc.coord_shift;
  ys = (py + qw * ty + (qz * tx - qx * tz)) * rc.coord_scale + rc.coord_shift;
  zs = (pz + qw * tz + (qx * ty - qy * tx)) * rc.coord_scale + rc.coord_shift;
}

// Point sources of the MoE encode: point() gives pair `lane` of tile t,
// owned by field e.

// Carried field-local coordinates, (tiles, 3, kTile) f32.
struct CarriedPoints {
  const float* coords;
  __device__ __forceinline__ void point(int t, int lane, int /*e*/, float& x, float& y,
                                        float& z) const {
    const float* xyz = coords + (size_t)t * kDim * kTile;
    x = __ldg(xyz + lane);
    y = __ldg(xyz + kTile + lane);
    z = __ldg(xyz + 2 * kTile + lane);
  }
};

// Points rebuilt by ray_point from each pair's k-minor index (orig,
// (tiles, kTile) int32) and span distance (dist, (tiles, kTile) f32), with
// the owning field's pose (poses, (N, 7)).
struct RayPoints {
  const int* orig;
  const float* dist;
  const float* rayp;
  const float* poses;
  RayConsts rc;
  __device__ __forceinline__ void point(int t, int lane, int e, float& x, float& y, float& z) const {
    const size_t i = (size_t)t * kTile + lane;
    ray_point(__ldg(orig + i), __ldg(dist + i), rayp, poses + (size_t)e * 7, rc, x, y, z);
  }
};

// Epilogues of the MoE encode: what a block does with its tile's features.
// run() takes field e's table, the pair's point, tile t and the thread's
// lane.

// The (tiles, 2L, kTile) features, stored as each level is done.
struct StoreFeatures {
  float* out;
  __device__ __forceinline__ void run(const float* __restrict__ tab, int T, float x, float y, float z,
                                      const LevelConsts& c, int t, int /*e*/, int lane) const {
    encode_point(tab, T, x, y, z, c, out + (size_t)t * 2 * c.n_levels * kTile, kTile, lane);
  }
};

// 4 bytes global -> shared without a register (cp.async): the copy runs
// while the thread goes on, until cp_async_wait_all.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The field MLP, out[t, q, lane] = b1[q] + sum_j w1[j][q] relu(b0[j] +
// sum_d w0[d][j] f[d]), from the stacked per-field weights w0 (N, D, H),
// b0 (N, H), w1 (N, H, O), b1 (N, O) of field e, D = 2L <= kMlpMaxD,
// H <= kMlpMaxH, O <= kMlpMaxO, into (tiles, O, kTile).
struct MlpHead {
  const float* w0;
  const float* b0;
  const float* w1;
  const float* b1;
  float* out;
  int H;
  int O;

  __device__ __forceinline__ void run(const float* __restrict__ tab, int T, float x, float y, float z,
                                      const LevelConsts& c, int t, int e, int lane) const {
    __shared__ __align__(16) float sw0[kMlpMaxH][kMlpMaxD];  // w0 transposed: a unit's row
    __shared__ __align__(16) float sw1[kMlpMaxH][kMlpMaxO];
    __shared__ float sb0[kMlpMaxH];
    __shared__ float sb1[kMlpMaxO];
    static_assert(kMlpMaxD % 4 == 0 && kMlpMaxO == 4 && kMlpMaxD * kMlpMaxH <= kTile,
                  "16-byte weight reads, one w0 entry a thread");
    const int L = c.n_levels;
    const int D = 2 * L;
    // field e's weights, zero-padded, copied while the encode runs;
    // consecutive threads write consecutive words of sw0
    {
      const int j = lane / kMlpMaxD;
      const int d = lane - j * kMlpMaxD;
      if (d < D && j < H) {
        cp_async4(&sw0[j][d], w0 + ((size_t)e * D + d) * H + j);
      } else {
        sw0[j][d] = 0.0f;
      }
      if (lane < kMlpMaxH * kMlpMaxO) {
        const int u = lane / kMlpMaxO;
        const int q = lane - u * kMlpMaxO;
        if (u < H && q < O) {
          cp_async4(&sw1[u][q], w1 + ((size_t)e * H + u) * O + q);
        } else {
          sw1[u][q] = 0.0f;
        }
      }
      if (lane < H) cp_async4(&sb0[lane], b0 + (size_t)e * H + lane);
      if (lane < kMlpMaxO) {
        if (lane < O) {
          cp_async4(&sb1[lane], b1 + (size_t)e * O + lane);
        } else {
          sb1[lane] = 0.0f;
        }
      }
    }
    // the 2L features in registers: every level unrolled, so each lands in
    // a register by a compile-time index
    float f[kMlpMaxD];
#pragma unroll
    for (int l = 0; l < kMlpMaxLevels; ++l) {
      if (l < L) {
        level_features(tab, T, L, l, x, y, z, c, f[2 * l], f[2 * l + 1]);
      } else {
        f[2 * l] = 0.0f;
        f[2 * l + 1] = 0.0f;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // the hidden units one at a time, each into the O outputs at once; every
    // thread reads the same shared words (a broadcast)
    float o[kMlpMaxO] = {sb1[0], sb1[1], sb1[2], sb1[3]};
#pragma unroll 2
    for (int j = 0; j < H; ++j) {
      float a = sb0[j];
#pragma unroll
      for (int d = 0; d < kMlpMaxD; d += 4) {
        const float4 w = *reinterpret_cast<const float4*>(&sw0[j][d]);
        a = fmaf(w.x, f[d], a);
        a = fmaf(w.y, f[d + 1], a);
        a = fmaf(w.z, f[d + 2], a);
        a = fmaf(w.w, f[d + 3], a);
      }
      const float h = fmaxf(a, 0.0f);
      const float4 v = *reinterpret_cast<const float4*>(sw1[j]);
      o[0] = fmaf(v.x, h, o[0]);
      o[1] = fmaf(v.y, h, o[1]);
      o[2] = fmaf(v.z, h, o[2]);
      o[3] = fmaf(v.w, h, o[3]);
    }
    float* ot = out + (size_t)t * O * kTile + lane;
#pragma unroll
    for (int q = 0; q < kMlpMaxO; ++q) {
      if (q < O) ot[(size_t)q * kTile] = o[q];
    }
  }
};

template <class Points, class Epilogue>
__global__ void __launch_bounds__(kTile) encode_fwd_moe_kernel(
    const float* __restrict__ tables, __grid_constant__ const Points src,
    const int* __restrict__ tile_experts, const int* __restrict__ num_live,
    __grid_constant__ const Epilogue epi, int T, __grid_constant__ const LevelConsts c) {
  const int t = blockIdx.x;
  if (t >= __ldg(num_live)) return;
  const int lane = threadIdx.x;
  const int e = __ldg(tile_experts + t);
  float x, y, z;
  src.point(t, lane, e, x, y, z);
  epi.run(tables + (size_t)e * 2 * c.n_levels * T, T, x, y, z, c, t, e, lane);
}

// One launch of the MoE encode: the feature store, or with w0 the MLP
// epilogue (widths checked by the caller).
template <class Points>
int launch_encode_fwd_moe(const float* tables, const Points& src, const int* tile_experts,
                          const int* num_live, float* out, int tiles, int T, const LevelConsts& c,
                          const float* w0, const float* b0, const float* w1, const float* b1,
                          int H, int O, cudaStream_t s) {
  if (w0 == nullptr) {
    encode_fwd_moe_kernel<Points, StoreFeatures><<<tiles, kTile, 0, s>>>(
        tables, src, tile_experts, num_live, StoreFeatures{out}, T, c);
  } else {
    if (c.n_levels > kMlpMaxLevels || H < 1 || H > kMlpMaxH || O < 1 || O > kMlpMaxO) {
      return (int)cudaErrorInvalidValue;
    }
    encode_fwd_moe_kernel<Points, MlpHead><<<tiles, kTile, 0, s>>>(
        tables, src, tile_experts, num_live, MlpHead{w0, b0, w1, b1, out, H, O}, T, c);
  }
  return (int)cudaGetLastError();
}

// -- gather route: per-(row, pair) lookups and their histogram ----------------
//
// A "row" is one (field, level): an (F, T) feature-major table slice and M
// hash indices (K corners x P points, flattened). gather_blend in
// ops/permuto.py takes this route for every shape the fused encode does not
// take (2D fields, point gradients, F != 2 features a level). The staged
// designs are compiled for F in {1, 2, 4, 8} (staged_features); the direct
// variants loop over F at run time and take any F.

// Replaces permuto_pallas.gather_pairs (_gather_kernel):
// out[r, f, m] = table[r, f, idx[r, m]], exact (a pure copy).
//
// Bound: bytes. Each pair streams an 8-byte index in and F 4-byte
// features out; at the 2D field set's shape (512 rows x 36,864 pairs,
// T = 4096, F = 2) that is 302 MB, against 16 MB of tables, so the least time
// is the streams at the memory rate (0.095 ms at 3.35 TB/s). Reading the table
// through L2 costs F 32-byte sectors a pair (37.7M sector reads, ~1.2 GB
// of L2 traffic at F = 2), and the tables compete in L2 with the streams.
// Design, as the TPU kernel stages each row's table in VMEM: a block serves
// one (row, chunk of at least kStagedPairs pairs); one thread copies the
// row's contiguous (F, T) table into shared memory with one bulk asynchronous
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
// does not fit: a table above kMaxStagedBytes (F * T > 24,576), an F the
// staged design is not compiled for, F * T not a multiple of 4 or an
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

// Dynamic shared memory: the (kF, T) table, then the mbarrier (4 kF T is a
// multiple of 16, so the barrier is 8-byte aligned).
template <int kF, bool kVec>
__global__ void __launch_bounds__(kThreads) gather_pairs_staged_kernel(
    const float* __restrict__ table, const int64_t* __restrict__ idx,
    float* __restrict__ out, int T, int M, int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float* stab = reinterpret_cast<const float*>(smem);
  const uint32_t bytes = 4u * kF * (uint32_t)T;
  const uint32_t bar = smem_addr(smem + bytes);
  const int64_t r = blockIdx.x;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(smem)), "l"(table + r * kF * T), "r"(bytes), "r"(bar) : "memory");
  }
  const int begin = blockIdx.y * chunk;
  const int end = min(M, begin + chunk);
  const int step = blockDim.x * kLookups;
  const int64_t* ib = idx + r * M;
  float* o = out + r * kF * M;
  int m = begin + threadIdx.x * kLookups;
  int64_t i[kLookups] = {0, 0, 0, 0};
  load_step<kVec>(ib, m, end, i);  // while the table is in flight
  __syncthreads();                 // the barrier is initialised
  mbarrier_wait(bar, 0);
  for (; m < end; m += step) {
    int64_t next[kLookups] = {0, 0, 0, 0};
    load_step<kVec>(ib, m + step, end, next);
    float f[kF][kLookups];
#pragma unroll
    for (int k = 0; k < kLookups; ++k) {
#pragma unroll
      for (int c = 0; c < kF; ++c) f[c][k] = stab[c * T + i[k]];
    }
    if (kVec) {
#pragma unroll
      for (int c = 0; c < kF; ++c) {
        __stcs(reinterpret_cast<float4*>(o + c * M + m),
               make_float4(f[c][0], f[c][1], f[c][2], f[c][3]));
      }
    } else {
#pragma unroll
      for (int k = 0; k < kLookups; ++k) {
        if (m + k < end) {
#pragma unroll
          for (int c = 0; c < kF; ++c) __stcs(o + c * M + m + k, f[c][k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kLookups; ++k) i[k] = next[k];
  }
}

// The direct variant: one thread per (row, m), grid x over m and grid y
// over rows (a row loop past the grid's y limit), the F features read
// through L2. Compiled for kF = 2, the production shape, as it was before
// F was generalised (a loop over F at run time made it 12% slower there),
// and for any F at run time (kF = 0; on the H100 a compiled F = 8 ran
// slower than this loop, 0.566 against 0.504 ms at the 2D set's pairs).
template <int kF>
__global__ void gather_pairs_direct_kernel(const float* __restrict__ table,
                                           const int64_t* __restrict__ idx,
                                           float* __restrict__ out, int F, int T,
                                           int M, int rows) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int f = kF > 0 ? kF : F;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* tab = table + r * f * T + idx[r * M + m];
    float* o = out + r * f * M + m;
    for (int c = 0; c < f; ++c) o[(int64_t)c * M] = __ldg(tab + (int64_t)c * T);
  }
}

bool gather_pairs_staged(const float* table, int F, int T, int M) {
  return staged_features(F) && staged_fits(T, F) && (F * T) % 4 == 0 &&
         (int64_t)T < 8LL * M && aligned16(table);
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

// load_pairs for kF value rows g[c]: table_grad at F != 2.
template <int kF, bool kVec>
__device__ __forceinline__ void load_pair_rows(const int64_t* ib, const float* const (&g)[kF],
                                           int m, int end, int64_t i[kLookups],
                                           float v[kF][kLookups]) {
  if (kVec) {
    if (m < end) {  // end and m are multiples of kLookups
      const longlong2 a = load_index_pair(ib + m);
      const longlong2 b = load_index_pair(ib + m + 2);
      i[0] = a.x;
      i[1] = a.y;
      i[2] = b.x;
      i[3] = b.y;
#pragma unroll
      for (int c = 0; c < kF; ++c) {
        const float4 x = __ldcs(reinterpret_cast<const float4*>(g[c] + m));
        v[c][0] = x.x;
        v[c][1] = x.y;
        v[c][2] = x.z;
        v[c][3] = x.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kLookups; ++k) {
        i[k] = 0;
#pragma unroll
        for (int c = 0; c < kF; ++c) v[c][k] = 0.0f;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLookups; ++k) {
      const bool in = m + k < end;
      i[k] = in ? load_index(ib + m + k) : 0;
#pragma unroll
      for (int c = 0; c < kF; ++c) v[c][k] = in ? __ldcs(g[c] + m + k) : 0.0f;
    }
  }
}

// Replaces permuto_pallas.table_grad (_table_grad_kernel):
// grad[r, f, idx[r, m]] += gv[r, f, m] into a (rows, F, T) output.
//
// Bound: bytes. Each pair streams an 8-byte index and F 4-byte values in;
// at the 2D field set's shape (512 rows x 36,864 pairs, T = 4096, F = 2)
// that is 302 MB, plus the 16.8 MB histogram out, so the least time is
// 0.095 ms at 3.35 TB/s. The first design (now the direct variant) added
// every value into device memory with a global atomic, 37.7 M a call, which
// the L2's atomic units serialise where a coarse level puts many pairs on
// one entry. Design, as the TPU kernel keeps one (field, level) row in VMEM
// across its pair tiles: a block owns one row (grid x, so more than 65,535
// rows need no loop) and a chunk of its pairs (grid y, hist_chunks), and
// keeps the row's (F, T) histogram in shared memory, which it zeroes itself
// (32 KB at F = 2, T = 4096). Each thread takes kLookups pairs a step,
// as gather_pairs_staged_kernel: two 16-byte streaming index loads and one
// 16-byte streaming load of each value row, the next step's loads issued
// before this step's adds; the adds go to shared memory, aggregated within
// the warp (hist_add); a pair whose values are all zero adds nothing. Rows
// with M % 4 != 0 or unaligned inputs take the scalar loads. A block that
// owns its whole row writes all F T entries with coalesced 16-byte stores,
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


// The same design for kF feature rows (table_grad at F in {1, 4, 8}); F = 2
// keeps the kernel above (see hist_add_rows).
template <int kF, bool kVec>
__global__ void __launch_bounds__(kThreads) table_grad_staged_rows_kernel(
    const int64_t* __restrict__ idx, const float* __restrict__ gv,
    float* __restrict__ grad, int T, int M, int chunk) {
  extern __shared__ __align__(16) float hist[];  // (kF, T)
  const int64_t r = blockIdx.x;
  for (int i = threadIdx.x; i < kF * T; i += blockDim.x) hist[i] = 0.0f;
  const int begin = blockIdx.y * chunk;
  const int end = min(M, begin + chunk);
  const int step = blockDim.x * kLookups;
  const int64_t* ib = idx + r * M;
  const float* g[kF];  // the row's value rows
  float* h[kF];        // its histogram rows
#pragma unroll
  for (int c = 0; c < kF; ++c) {
    g[c] = gv + (r * kF + c) * M;
    h[c] = hist + c * T;
  }
  int m = begin + threadIdx.x * kLookups;
  int64_t i[kLookups];
  float v[kF][kLookups];
  load_pair_rows<kF, kVec>(ib, g, m, end, i, v);  // while the histogram is zeroed
  __syncthreads();
  for (int base = begin; base < end; base += step, m += step) {  // the same trips for every warp
    int64_t ni[kLookups];
    float nv[kF][kLookups];
    load_pair_rows<kF, kVec>(ib, g, m + step, end, ni, nv);
#pragma unroll
    for (int k = 0; k < kLookups; ++k) {
      float vk[kF];
      bool add = false;
#pragma unroll
      for (int c = 0; c < kF; ++c) {
        vk[c] = v[c][k];
        add = add || vk[c] != 0.0f;
      }
      hist_add_rows<kF>(h, add ? (uint32_t)i[k] : kNoKey, vk);
    }
#pragma unroll
    for (int k = 0; k < kLookups; ++k) {
      i[k] = ni[k];
#pragma unroll
      for (int c = 0; c < kF; ++c) v[c][k] = nv[c][k];
    }
  }
  __syncthreads();
  float* row = grad + r * kF * T;
  if (gridDim.y == 1) {
    store_hist_row(row, hist, kF * T, kF * T);
  } else {
    add_hist_row(row, hist, kF * T);
  }
}

// The direct variant, for (F, T) histograms above kMaxStagedBytes or an F
// the staged design is not compiled for: one thread per (row, m) on the
// grid of gather_pairs_direct_kernel, each nonzero value added into the
// zeroed output with a global atomic (the first design); a pair whose
// values are all zero reads no index. Compiled as the gather's direct
// variant is (kF = 2, and kF = 0 for F at run time).
template <int kF>
__global__ void table_grad_kernel(const int64_t* __restrict__ idx,
                                  const float* __restrict__ gv,
                                  float* __restrict__ grad, int F, int T, int M,
                                  int rows) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int f = kF > 0 ? kF : F;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* g = gv + r * f * M + m;
    bool any = false;
    for (int c = 0; c < f; ++c) any |= g[(int64_t)c * M] != 0.0f;
    if (!any) continue;
    float* gr = grad + r * f * T + idx[r * M + m];
    for (int c = 0; c < f; ++c) {
      const float v = g[(int64_t)c * M];
      if (v != 0.0f) atomicAdd(gr + (int64_t)c * T, v);
    }
  }
}

// -- fused encode + MLP (the fused training route) ---------------------------
//
// The field MLP at the widths of kMlpMax* (top of the file).
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
// encode_fwd, and f written once as the (B, D, P) residual.
//
// Bound: operations, the lattice of 16 levels and the MLP's
// 2 x (D x H + H x O) f32 operations a point; then the bytes of the tables,
// the coordinates in and the residual and outputs out. The residual is
// written in any design (the backward reads it), so the encode's kernel can
// write it and a second kernel read it back (50 MB at the training shape,
// ~0.015 ms at 3.35 TB/s). What limited the first design (one kernel, one
// thread a (field, point) walking 16 levels, the MLP in registers) was the
// encode, as in encode_fwd's first design: its corners read through L2.
// Design, as encode_mlp_bwd's: two device kernels on the stream, one
// counted launch. encode_fwd's kernel for the shape (launch_encode_fwd:
// staged up to kMaxStagedBytes, direct above; unchanged, so the residual is
// encode_fwd's output bit for bit) writes the residual, then mlp_fwd_kernel
// takes one thread a (field, point) and kMlpFwdRounds rounds of
// kMlpThreads points a block: the field's weights in shared memory (read
// 16 bytes at a time, each round: a compiler barrier keeps the compiler
// from hoisting all 1,152 of them into registers, which spilled 4 KB a
// thread), the D features and H hidden units in registers, held to
// kMlpFwdBlocks blocks an SM, plain fmaf products in f32 (no tensor cores,
// no TF32, as the plain version computes on the CPU) in the first design's
// order, so the outputs are its outputs bit for bit, and one coalesced
// store an output. 2 rounds at 6 blocks an SM beat 1 or 4 rounds and 1 or 4
// blocks, and the two kernels beat the first design at T = 16,384 too, in
// an A/B on an H100 (PERF.md §6). The TPU kernel's slab relayouts and
// ones-row bias folding are not carried over: the biases are added
// directly.
constexpr int kMlpFwdRounds = 2;
constexpr int kMlpFwdBlocks = 6;  // blocks an SM: at most 85 registers a thread

__global__ void __launch_bounds__(kMlpThreads, kMlpFwdBlocks) mlp_fwd_kernel(
    const float* __restrict__ feats, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ w1,
    const float* __restrict__ b1, float* __restrict__ out, int P, int L, int H, int O) {
  __shared__ __align__(16) float sw0[kMlpMaxD][kMlpMaxH];
  __shared__ __align__(16) float sb0[kMlpMaxH];
  __shared__ __align__(16) float sw1[kMlpMaxH][kMlpMaxO];
  static_assert(kMlpMaxH % 4 == 0 && kMlpMaxO == 4, "16-byte weight reads");
  const int b = blockIdx.y;
  const int D = 2 * L;
  load_mlp_weights(w0 + (size_t)b * D * H, b0 + (size_t)b * H, w1 + (size_t)b * H * O,
                   D, H, O, sw0, sb0, sw1);
  float bias[kMlpMaxO];
#pragma unroll
  for (int q = 0; q < kMlpMaxO; ++q) bias[q] = q < O ? b1[(size_t)b * O + q] : 0.0f;
  __syncthreads();
  const float* fb = feats + (size_t)b * D * P;
  float* ob = out + (size_t)b * O * P;
  for (int r = 0; r < kMlpFwdRounds; ++r) {
    const int p = (blockIdx.x * kMlpFwdRounds + r) * kMlpThreads + threadIdx.x;
    if (p >= P) return;
    asm volatile("" ::: "memory");  // the compiler barrier: weights read each round
    float f[kMlpMaxD];
#pragma unroll
    for (int d = 0; d < kMlpMaxD; ++d) f[d] = d < D ? fb[(size_t)d * P + p] : 0.0f;
    // a0[j] = b0[j] + sum_d w0[d][j] f[d], d in order
    float a0[kMlpMaxH];
#pragma unroll
    for (int j = 0; j < kMlpMaxH; ++j) a0[j] = sb0[j];
#pragma unroll
    for (int d = 0; d < kMlpMaxD; ++d) {
#pragma unroll
      for (int j = 0; j < kMlpMaxH; j += 4) {
        const float4 w = *reinterpret_cast<const float4*>(&sw0[d][j]);
        a0[j] = fmaf(w.x, f[d], a0[j]);
        a0[j + 1] = fmaf(w.y, f[d], a0[j + 1]);
        a0[j + 2] = fmaf(w.z, f[d], a0[j + 2]);
        a0[j + 3] = fmaf(w.w, f[d], a0[j + 3]);
      }
    }
    float o[kMlpMaxO] = {bias[0], bias[1], bias[2], bias[3]};
#pragma unroll
    for (int j = 0; j < kMlpMaxH; ++j) {
      const float h = fmaxf(a0[j], 0.0f);
      const float4 w = *reinterpret_cast<const float4*>(sw1[j]);
      o[0] = fmaf(w.x, h, o[0]);
      o[1] = fmaf(w.y, h, o[1]);
      o[2] = fmaf(w.z, h, o[2]);
      o[3] = fmaf(w.w, h, o[3]);
    }
#pragma unroll
    for (int q = 0; q < kMlpMaxO; ++q) {
      if (q < O) ob[(size_t)q * P + p] = o[q];
    }
  }
}

// Replaces permuto_pallas.encode_mlp_bwd (_encode_mlp_bwd_kernel): the MLP
// backward from the residual f and the head cotangent g (the four weight
// gradients), and the (B, 2, L, T) table gradient driven by dL/df.
//
// Bound: operations, the recomputed pre-activations, dh, dL/df and the two
// weight-gradient products (~4.4 K f32 operations a point) and the lattice
// of 16 levels, 0.053 ms at the training shape; the bytes (residual, g,
// coordinates in, gradients out) take 0.03 ms. What limited the first
// design (now the direct variant, encode_mlp_bwd_kernel below) was its
// histogram: 50 M global atomicAdds a call into a zeroed gradient, which
// the L2's atomic units serialise on the coarse levels, the design
// encode_bwd_table left for staged histograms. Design: two kernels on the
// stream, as the histogram wants one (field, level) a block and the MLP one
// point a thread. mlp_bwd_kernel takes one thread a (field, point) and
// kMlpRounds rounds of kMlpThreads points a block: it recomputes the
// pre-activations (the weights read from shared memory 16 bytes at a time),
// writes dL/df (B, 2L, P) f32 once (50 MB at the training shape, written
// and read back at ~0.03 ms), and reduces the weight gradients over the
// block's points in shared memory: the round's f (a column a point) and h
// or dL/da0 and g (a row a point) go to shared memory, each thread sums a
// 2 x 4 tile of dw0 in registers (three conflict-free loads for eight
// FMAs a point), warp 0 also db0 and dw1, and after its rounds the block
// adds each entry to the zeroed gradient with one atomicAdd: kMlpRounds
// times fewer global atomics than one a round (4 rounds were a few percent
// ahead of 1 and 2 in an A/B on an H100, PERF.md §6). Then
// encode_bwd_table_staged_kernel, unchanged, takes dL/df as its cotangent:
// the level's (2, cap_l) histogram in shared memory, every entry written
// once, so the table gradient needs no memset. Points past P carry a zero
// cotangent and add nothing.
constexpr int kMlpRounds = 4;

__global__ void __launch_bounds__(kMlpThreads) mlp_bwd_kernel(
    const float* __restrict__ feats, const float* __restrict__ g,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ w1, float* __restrict__ dfeats,
    float* __restrict__ dw0, float* __restrict__ db0, float* __restrict__ dw1,
    float* __restrict__ db1, int P, int L, int H, int O) {
  constexpr int kRow = kMlpMaxH + 4;  // a point's row of sA: 16-byte aligned, 4-way stores
  __shared__ __align__(16) float sw0[kMlpMaxD][kMlpMaxH];
  __shared__ __align__(16) float sb0[kMlpMaxH];
  __shared__ __align__(16) float sw1[kMlpMaxH][kMlpMaxO];
  __shared__ float sF[kMlpMaxD][kMlpPad];                 // features, a column a point
  __shared__ __align__(16) float sA[kMlpThreads][kRow];  // h, then dL/da0, a row a point
  __shared__ __align__(16) float sG[kMlpThreads][kMlpMaxO];  // head cotangent, a row a point
  static_assert(kMlpThreads == 128 && kMlpMaxD == 32 && kMlpMaxH == 32 && kMlpMaxO == 4,
                "the weight-gradient tiles below assume the production widths");
  const int b = blockIdx.y;
  const int D = 2 * L;
  const int t = threadIdx.x;
  // this thread's tile of dw0: rows d0, d0 + 1 and columns j0 .. j0 + 3
  // (a warp reads 8 distinct column quads and 8 distinct rows: no bank
  // conflicts); warp 0 also sums db0[t] and dw1[t][0..3], warp 1's first
  // four lanes db1[t - 32]
  const int d0 = 2 * (t / 8);
  const int j0 = 4 * (t % 8);
  load_mlp_weights(w0 + (size_t)b * D * H, b0 + (size_t)b * H, w1 + (size_t)b * H * O,
                   D, H, O, sw0, sb0, sw1);
  const float* fb = feats + (size_t)b * D * P;
  const float* gb = g + (size_t)b * O * P;
  float* dfb = dfeats + (size_t)b * D * P;
  float acc0[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  float acc1[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // dw1[t][q] (warp 0)
  float accb = 0.0f;                         // db0[t] (warp 0), db1[t - 32] (warp 1)
  for (int r = 0; r < kMlpRounds; ++r) {
    const int p = (blockIdx.x * kMlpRounds + r) * kMlpThreads + t;
    const bool live = p < P;
    float f[kMlpMaxD];
#pragma unroll
    for (int d = 0; d < kMlpMaxD; ++d) {
      f[d] = (live && d < D) ? fb[(size_t)d * P + p] : 0.0f;
      sF[d][t] = f[d];
    }
    float gg[kMlpMaxO];
#pragma unroll
    for (int q = 0; q < kMlpMaxO; ++q) gg[q] = (live && q < O) ? gb[(size_t)q * P + p] : 0.0f;
    *reinterpret_cast<float4*>(sG[t]) = make_float4(gg[0], gg[1], gg[2], gg[3]);
    __syncthreads();  // the weights and the round's columns are in shared memory
    // pre-activations a0[j] = b0[j] + sum_d w0[d][j] f[d], d in order
    float a0[kMlpMaxH];
#pragma unroll
    for (int j = 0; j < kMlpMaxH; ++j) a0[j] = sb0[j];
#pragma unroll
    for (int d = 0; d < kMlpMaxD; ++d) {
#pragma unroll
      for (int j = 0; j < kMlpMaxH; j += 4) {
        const float4 w = *reinterpret_cast<const float4*>(&sw0[d][j]);
        a0[j] = fmaf(w.x, f[d], a0[j]);
        a0[j + 1] = fmaf(w.y, f[d], a0[j + 1]);
        a0[j + 2] = fmaf(w.z, f[d], a0[j + 2]);
        a0[j + 3] = fmaf(w.w, f[d], a0[j + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kMlpMaxH; j += 4) {
      *reinterpret_cast<float4*>(&sA[t][j]) = make_float4(fmaxf(a0[j], 0.0f), fmaxf(a0[j + 1], 0.0f),
                                                          fmaxf(a0[j + 2], 0.0f), fmaxf(a0[j + 3], 0.0f));
    }
    __syncthreads();
    // dw1[j][q] += sum_points h[j] g[q]; db1[q] += sum_points g[q]
    if (t < kMlpMaxH) {
      for (int u = 0; u < kMlpThreads; ++u) {
        const float h = sA[u][t];
        const float4 gq = *reinterpret_cast<const float4*>(sG[u]);
        acc1[0] = fmaf(h, gq.x, acc1[0]);
        acc1[1] = fmaf(h, gq.y, acc1[1]);
        acc1[2] = fmaf(h, gq.z, acc1[2]);
        acc1[3] = fmaf(h, gq.w, acc1[3]);
      }
    } else if (t < kMlpMaxH + kMlpMaxO) {
      for (int u = 0; u < kMlpThreads; ++u) accb = accb + sG[u][t - kMlpMaxH];
    }
    __syncthreads();  // every thread is done reading h
    // dL/da0[j] = relu'(a0[j]) sum_q w1[j][q] g[q]
#pragma unroll
    for (int j = 0; j < kMlpMaxH; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(sw1[j]);
      float dh = 0.0f;
      dh = fmaf(w.x, gg[0], dh);
      dh = fmaf(w.y, gg[1], dh);
      dh = fmaf(w.z, gg[2], dh);
      dh = fmaf(w.w, gg[3], dh);
      a0[j] = a0[j] > 0.0f ? dh : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kMlpMaxH; j += 4) {
      *reinterpret_cast<float4*>(&sA[t][j]) = make_float4(a0[j], a0[j + 1], a0[j + 2], a0[j + 3]);
    }
    if (live) {  // dL/df[d] = sum_j w0[d][j] dL/da0[j], j in order
#pragma unroll
      for (int d = 0; d < kMlpMaxD; ++d) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < kMlpMaxH; j += 4) {
          const float4 w = *reinterpret_cast<const float4*>(&sw0[d][j]);
          s = fmaf(w.x, a0[j], s);
          s = fmaf(w.y, a0[j + 1], s);
          s = fmaf(w.z, a0[j + 2], s);
          s = fmaf(w.w, a0[j + 3], s);
        }
        if (d < D) dfb[(size_t)d * P + p] = s;
      }
    }
    __syncthreads();
    // dw0[d][j] += sum_points f[d] dL/da0[j]; db0[j] += sum_points dL/da0[j]
    for (int u = 0; u < kMlpThreads; ++u) {
      const float4 da = *reinterpret_cast<const float4*>(&sA[u][j0]);
      const float f0 = sF[d0][u];
      const float f1 = sF[d0 + 1][u];
      acc0[0][0] = fmaf(f0, da.x, acc0[0][0]);
      acc0[0][1] = fmaf(f0, da.y, acc0[0][1]);
      acc0[0][2] = fmaf(f0, da.z, acc0[0][2]);
      acc0[0][3] = fmaf(f0, da.w, acc0[0][3]);
      acc0[1][0] = fmaf(f1, da.x, acc0[1][0]);
      acc0[1][1] = fmaf(f1, da.y, acc0[1][1]);
      acc0[1][2] = fmaf(f1, da.z, acc0[1][2]);
      acc0[1][3] = fmaf(f1, da.w, acc0[1][3]);
    }
    if (t < kMlpMaxH) {
      for (int u = 0; u < kMlpThreads; ++u) accb = accb + sA[u][t];
    }
    if (r + 1 < kMlpRounds) __syncthreads();  // the next round overwrites the columns
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (d0 + i < D && j0 + k < H) atomicAdd(dw0 + ((size_t)b * D + d0 + i) * H + j0 + k, acc0[i][k]);
    }
  }
  if (t < H) {
    atomicAdd(db0 + (size_t)b * H + t, accb);
#pragma unroll
    for (int q = 0; q < kMlpMaxO; ++q) {
      if (q < O) atomicAdd(dw1 + ((size_t)b * H + t) * O + q, acc1[q]);
    }
  } else if (t >= kMlpMaxH && t < kMlpMaxH + O) {
    atomicAdd(db1 + (size_t)b * O + t - kMlpMaxH, accb);
  }
}

// The direct variant, for tables whose (2, T) histogram is above
// kMaxStagedBytes (T > 12,288; the C entry point chooses by shape), and the
// first design: one kernel, one thread per (field, point), grid y = field,
// kMlpThreads points a block. Each thread recomputes its pre-activations,
// the block reduces its points' weight gradients in shared memory (the
// columns h / dL/da0, f and g of its points, every thread summing a few
// entries over them) and adds each entry to the zeroed global gradient
// with one atomicAdd a block; dL/df stays in registers and every
// corner value goes into the zeroed table gradient with a global atomicAdd,
// as encode_bwd_table_kernel does.
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

// encode_fwd's launch: the staged design for (2, T) level rows up to
// kMaxStagedBytes, the direct one above.
void launch_encode_fwd(const float* table, const float* coords, float* out, int B, int P, int L,
                       int T, const LevelConsts& c, cudaStream_t s) {
  if (staged_fits(T)) {
    const int chunks = hist_chunks((int64_t)B * L, P, kStagedPoints);
    const int chunk = (P + chunks - 1) / chunks;
    const dim3 grid((unsigned)((int64_t)B * L), (P + chunk - 1) / chunk);
    encode_fwd_staged_kernel<<<grid, kFwdThreads, 8 * (size_t)T, s>>>(table, coords, out, P, T, chunk, c);
  } else {
    const dim3 grid((P + kFwdDirectThreads - 1) / kFwdDirectThreads,
                    (L + kFwdDirectLevels - 1) / kFwdDirectLevels, B);
    encode_fwd_kernel<<<grid, kFwdDirectThreads, 0, s>>>(table, coords, out, P, T, c);
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
int table_grad_chunks(int rows, int F, int T, int M) {
  if (!staged_features(F) || !staged_fits(T, F)) return 0;
  return hist_chunks(rows, M, kStagedPairs);
}

// The direct gather-route launches: kF = 2 compiled, 0 for any other F (a
// loop at run time).
template <int kF>
void launch_gather_direct(const float* table, const int64_t* idx, float* out, int rows, int F,
                          int T, int M, cudaStream_t s) {
  const dim3 grid((M + kThreads - 1) / kThreads, rows < kMaxGridY ? rows : kMaxGridY);
  gather_pairs_direct_kernel<kF><<<grid, kThreads, 0, s>>>(table, idx, out, F, T, M, rows);
}

template <int kF>
void launch_table_grad_direct(const int64_t* idx, const float* gv, float* grad, int rows, int F,
                              int T, int M, cudaStream_t s) {
  const dim3 grid((M + kThreads - 1) / kThreads, rows < kMaxGridY ? rows : kMaxGridY);
  table_grad_kernel<kF><<<grid, kThreads, 0, s>>>(idx, gv, grad, F, T, M, rows);
}

// The staged gather-route launches, one instantiation a feature count.
template <int kF>
void launch_gather_pairs_staged(const float* table, const int64_t* idx, float* out,
                                int rows, int T, int M, cudaStream_t s) {
  // grid x = rows (up to 2^31 - 1), y = chunks of at least kStagedPairs
  // pairs, a multiple of kLookups
  const int chunks = std::max(1, std::min(kMaxGridY, M / kStagedPairs));
  const int chunk = ((M + chunks - 1) / chunks + kLookups - 1) / kLookups * kLookups;
  const dim3 grid(rows, (M + chunk - 1) / chunk);
  const size_t smem = 4 * (size_t)kF * T + 16;
  if (M % kLookups == 0 && aligned16(idx) && aligned16(out)) {
    gather_pairs_staged_kernel<kF, true><<<grid, kThreads, smem, s>>>(table, idx, out, T, M, chunk);
  } else {
    gather_pairs_staged_kernel<kF, false><<<grid, kThreads, smem, s>>>(table, idx, out, T, M, chunk);
  }
}

// The staged histogram kernel of kF rows: the two-row kernel at F = 2.
using TableGradKernel = void (*)(const int64_t*, const float*, float*, int, int, int);
template <int kF, bool kVec>
TableGradKernel table_grad_staged_of() {
  if constexpr (kF == 2) {
    return &table_grad_staged_kernel<kVec>;
  } else {
    return &table_grad_staged_rows_kernel<kF, kVec>;
  }
}

template <int kF>
void launch_table_grad_staged(const int64_t* idx, const float* gv, float* grad,
                              int rows, int T, int M, int chunks, cudaStream_t s) {
  // grid x = rows (up to 2^31 - 1), y = chunks, each a multiple of kLookups
  const int chunk = ((M + chunks - 1) / chunks + kLookups - 1) / kLookups * kLookups;
  const dim3 grid(rows, (M + chunk - 1) / chunk);
  const size_t smem = 4 * (size_t)kF * T;
  const TableGradKernel kernel = M % kLookups == 0 && aligned16(idx) && aligned16(gv)
                                     ? table_grad_staged_of<kF, true>()
                                     : table_grad_staged_of<kF, false>();
  kernel<<<grid, kThreads, smem, s>>>(idx, gv, grad, T, M, chunk);
}

// The staged gather-route kernels of one feature count, for
// ngm_permuto_init.
template <int kF>
void add_staged_gather_kernels(const void** out) {
  out[0] = reinterpret_cast<const void*>(&gather_pairs_staged_kernel<kF, true>);
  out[1] = reinterpret_cast<const void*>(&gather_pairs_staged_kernel<kF, false>);
  out[2] = reinterpret_cast<const void*>(table_grad_staged_of<kF, true>());
  out[3] = reinterpret_cast<const void*>(table_grad_staged_of<kF, false>());
}

int encode_bwd_table_chunks(int B, int L, int P, int T) {
  if (!staged_fits(T)) return 0;
  return hist_chunks((int64_t)B * L, P, kStagedPoints);
}

// What the caller must allocate for a call with `chunks` blocks a row: 0 and
// 2 add into a zeroed output (the direct variant; a staged row split over
// blocks), 1 writes every entry (one staged block a row).
int plan_of(int chunks) { return chunks <= 1 ? chunks : 2; }

}  // namespace

extern "C" {

// 1 if ngm_encode_fwd takes the staged design for tables of T entries a
// level row, 0 if the direct one.
int ngm_encode_fwd_staged(int T) { return staged_fits(T) ? 1 : 0; }

// table (B, 2, L, T), coords (B, 3, P) -> out (B, 2L, P).
int ngm_encode_fwd(const float* table, const float* coords, float* out, int B,
                   int P, int L, int T, const float* scales, const float* shifts,
                   const float* elev, const int* caps, void* stream) {
  if (B > kMaxGridY) return (int)cudaErrorInvalidValue;
  LevelConsts c;
  const int err = fill_consts(&c, L, scales, shifts, elev, caps);
  if (err) return err;
  launch_encode_fwd(table, coords, out, B, P, L, T, c, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// coords (3, N) -> idx (L, 4, N) int32 and w (L, 4, N): lattice_level's
// corners, for tests of the lattice itself.
int ngm_lattice_debug(const float* coords, int32_t* idx, float* w, int N, int L,
                      const float* scales, const float* shifts, const float* elev,
                      const int* caps, void* stream) {
  LevelConsts c;
  const int err = fill_consts(&c, L, scales, shifts, elev, caps);
  if (err) return err;
  const dim3 grid((N + kThreads - 1) / kThreads, L);
  lattice_debug_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(coords, idx, w, N, c);
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
  const void* staged[18] = {
      reinterpret_cast<const void*>(&encode_bwd_table_staged_kernel),
      reinterpret_cast<const void*>(&encode_fwd_staged_kernel),
  };
  add_staged_gather_kernels<1>(staged + 2);
  add_staged_gather_kernels<2>(staged + 6);
  add_staged_gather_kernels<4>(staged + 10);
  add_staged_gather_kernels<8>(staged + 14);
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
// num_live () int32 on the device -> out (tiles, 2L, kTile); with w0 (not
// null) the field MLP on the device's stacked per-field weights w0
// (N, 2L, H), b0 (N, H), w1 (N, H, O), b1 (N, O) -> out (tiles, O, kTile).
int ngm_encode_fwd_moe(const float* tables, const float* coords,
                       const int* tile_experts, const int* num_live, const float* w0,
                       const float* b0, const float* w1, const float* b1, float* out,
                       int tiles, int L, int T, int H, int O, const float* scales,
                       const float* shifts, const float* elev, const int* caps,
                       void* stream) {
  LevelConsts c;
  const int err = fill_consts(&c, L, scales, shifts, elev, caps);
  if (err) return err;
  return launch_encode_fwd_moe(tables, CarriedPoints{coords}, tile_experts, num_live, out, tiles, T, c,
                               w0, b0, w1, b1, H, O, (cudaStream_t)stream);
}

// tables (N, 2, L, T), orig (tiles, kTile) int32 k-minor pair indices, dist
// (tiles, kTile), tile_experts (tiles,), num_live (), rayp (16,), poses
// (N, 7), all on the device -> out (tiles, 2L, kTile); with w0 (not null)
// the MLP of ngm_encode_fwd_moe -> out (tiles, O, kTile).
int ngm_encode_fwd_moe_rays(const float* tables, const int* orig,
                            const float* dist, const int* tile_experts,
                            const int* num_live, const float* rayp,
                            const float* poses, const float* w0, const float* b0,
                            const float* w1, const float* b1, float* out, int tiles, int L,
                            int T, int H, int O, int block_offset, int log2_ks, int width,
                            float coord_scale, float coord_shift,
                            const float* scales, const float* shifts,
                            const float* elev, const int* caps, void* stream) {
  LevelConsts c;
  const int err = fill_consts(&c, L, scales, shifts, elev, caps);
  if (err) return err;
  if (width < 1 || log2_ks < 0 || log2_ks > 30) return (int)cudaErrorInvalidValue;
  const RayPoints src = {orig, dist, rayp, poses, {block_offset, log2_ks, width, coord_scale, coord_shift}};
  return launch_encode_fwd_moe(tables, src, tile_experts, num_live, out, tiles, T, c,
                               w0, b0, w1, b1, H, O, (cudaStream_t)stream);
}

// 1 if ngm_gather_pairs takes the staged variant for this table, else 0.
int ngm_gather_pairs_staged(const float* table, int F, int T, int M) {
  return gather_pairs_staged(table, F, T, M) ? 1 : 0;
}

// table (rows, F, T), idx (rows, M) int64 -> out (rows, F, M).
int ngm_gather_pairs(const float* table, const int64_t* idx, float* out, int rows,
                     int F, int T, int M, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!gather_pairs_staged(table, F, T, M)) {
    if (F == 2) {
      launch_gather_direct<2>(table, idx, out, rows, F, T, M, s);
    } else {
      launch_gather_direct<0>(table, idx, out, rows, F, T, M, s);
    }
  } else if (F == 1) {
    launch_gather_pairs_staged<1>(table, idx, out, rows, T, M, s);
  } else if (F == 2) {
    launch_gather_pairs_staged<2>(table, idx, out, rows, T, M, s);
  } else if (F == 4) {
    launch_gather_pairs_staged<4>(table, idx, out, rows, T, M, s);
  } else {
    launch_gather_pairs_staged<8>(table, idx, out, rows, T, M, s);
  }
  return (int)cudaGetLastError();
}

// 0: ngm_table_grad takes the direct variant; 1: staged, one block a row,
// which writes every entry (the output needs no zeroing); 2: staged, rows
// split over blocks (a zeroed output).
int ngm_table_grad_plan(int rows, int F, int T, int M) {
  return plan_of(table_grad_chunks(rows, F, T, M));
}

// idx (rows, M) int64, gv (rows, F, M) -> grad (rows, F, T), zeroed by the
// caller unless ngm_table_grad_plan gives 1.
int ngm_table_grad(const int64_t* idx, const float* gv, float* grad, int rows, int F,
                   int T, int M, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int chunks = table_grad_chunks(rows, F, T, M);
  if (chunks == 0) {
    if (F == 2) {
      launch_table_grad_direct<2>(idx, gv, grad, rows, F, T, M, s);
    } else {
      launch_table_grad_direct<0>(idx, gv, grad, rows, F, T, M, s);
    }
  } else if (F == 1) {
    launch_table_grad_staged<1>(idx, gv, grad, rows, T, M, chunks, s);
  } else if (F == 2) {
    launch_table_grad_staged<2>(idx, gv, grad, rows, T, M, chunks, s);
  } else if (F == 4) {
    launch_table_grad_staged<4>(idx, gv, grad, rows, T, M, chunks, s);
  } else {
    launch_table_grad_staged<8>(idx, gv, grad, rows, T, M, chunks, s);
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
  if (!mlp_widths_ok(L, H, O) || B > kMaxGridY) return (int)cudaErrorInvalidValue;
  LevelConsts c;
  const int err = fill_consts(&c, L, scales, shifts, elev, caps);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  launch_encode_fwd(table, coords, feats, B, P, L, T, c, s);
  const cudaError_t enc_err = cudaGetLastError();
  if (enc_err != cudaSuccess) return (int)enc_err;
  const int per_block = kMlpThreads * kMlpFwdRounds;
  const dim3 grid((P + per_block - 1) / per_block, B);
  mlp_fwd_kernel<<<grid, kMlpThreads, 0, s>>>(feats, w0, b0, w1, b1, out, P, L, H, O);
  return (int)cudaGetLastError();
}

// What the caller of ngm_encode_mlp_bwd must allocate for the table
// gradient, as ngm_encode_bwd_table_plan says (0 zeroed, the direct
// design; 1 uninitialised, staged; 2 zeroed, staged with split rows).
int ngm_encode_mlp_bwd_plan(int B, int L, int P, int T) {
  return plan_of(encode_bwd_table_chunks(B, L, P, T));
}

// coords (B, 3, P), feats (B, 2L, P), g (B, O, P), w0, b0, w1 as above ->
// grad_table (B, 2, L, T) (allocated as ngm_encode_mlp_bwd_plan says),
// dw0 (B, 2L, H), db0 (B, H), dw1 (B, H, O), db1 (B, O), zeroed by the
// caller; dfeats (B, 2L, P) is the staged design's scratch for dL/df (may be
// null for the direct one).
int ngm_encode_mlp_bwd(const float* coords, const float* feats, const float* g,
                       const float* w0, const float* b0, const float* w1,
                       float* grad_table, float* dw0, float* db0, float* dw1,
                       float* db1, float* dfeats, int B, int P, int L, int T, int H, int O,
                       const float* scales, const float* shifts, const float* elev,
                       const int* caps, void* stream) {
  if (!mlp_widths_ok(L, H, O) || B > kMaxGridY) return (int)cudaErrorInvalidValue;
  const int chunks = encode_bwd_table_chunks(B, L, P, T);
  if (chunks > 0 && dfeats == nullptr) return (int)cudaErrorInvalidValue;
  LevelConsts c;
  const int err = fill_consts(&c, L, scales, shifts, elev, caps);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (chunks == 0) {
    const dim3 grid((P + kMlpThreads - 1) / kMlpThreads, B);
    encode_mlp_bwd_kernel<<<grid, kMlpThreads, 0, s>>>(
        coords, feats, g, w0, b0, w1, grad_table, dw0, db0, dw1, db1, P, T, H, O, c);
    return (int)cudaGetLastError();
  }
  const int per_block = kMlpThreads * kMlpRounds;
  const dim3 mlp_grid((P + per_block - 1) / per_block, B);
  mlp_bwd_kernel<<<mlp_grid, kMlpThreads, 0, s>>>(feats, g, w0, b0, w1, dfeats, dw0, db0, dw1, db1,
                                                  P, L, H, O);
  const cudaError_t mlp_err = cudaGetLastError();
  if (mlp_err != cudaSuccess) return (int)mlp_err;
  const int chunk = (P + chunks - 1) / chunks;
  const dim3 grid((unsigned)((int64_t)B * L), (P + chunk - 1) / chunk);
  encode_bwd_table_staged_kernel<<<grid, kBwdThreads, 8 * (size_t)T, s>>>(coords, dfeats, grad_table, P, T, chunk, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
