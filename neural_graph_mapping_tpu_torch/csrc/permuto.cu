// Hopper (sm_90a) kernels for the permutohedral hash encoding and the
// keyframe-visibility lookup, with a plain C interface for ctypes.
//
// Build (neural_graph_mapping_tpu_torch/ops/permuto_cuda.py does this at
// first use):
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

namespace {

constexpr int kMaxLevels = 32;
constexpr int kDim = 3;             // lattice dimension d (points are 3D)
constexpr int kCorners = kDim + 1;  // simplex corners per level
constexpr int kThreads = 256;

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
  const float* tab = table + (size_t)b * 2 * L * T;
  float* o = out + (size_t)b * 2 * L * P;
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
    o[(size_t)(2 * l) * P + p] = acc0;
    o[(size_t)(2 * l + 1) * P + p] = acc1;
  }
}

// Replaces permuto_pallas.encode_bwd_table (_encode_bwd_kernel): recompute
// the lattice and accumulate w_k * g[b, 2l+f, p] into grad[b, f, l, idx_k].
//
// Bound: global atomics. Each call issues ~50 M float atomicAdds into the
// 16 MiB gradient, which the L2 serves; on the coarse levels (512 and 1024
// entries) many points of a field hit the same entries, so those levels
// serialise on contended addresses. Design: one thread per (field, point),
// plain global atomicAdd (the original CUDA extension's scheme); the caller
// zeroes the gradient. The TPU's one-hot(idx>>6) x one-hot(idx&63) matmul
// decomposition worked around serial TPU scatters and is not carried over.
// Atomics make the summation order vary from run to run, so results agree
// with the plain version to rounding, not bit for bit.
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

// Replaces permuto_pallas.batched_gather (_batched_gather_kernel):
// out[b, m] = values[b, idx[b, m]], exact (no max-pooling).
//
// Bound: launch latency at the training shape (1000 keyframe slots x 640
// lookups, 2.5 MB of indices and outputs); each lookup is one scattered
// 4-byte read. Design: one thread per output element, coalesced index loads
// and output stores. Index bounds are the caller's contract, as in JAX.
// The TPU's lane-gather chunk sweep is not carried over.
__global__ void batched_gather_kernel(const float* __restrict__ values,
                                      const int64_t* __restrict__ idx,
                                      float* __restrict__ out, int N, int M,
                                      int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t b = e / M;
  out[e] = __ldg(values + b * N + idx[e]);
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

int ngm_encode_bwd_table(const float* coords, const float* g, float* grad, int B,
                         int P, int L, int T, const float* scales,
                         const float* shifts, const float* elev, const int* caps,
                         void* stream) {
  LevelConsts c;
  const int err = fill_consts(&c, L, scales, shifts, elev, caps);
  if (err) return err;
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  encode_bwd_table_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      coords, g, grad, P, T, c);
  return (int)cudaGetLastError();
}

int ngm_batched_gather(const float* values, const int64_t* idx, float* out, int B,
                       int N, int M, void* stream) {
  const int64_t total = (int64_t)B * M;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  batched_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      values, idx, out, N, M, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
