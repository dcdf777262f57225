// Hopper (sm_90a) kernels for the permutohedral hash encoding (training
// encode and table gradient, and the render path's tile-sorted MoE encodes)
// and the keyframe-visibility lookup, with a plain C interface for ctypes.
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

}  // extern "C"
