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

// -- gather route: per-(row, pair) lookups and their histogram ----------------
//
// A "row" is one (field, level): a (2, T) feature-major table slice and M
// hash indices (K corners x P points, flattened). gather_blend in
// ops/permuto.py takes this route for every shape the fused encode does not
// take (2D fields, point gradients).

// Replaces permuto_pallas.gather_pairs (_gather_kernel):
// out[r, f, m] = table[r, f, idx[r, m]], exact.
//
// Bound: one random 8-byte table read per pair (both features of an entry
// are T floats apart, so two 4-byte reads) plus the 8-byte index in and 8
// bytes out; the tables of a 2D field set at production widths (32 fields x
// 16 levels x 2 x 4096 f32 = 16 MiB) stay in L2. Design: one thread per
// (row, m), grid x over m and grid y over rows (a row loop past the grid's
// y limit), so no thread divides, and consecutive threads on consecutive
// pairs coalesce the index loads and output stores. The TPU's
// one-hot(idx>>6) x one-hot(idx&63) matmul existed because the TPU has no
// fast gather; it is not carried over. Index bounds are the caller's
// contract, as in JAX.
__global__ void gather_pairs_kernel(const float* __restrict__ table,
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

// Replaces permuto_pallas.table_grad (_table_grad_kernel): grad[r, f, idx[r, m]]
// += gv[r, f, m] into a zeroed (rows, 2, T) output.
//
// Bound: global atomics, two a pair, served by L2; coarse levels put many
// pairs of a row on the same entries and serialise there. Design: one thread
// per (row, m) on the grid of gather_pairs_kernel, plain global atomicAdd as
// encode_bwd_table_kernel; pairs whose two values are zero add nothing and
// are skipped. The summation order varies from run to run, so results agree
// with index_add_ to rounding, not bit for bit.
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
// histogram of encode_bwd_table_kernel driven by dL/df, which stays in
// registers and never reaches device memory.
//
// Bound: the histogram's global atomics (as encode_bwd_table_kernel) after
// streaming the residual, g and the coordinates once. Design: one thread per
// (field, point), grid y = field, kMlpThreads points a block. Each thread
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

// table (rows, 2, T), idx (rows, M) int64 -> out (rows, 2, M).
int ngm_gather_pairs(const float* table, const int64_t* idx, float* out, int rows,
                     int T, int M, void* stream) {
  const dim3 grid((M + kThreads - 1) / kThreads, rows < kMaxGridY ? rows : kMaxGridY);
  gather_pairs_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(table, idx, out, T, M,
                                                                  rows);
  return (int)cudaGetLastError();
}

// idx (rows, M) int64, gv (rows, 2, M) -> grad (rows, 2, T), zeroed by the caller.
int ngm_table_grad(const int64_t* idx, const float* gv, float* grad, int rows, int T,
                   int M, void* stream) {
  const dim3 grid((M + kThreads - 1) / kThreads, rows < kMaxGridY ? rows : kMaxGridY);
  table_grad_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(idx, gv, grad, T, M, rows);
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
