// Hopper (sm_90a) kernel for the render dispatch's nearest-field search,
// with a plain C interface for ctypes.
//
// Build (neural_graph_mapping_tpu_torch/ops/cuda_build.py does this at first
// use, in parallel with the other sources):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libngm_topk.so topk.cu
//
// Replaces neural_graph_mapping_tpu/ops/topk_pallas.py::topk2_fields
// (_topk2_kernel, _top2_chunk, _merge_top2): the two nearest VALID field
// centres of every point, ties to the lower field index, distance +inf for
// an invalid winner, index clamped to N - 1.
//
// Distances use the direct form (p - c)^2. The TPU kernel scores
// |c|^2 - 2 c.p to feed its matrix unit, which cancels at small distances
// (hence its Precision.HIGHEST); here there is no matrix unit to feed.
// With -fmad=false every operation rounds on its own, exactly as the plain
// PyTorch version (ops/topk.py topk2_fields_plain) rounds it, so the two
// agree bit for bit.
//
// Bound: bytes, the points in and the (2, P) distances and indices out
// (0.035 ms at 3.35 TB/s for a 4,194,304-point render block). The 8 f32
// operations of a (point, centre) pair count only for the pairs the
// pruning leaves (counted by the kernel itself, see below), a few
// microseconds of operations at 64 and at 1,024 centres. The first design (one thread a point, a branch
// on each centre's valid flag, two chained (distance, index) tests)
// issued ~26 instructions a pair, for every pair, and took 0.266 ms at 64
// centres (PERF.md §6). Design:
// - Branch-free update. The wrapper folds validity into the centres (an
//   invalid centre's x is +inf, so its distance to any finite point is
//   +inf exactly), and the centres are visited in ascending index. A slot
//   holds a distance's bits (non-negative floats order as their bits),
//   starting at kEmpty, above +inf's, with index N - 1. A centre then
//   enters a slot by a strict `<` alone, and the slots end as the
//   lexicographic (distance, index) top 2 of all centres, the plain
//   version's clamped (+inf, N - 1) padding included.
// - Exact pruning by warp. A warp takes kPoints x 32 consecutive points
//   (samples of one ray, so a short segment) and reduces their bounding
//   box. For every centre, lb and ub are the squared distances from it to
//   the nearest and the farthest point of the box, rounded as the
//   distances are, and U is the second-smallest ub. Rounding is monotonic,
//   so every point's computed distance to a centre lies between that
//   centre's lb and ub; a centre with lb * low > U * high is then strictly
//   farther than two other centres from every point of the warp, can be
//   neither of a point's two nearest, ties included, and is dropped. The
//   margins (low < 1 < high, spare) come with the launch from ops/topk.py,
//   which holds the rule's plain model; so does the box size, and a launch
//   that names another box than the kernel's is refused. With fewer than
//   two centres of finite ub, U is +inf and nothing is dropped.
// - The warp scans the centres 32 at a time, appends the survivors in
//   ascending index to its own buffer in shared memory (a ballot), and
//   evaluates the buffer whenever it is nearly full: each centre is one
//   broadcast 16-byte shared load for the thread's kPoints points, and no
//   barrier spans the block. Given box_survivors, a second instantiation
//   of the same kernel also writes how many centres each box kept, so a
//   caller can measure the pairs evaluated and hold the pruning against
//   its plain model; the render path does not ask for it.
// 2 points a thread (a 64-point box) was the fastest of 2, 4 and 8 points
// and of boxes over the whole block (256 to 2,048 points) in an A/B on an
// H100: it evaluates 8% of the pairs at the render block's 64 centres and
// 1.3% at 1,024 (PERF.md §6). The TPU kernel's 128-field chunking and
// matmul scoring are not carried over.
//
// The entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 2;     // points a thread: a warp's box holds 64
constexpr int kWarpBuf = 256;  // surviving centres a warp buffers (4 KiB)
constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kEmpty = 0xffffffffu;  // a slot's key before any centre: above +inf's bits

__device__ __forceinline__ float sq_dist(float x, float y, float z, float4 c) {
  const float dx = x - c.x;
  const float dy = y - c.y;
  const float dz = z - c.z;
  return dx * dx + dy * dy + dz * dz;
}

// Squared distances from centre c to the nearest (lb) and the farthest (ub)
// point of the box [lo, hi].
__device__ __forceinline__ void box_bounds(float4 c, const float lo[3], const float hi[3], float& lb,
                                           float& ub) {
  const float cc[3] = {c.x, c.y, c.z};
  float g[3], f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g[a] = fmaxf(fmaxf(lo[a] - cc[a], cc[a] - hi[a]), 0.0f);
    f[a] = fmaxf(cc[a] - lo[a], hi[a] - cc[a]);
  }
  lb = g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
  ub = f[0] * f[0] + f[1] * f[1] + f[2] * f[2];
}

// (u0, u1), the two smallest of a set, merged with (v0, v1), the two
// smallest of a disjoint one.
__device__ __forceinline__ void merge_two(float& u0, float& u1, float v0, float v1) {
  u1 = fminf(fminf(u1, v1), fmaxf(u0, v0));
  u0 = fminf(u0, v0);
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads) topk2_fields_kernel(
    const float* __restrict__ pts, const float4* __restrict__ centres, int N, int P, float low,
    float high, float* __restrict__ out_d, int* __restrict__ out_i, int* __restrict__ box_survivors) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float4 sbuf[kWarps][kWarpBuf];  // w = the centre's index bits
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = (blockIdx.x * kWarps + warp) * 32 * kPoints + lane;
  if (base - lane >= P) return;  // the whole warp: no barrier spans the block
  float4* buf = sbuf[warp];
  float x[kPoints], y[kPoints], z[kPoints];
  uint32_t m0[kPoints], m1[kPoints];
  int i0[kPoints], i1[kPoints];
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int r = 0; r < kPoints; ++r) {
    const int p = base + r * 32;
    x[r] = y[r] = z[r] = 0.0f;
    if (p < P) {
      x[r] = __ldg(pts + p);
      y[r] = __ldg(pts + (size_t)P + p);
      z[r] = __ldg(pts + 2 * (size_t)P + p);
      lo[0] = fminf(lo[0], x[r]);
      lo[1] = fminf(lo[1], y[r]);
      lo[2] = fminf(lo[2], z[r]);
      hi[0] = fmaxf(hi[0], x[r]);
      hi[1] = fmaxf(hi[1], y[r]);
      hi[2] = fmaxf(hi[2], z[r]);
    }
    m0[r] = m1[r] = kEmpty;
    i0[r] = i1[r] = N - 1;
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFullMask, lo[a], s));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFullMask, hi[a], s));
    }
  }
  // U: the second-smallest ub over all centres
  float u0 = CUDART_INF_F, u1 = CUDART_INF_F;
  for (int j = lane; j < N; j += 32) {
    float lb, ub;
    box_bounds(__ldg(centres + j), lo, hi, lb, ub);
    merge_two(u0, u1, ub, CUDART_INF_F);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    merge_two(u0, u1, __shfl_xor_sync(kFullMask, u0, s), __shfl_xor_sync(kFullMask, u1, s));
  }
  const float bound = u1 * high;

  int ns = 0;  // centres in the buffer, the same in every lane
  int kept = 0;  // centres the box kept (counted with kCount)
  for (int j0 = 0; j0 < N; j0 += 32) {
    const int j = j0 + lane;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bool keep = false;
    if (j < N) {
      c = __ldg(centres + j);
      float lb, ub;
      box_bounds(c, lo, hi, lb, ub);
      keep = !(lb * low > bound);
    }
    const unsigned votes = __ballot_sync(kFullMask, keep);
    if (keep) {
      c.w = __int_as_float(j);
      buf[ns + __popc(votes & ((1u << lane) - 1u))] = c;
    }
    ns += __popc(votes);
    if (kCount) kept += __popc(votes);
    if (ns > kWarpBuf - 32 || j0 + 32 >= N) {
      __syncwarp();
#pragma unroll 2
      for (int s = 0; s < ns; ++s) {
        const float4 cs = buf[s];
        const int js = __float_as_int(cs.w);
#pragma unroll
        for (int r = 0; r < kPoints; ++r) {
          const uint32_t d = __float_as_uint(sq_dist(x[r], y[r], z[r], cs));
          const bool lt0 = d < m0[r];
          const bool lt1 = d < m1[r];
          m1[r] = lt0 ? m0[r] : (lt1 ? d : m1[r]);
          i1[r] = lt0 ? i0[r] : (lt1 ? js : i1[r]);
          m0[r] = lt0 ? d : m0[r];
          i0[r] = lt0 ? js : i0[r];
        }
      }
      __syncwarp();  // the buffer is read before it is refilled
      ns = 0;
    }
  }
#pragma unroll
  for (int r = 0; r < kPoints; ++r) {
    const int p = base + r * 32;
    if (p < P) {
      out_d[p] = m0[r] == kEmpty ? CUDART_INF_F : sqrtf(__uint_as_float(m0[r]));
      out_d[(size_t)P + p] = m1[r] == kEmpty ? CUDART_INF_F : sqrtf(__uint_as_float(m1[r]));
      out_i[p] = i0[r];
      out_i[(size_t)P + p] = i1[r];
    }
  }
  if (kCount && lane == 0) box_survivors[blockIdx.x * kWarps + warp] = kept;
}

}  // namespace

extern "C" {

// pts (3, P) f32, centres (N, 4) f32 [x (+inf where invalid), y, z, unused]
// -> out_d (2, P) f32, out_i (2, P) int32. box_points must be the kernel's
// box (32 x kPoints consecutive points); low and high are the pruning
// test's margins. box_survivors, null on the render path, else
// (ceil(P / box_points),) int32: the centres each box kept.
int ngm_topk2_fields(const float* pts, const float* centres, int N, int P, int box_points,
                     float low, float high, float* out_d, int* out_i, int* box_survivors,
                     void* stream) {
  if (N < 1 || box_points != 32 * kPoints) return (int)cudaErrorInvalidValue;
  const int per_block = kThreads * kPoints;
  const int blocks = (P + per_block - 1) / per_block;
  const float4* c4 = reinterpret_cast<const float4*>(centres);
  if (box_survivors) {
    topk2_fields_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        pts, c4, N, P, low, high, out_d, out_i, box_survivors);
  } else {
    topk2_fields_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        pts, c4, N, P, low, high, out_d, out_i, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
