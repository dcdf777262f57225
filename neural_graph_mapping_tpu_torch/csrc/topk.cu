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
// Bound: arithmetic. A render block is 4,194,304 points x N centres
// (N = 128 at the smoke map's capacity): 8 f32 operations a pair, ~4.3
// GFLOP against ~117 MB of points and results. Design: one thread per
// point, coordinates in registers, the centres (xyz + valid flag as one
// float4) staged in shared memory in chunks of kChunk, so every warp reads
// each centre as a broadcast; a running lexicographic (distance, index)
// top-2 in registers. Only the (2, P) distances and indices are written.
// The TPU kernel's 128-field chunking and matmul scoring are not carried
// over.
//
// The entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;  // centres per shared-memory chunk (32 KiB)

// (v1, i1) < (v2, i2) lexicographically: argmin's first-index tie rule
__device__ __forceinline__ bool lex_less(float v1, int i1, float v2, int i2) {
  return v1 < v2 || (v1 == v2 && i1 < i2);
}

__global__ void topk2_fields_kernel(const float* __restrict__ pts,
                                    const float4* __restrict__ centres, int N,
                                    int P, float* __restrict__ out_d,
                                    int* __restrict__ out_i) {
  __shared__ float4 sc[kChunk];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (p < P) {
    x = pts[p];
    y = pts[(size_t)P + p];
    z = pts[2 * (size_t)P + p];
  }
  float m0 = CUDART_INF_F, m1 = CUDART_INF_F;
  int i0 = INT32_MAX, i1 = INT32_MAX;  // sentinels lose every tie
  for (int base = 0; base < N; base += kChunk) {
    const int n = min(kChunk, N - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) sc[j] = centres[base + j];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 c = sc[j];
      float d = CUDART_INF_F;
      if (c.w != 0.0f) {
        const float dx = x - c.x;
        const float dy = y - c.y;
        const float dz = z - c.z;
        d = dx * dx + dy * dy + dz * dz;
      }
      const int idx = base + j;
      if (lex_less(d, idx, m0, i0)) {
        m1 = m0;
        i1 = i0;
        m0 = d;
        i0 = idx;
      } else if (lex_less(d, idx, m1, i1)) {
        m1 = d;
        i1 = idx;
      }
    }
  }
  if (p >= P) return;
  out_d[p] = sqrtf(m0);
  out_d[(size_t)P + p] = sqrtf(m1);
  out_i[p] = min(i0, N - 1);
  out_i[(size_t)P + p] = min(i1, N - 1);
}

}  // namespace

extern "C" {

// pts (3, P) f32, centres (N, 4) f32 [x, y, z, valid != 0] -> out_d (2, P)
// f32, out_i (2, P) int32.
int ngm_topk2_fields(const float* pts, const float* centres, int N, int P,
                     float* out_d, int* out_i, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (P + kThreads - 1) / kThreads;
  topk2_fields_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pts, reinterpret_cast<const float4*>(centres), N, P, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
