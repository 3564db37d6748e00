// Embedding lookup + combine for Hopper (sm_90a), bound with ctypes.
//
// Replaces two TPU kernels of elasticdl_tpu/ops/pallas_embedding.py:
//
// - `lookup_combine_pallas` -> `_lookup_kernel` (kernel #6 of PERF.md's
//   table): here `lookup_kernel`, one warp per output row;
// - `lookup_combine_aligned` -> `_lookup_aligned_kernel` (#5): here
//   `lookup_aligned_kernel`, the same contract with the rows staged
//   through shared memory by cp.async.
//
// Contract (both): table (V, D) f32, ids (B, L) int32, weights (B, L)
// f32 -> out (B, D) f32 with out[b] = sum_l w[b,l] * table[ids[b,l]]
// divided by 1 (sum), sum_l w (mean) or sqrt(sum_l w^2) (sqrtn); a zero
// denominator gives 0. The L ids of a row are summed in id order, in f32,
// as `_lookup_kernel` does. An id outside [0, V) reads as a zero row
// (no load); its weight still counts in the denominator. Any B, any D:
// no padding (the TPU kernels pad B to 8 rows and D to 128 lanes; that
// layout is TPU tuning and is not carried over).
//
// What bounds them on the H100: the gather. At the recsys step's shape
// (B 512, L 32, D 256) they must read 16,384 rows of 1 KB (16.8 MB) plus
// ids, weights and out (~0.6 MB): ~5.2 us at 3.35 TB/s. The arithmetic
// (one multiply-add per element read) is nothing beside it. Rows are
// scattered over a 1 GB table, so each row is its own 1 KB burst: the
// kernel must keep enough independent row loads in flight to cover the
// memory latency.
//
// Design of `lookup_kernel` (#6): one warp per output row, four warps a
// block, 1024 columns a warp (wider rows take more blocks along y).
// Lanes span the row with 16-byte loads (float4) when D % 4 == 0 and the
// table is 16-byte aligned, with 4-byte loads otherwise. Each lane keeps
// its columns' sums in registers. The warp reads 32 ids and weights at a
// time (one per lane) and broadcasts them with shuffles; it then loads
// U rows before adding any of them (U x NV float4 loads in flight a
// lane, 16 in all), and adds them in id order.
//
// Design of `lookup_aligned_kernel` (#5): the Hopper counterpart of the
// TPU kernel's DMA ring. Each warp owns a ring of 4 row buffers in
// shared memory; cp.async copies the rows of ids l+1..l+3 into the ring
// while the warp adds row l. Each lane copies and reads only its own
// columns, so cp.async.wait_group alone orders the copies before the
// reads: no barrier. The loads need no registers while in flight.
//
// Numerics: acc = acc + w * x is contracted to one fused multiply-add by
// nvcc (the plain version rounds the product first), so the sums differ
// from the plain version in the last bits; the normalisation divides
// (IEEE, no fast math).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kTileCols = 1024;     // columns a warp covers
constexpr int kStages = 4;          // ring depth of the aligned kernel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float normalise(float acc, float d) {
  const bool positive = d > 0.f;
  return positive ? acc / (positive ? d : 1.f) : 0.f;
}

__device__ __forceinline__ float denominator(int combiner, float sum_w,
                                             float sum_w2) {
  if (combiner == 0) return 1.f;
  if (combiner == 1) return sum_w;
  return sqrtf(sum_w2);
}

// The lane's columns within the tile: with VEC, float4 v of the lane
// covers (lane + 32 v) * 4 .. +3; without, float j covers lane + 32 j.
template <bool VEC>
__device__ __forceinline__ int column(int lane, int j) {
  return VEC ? (lane + 32 * (j >> 2)) * 4 + (j & 3) : lane + 32 * j;
}

template <int NV, bool VEC>
__device__ __forceinline__ void store_row(float* out_row, int col0, int dim,
                                          int lane, const float* acc,
                                          float d) {
  constexpr int kCols = 4 * NV;
  if (VEC) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = col0 + (lane + 32 * v) * 4;
      if (c < dim) {
        float4 o;
        o.x = normalise(acc[4 * v], d);
        o.y = normalise(acc[4 * v + 1], d);
        o.z = normalise(acc[4 * v + 2], d);
        o.w = normalise(acc[4 * v + 3], d);
        *reinterpret_cast<float4*>(out_row + c) = o;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = col0 + column<false>(lane, j);
      if (c < dim) out_row[c] = normalise(acc[j], d);
    }
  }
}

template <int NV, bool VEC>
__global__ void __launch_bounds__(kThreads)
lookup_kernel(const float* __restrict__ table, const int* __restrict__ ids,
              const float* __restrict__ weights, float* __restrict__ out,
              int batch, int num_ids, int vocab, int dim, int combiner) {
  constexpr int kCols = 4 * NV;       // floats a lane holds
  constexpr int U = 16 / NV;          // rows loaded before any is added
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= batch) return;
  const int col0 = blockIdx.y * kTileCols;
  const int* row_ids = ids + static_cast<size_t>(row) * num_ids;
  const float* row_w = weights + static_cast<size_t>(row) * num_ids;

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  float sum_w = 0.f, sum_w2 = 0.f;

  for (int base = 0; base < num_ids; base += 32) {
    const int n = min(32, num_ids - base);
    const int my_id = lane < n ? __ldg(row_ids + base + lane) : -1;
    const float my_w = lane < n ? __ldg(row_w + base + lane) : 0.f;
    for (int k = 0; k < n; k += U) {
      float vals[U][kCols];
      float ws[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int id = __shfl_sync(kFull, my_id, (k + u) & 31);
        ws[u] = __shfl_sync(kFull, my_w, (k + u) & 31);
        const bool load = k + u < n && id >= 0 && id < vocab;
        const float* src = table + static_cast<size_t>(load ? id : 0) * dim;
        if (VEC) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int c = col0 + (lane + 32 * v) * 4;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (load && c < dim) x = __ldg(reinterpret_cast<const float4*>(src + c));
            vals[u][4 * v] = x.x;
            vals[u][4 * v + 1] = x.y;
            vals[u][4 * v + 2] = x.z;
            vals[u][4 * v + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const int c = col0 + column<false>(lane, j);
            vals[u][j] = (load && c < dim) ? __ldg(src + c) : 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + u < n) {           // in id order
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[j] = acc[j] + ws[u] * vals[u][j];
          sum_w = sum_w + ws[u];
          sum_w2 = sum_w2 + ws[u] * ws[u];
        }
      }
    }
  }
  store_row<NV, VEC>(out + static_cast<size_t>(row) * dim, col0, dim, lane,
                     acc, denominator(combiner, sum_w, sum_w2));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies the lane's columns of one row into a ring slot; an invalid id
// (or a column past the end) fills zeros without reading (src-size 0).
template <int NV, bool VEC>
__device__ __forceinline__ void stage_row(float* slot, const float* table,
                                          int id, int vocab, int dim,
                                          int col0, int lane) {
  const bool valid = id >= 0 && id < vocab;
  const float* src = table + static_cast<size_t>(valid ? id : 0) * dim + col0;
  if (VEC) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = (lane + 32 * v) * 4;
      const int bytes = (valid && col0 + c < dim) ? 16 : 0;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(slot + c)),
                   "l"(bytes ? src + c : table), "r"(bytes));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4 * NV; ++j) {
      const int c = column<false>(lane, j);
      const int bytes = (valid && col0 + c < dim) ? 4 : 0;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(slot + c)),
                   "l"(bytes ? src + c : table), "r"(bytes));
    }
  }
}

template <int NV, bool VEC>
__global__ void __launch_bounds__(kThreads)
lookup_aligned_kernel(const float* __restrict__ table,
                      const int* __restrict__ ids,
                      const float* __restrict__ weights,
                      float* __restrict__ out, int batch, int num_ids,
                      int vocab, int dim, int combiner) {
  constexpr int kCols = 4 * NV;
  constexpr int kSlot = 128 * NV;     // floats of one ring slot
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* ring = reinterpret_cast<float*>(smem4) + warp * kStages * kSlot;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= batch) return;
  const int col0 = blockIdx.y * kTileCols;
  const int* row_ids = ids + static_cast<size_t>(row) * num_ids;
  const float* row_w = weights + static_cast<size_t>(row) * num_ids;

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  float sum_w = 0.f, sum_w2 = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_ids)
      stage_row<NV, VEC>(ring + s * kSlot, table, __ldg(row_ids + s), vocab,
                         dim, col0, lane);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int l = 0; l < num_ids; ++l) {
    const int ahead = l + kStages - 1;
    if (ahead < num_ids)
      stage_row<NV, VEC>(ring + (ahead % kStages) * kSlot, table,
                         __ldg(row_ids + ahead), vocab, dim, col0, lane);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    const float* slot = ring + (l % kStages) * kSlot;
    const float w = __ldg(row_w + l);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      acc[j] = acc[j] + w * slot[column<VEC>(lane, j)];
    sum_w = sum_w + w;
    sum_w2 = sum_w2 + w * w;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  store_row<NV, VEC>(out + static_cast<size_t>(row) * dim, col0, dim, lane,
                     acc, denominator(combiner, sum_w, sum_w2));
}

template <int NV, bool VEC>
cudaError_t launch(bool aligned, const float* table, const int* ids,
                   const float* weights, float* out, int batch, int num_ids,
                   int vocab, int dim, int combiner, cudaStream_t stream) {
  const dim3 grid((batch + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (dim + kTileCols - 1) / kTileCols);
  if (aligned) {
    const int smem = kWarpsPerBlock * kStages * 128 * NV *
                     static_cast<int>(sizeof(float));
    auto kernel = lookup_aligned_kernel<NV, VEC>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<grid, kThreads, smem, stream>>>(table, ids, weights, out, batch,
                                             num_ids, vocab, dim, combiner);
  } else {
    lookup_kernel<NV, VEC><<<grid, kThreads, 0, stream>>>(
        table, ids, weights, out, batch, num_ids, vocab, dim, combiner);
  }
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch(bool aligned, const float* table, const int* ids,
                     const float* weights, float* out, int batch,
                     int num_ids, int vocab, int dim, int combiner,
                     cudaStream_t stream) {
  const int tile = dim < kTileCols ? dim : kTileCols;
  const int nv = (tile + 127) / 128;
  if (nv <= 1)
    return launch<1, VEC>(aligned, table, ids, weights, out, batch, num_ids,
                          vocab, dim, combiner, stream);
  if (nv <= 2)
    return launch<2, VEC>(aligned, table, ids, weights, out, batch, num_ids,
                          vocab, dim, combiner, stream);
  if (nv <= 4)
    return launch<4, VEC>(aligned, table, ids, weights, out, batch, num_ids,
                          vocab, dim, combiner, stream);
  return launch<8, VEC>(aligned, table, ids, weights, out, batch, num_ids,
                        vocab, dim, combiner, stream);
}

int lookup(bool aligned, const void* table, const void* ids,
           const void* weights, void* out, int batch, int num_ids, int vocab,
           int dim, int combiner, void* stream) {
  if (batch <= 0 || num_ids <= 0 || vocab <= 0 || dim <= 0 ||
      combiner < 0 || combiner > 2)
    return cudaErrorInvalidValue;
  const bool vec = dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto t = static_cast<const float*>(table);
  auto i = static_cast<const int*>(ids);
  auto w = static_cast<const float*>(weights);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? dispatch<true>(aligned, t, i, w, o, batch, num_ids, vocab, dim,
                              combiner, s)
             : dispatch<false>(aligned, t, i, w, o, batch, num_ids, vocab,
                               dim, combiner, s);
}

}  // namespace

// combiner: 0 sum, 1 mean, 2 sqrtn. Returns a cudaError_t (0 = launched).
extern "C" int edl_embedding_lookup(const void* table, const void* ids,
                                    const void* weights, void* out,
                                    int batch, int num_ids, int vocab,
                                    int dim, int combiner, void* stream) {
  return lookup(false, table, ids, weights, out, batch, num_ids, vocab, dim,
                combiner, stream);
}

extern "C" int edl_embedding_lookup_aligned(const void* table,
                                            const void* ids,
                                            const void* weights, void* out,
                                            int batch, int num_ids,
                                            int vocab, int dim, int combiner,
                                            void* stream) {
  return lookup(true, table, ids, weights, out, batch, num_ids, vocab, dim,
                combiner, stream);
}

extern "C" const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
