// Embedding lookup + combine for Hopper (sm_90a), bound with ctypes.
//
// Replaces two TPU kernels of elasticdl_tpu/ops/pallas_embedding.py:
//
// - `lookup_combine_pallas` -> `_lookup_kernel` (kernel #6 of PERF.md's
//   table): here `lookup_kernel`, one warp per output row;
// - `lookup_combine_aligned` -> `_lookup_aligned_kernel` (#5): here
//   `lookup_aligned_kernel`, the same contract with whole row strips
//   brought into shared memory by TMA bulk copies.
//
// Contract (both): table (V, D) f32, ids (B, L) int32, weights (B, L)
// f32 -> out (B, D) f32 with out[b] = sum_l w[b,l] * table[ids[b,l]]
// divided by 1 (sum), sum_l w (mean) or sqrt(sum_l w^2) (sqrtn); a zero
// denominator gives 0. The L ids of a row are summed in id order, in f32,
// as `_lookup_kernel` does. An id outside [0, V) reads as a zero row
// (no load); its weight still counts in the denominator. Any B, any D:
// no padding (the TPU kernels pad B to 8 rows and D to 128 lanes, and
// #5's TPU kernel reads 8-row aligned tiles; that layout is TPU tuning
// and is not carried over).
//
// What bounds them on the H100: the gather. At the recsys step's shape
// (B 512, L 32, D 256) they must read 16,384 rows of 1 KB (16.8 MB) plus
// ids, weights and out (~0.6 MB): ~5.2 us at 3.35 TB/s. The arithmetic
// (one multiply-add per element read) is nothing beside it. Rows are
// scattered over a 1 GB table, so each row is its own 1 KB burst: the
// kernel must keep enough independent row loads in flight to cover the
// memory latency (Little's law: ~2.7 MB across the card, ~20 KB an SM).
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
// TPU kernel's DMA ring (16 row DMAs outstanding, running on across a
// grid step's 8 output rows). A warp owns one strip of one output row:
// `cols` columns (32 to 1024 floats; a row wider than 1024 takes more
// strips, and a small batch splits its rows into narrower strips, never
// its ids, until the grid holds kFillWarpsPerSM warps an SM). The warp
// keeps a ring of `slots` strip buffers in shared memory, in stages of
// kStageSlots slots under one mbarrier; `slots` = min(L, kMaxSlots, what
// the block's share of the SM's shared memory holds), chosen at launch
// (`aligned_geometry`).
//
// - The bulk instance (D % 4 == 0, 16-byte aligned table and output):
//   lane j arms its stage's barrier with the j-th strip's bytes
//   (mbarrier.arrive.expect_tx) and copies the strip with one
//   cp.async.bulk, so one instruction issues a stage and the copies
//   cost no registers in flight. A bulk copy needs 16-byte aligned
//   addresses and a multiple of 16 bytes, hence the conditions.
// - The 4-byte instance (D 130, a table view at a 4-byte offset): the
//   same ring fed by per-lane 4-byte cp.async, each lane copying the
//   columns it will read; cp.async.mbarrier.arrive.noinc makes the
//   stage's barrier (32 arrivals) wait for them.
//
// The warp fills every stage, then adds its ids in order a stage at a
// time: one wait (parity = lap & 1; a wait costs ~40 ns even when the
// data has landed, so a barrier a slot is what this saves), then the
// stage's strips times w into its registers with no branch on an id,
// then the stage is refilled with the ids `slots` further on while the
// other stages stay in flight. An id outside the table issues no copy
// (a plain arrive) and reads the warp's zero strip, never its slot: no
// stale or uninitialised read, and exact zeros, as in the plain version;
// its weight still counts. Ids past L, in a last stage, do the same with
// weight 0. Refilling a stage that generic loads just read by bulk
// copies (the async proxy) is a write-after-read across proxies: each
// lane fences (fence.proxy.async) and the warp syncs before the copies
// issue. No copy is in flight when the warp exits.
//
// Numerics: each step of a sum is acc + w * x with the product rounded
// to f32 before the add (`__fmul_rn`, then `__fadd_rn`: intrinsics that
// nvcc never contracts into a fused multiply-add), in id order, as the
// plain version computes it (`lookup_combine_reference`); so are the
// weight sums. The normalisation divides and takes the square root
// correctly rounded (IEEE, no fast math). The kernels therefore give
// the plain version's result bit for bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"  // smem_u32, cp.async, mbarriers

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kTileCols = 1024;     // columns a warp covers
constexpr unsigned kFull = 0xffffffffu;

// The aligned kernel's geometry (`aligned_geometry`).
constexpr int kMinStripCols = 32;   // 128-byte strips at the narrowest
constexpr int kFillWarpsPerSM = 8;  // split rows until the grid has these
constexpr int kMaxSlots = 24;       // ring depth a warp
constexpr int kStageSlots = 8;      // slots under one barrier
constexpr int kMaxBlocksPerSM = 4;
constexpr int kSmemPerSM = 228 * 1024;     // an H100 SM's shared memory
constexpr int kSmemPerBlock = 227 * 1024;  // the most a block may take
constexpr int kSmemReserved = 1024;        // a block's system share

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
          for (int j = 0; j < kCols; ++j) {
            acc[j] = __fadd_rn(acc[j], __fmul_rn(ws[u], vals[u][j]));
          }
          sum_w = sum_w + ws[u];
          sum_w2 = __fadd_rn(sum_w2, __fmul_rn(ws[u], ws[u]));
        }
      }
    }
  }
  store_row<NV, VEC>(out + static_cast<size_t>(row) * dim, col0, dim, lane,
                     acc, denominator(combiner, sum_w, sum_w2));
}

// ---- the aligned kernel (#5) ------------------------------------------

// Bytes of a block's barriers (kWarpsPerBlock rings of `stages`),
// rounded up to 128 so the strip buffers after them start 128-byte
// aligned.
__host__ __device__ constexpr int ring_offset(int stages) {
  return (kWarpsPerBlock * stages * 8 + 127) / 128 * 128;
}

__device__ __forceinline__ bool in_table(int id, int vocab) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(vocab);
}

// acc += w * x, one step of a sum in id order: the product rounded
// before the add, never one fused multiply-add (the plain version's
// arithmetic, as #6's loop writes it).
__device__ __forceinline__ void fold(float& acc, float w, float x) {
  acc = __fadd_rn(acc, __fmul_rn(w, x));
}

// `bytes` (a multiple of 16) from global to shared memory by the TMA
// unit; the barrier counts them as they land.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Arrives on the barrier once every cp.async this thread issued before
// has landed (the arrival is one of the count the barrier was made with).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// Orders this thread's generic-proxy accesses to shared memory before
// later async-proxy ones (a bulk copy into the slot just read).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// CPL: columns a lane holds (a strip is 32 * CPL wide). BULK: the bulk
// instance (lanes read VW-float vectors (lane + 32 k) * VW); else the
// 4-byte instance (lane reads columns lane + 32 k).
template <int CPL, bool BULK>
__global__ void __launch_bounds__(kThreads)
lookup_aligned_kernel(const float* __restrict__ table,
                      const int* __restrict__ ids,
                      const float* __restrict__ weights,
                      float* __restrict__ out, int batch, int num_ids,
                      int vocab, int dim, int combiner, int strips,
                      int stage, int stages) {
  constexpr int kCols = 32 * CPL;                     // a strip's columns
  constexpr int VW = BULK ? (CPL < 4 ? CPL : 4) : 1;  // floats a read
  constexpr int kReads = CPL / VW;
  static_assert(kMaxSlots <= 32 && 32 % kStageSlots == 0,
                "a refill reads at most one chunk ahead; stages tile chunks");
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long item =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (item >= static_cast<long long>(batch) * strips) return;
  const int row = static_cast<int>(item / strips);  // a row's strips on
  const int col0 = static_cast<int>(item % strips) * kCols;  // neighbours
  const int width = min(kCols, dim - col0);         // the last is ragged
  const int slots = stage * stages;
  const uint32_t bar0 = smem_u32(smem) + 8u * warp * stages;
  float* ring = reinterpret_cast<float*>(smem + ring_offset(stages)) +
                static_cast<size_t>(warp) * (slots + 1) * kCols;
  const uint32_t ring0 = smem_u32(ring);
  float* zero = ring + slots * kCols;  // read for ids outside the table
#pragma unroll
  for (int k = 0; k < CPL; ++k) zero[lane + 32 * k] = 0.f;
  const float* src = table + col0;
  const int* row_ids = ids + static_cast<size_t>(row) * num_ids;
  const float* row_w = weights + static_cast<size_t>(row) * num_ids;

  // Ids and weights 32 at a time, lane j holding those of id base + j:
  // the chunk being added (`cur`) and the next one (`nxt`), loaded a
  // chunk ahead. A refill reads ids from one or the other.
  auto chunk_id = [&](int base) {
    return base + lane < num_ids ? __ldg(row_ids + base + lane) : -1;
  };
  auto chunk_w = [&](int base) {
    return base + lane < num_ids ? __ldg(row_w + base + lane) : 0.f;
  };
  int cur_id = chunk_id(0), nxt_id = chunk_id(32);
  float cur_w = chunk_w(0), nxt_w = chunk_w(32);

  if (lane < stages) {  // lane s makes stage s's barrier
    mbar_init(bar0 + 8 * lane, BULK ? stage : 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();  // the barriers and the zero strip are ready

  // Copies the strips of ids first .. first + stage - 1 into stage `st`
  // (`cur` starts at id `base`). An id past L or outside the table
  // copies nothing: its arrival carries no bytes.
  auto refill = [&](int st, int first, int base) {
    const uint32_t bar = bar0 + 8 * st;
    if constexpr (BULK) {  // lane j issues id first + j: one instruction
      const int p = first + lane;
      const int in_cur = __shfl_sync(kFull, cur_id, p & 31);
      const int in_nxt = __shfl_sync(kFull, nxt_id, p & 31);
      if (lane < stage) {
        const int id =
            p < num_ids ? (p - base < 32 ? in_cur : in_nxt) : -1;
        if (in_table(id, vocab)) {
          const uint32_t bytes = 4u * width;
          mbar_expect_tx(bar, bytes);
          bulk_copy(ring0 + 4u * kCols * (st * stage + lane),
                    src + static_cast<size_t>(id) * dim, bytes, bar);
        } else {
          mbar_arrive(bar);
        }
      }
    } else {  // every lane copies its columns of each id, then arrives
      for (int j = 0; j < stage && first + j < num_ids; ++j) {
        const int p = first + j;
        const int id =
            __shfl_sync(kFull, p - base < 32 ? cur_id : nxt_id, p & 31);
        if (in_table(id, vocab)) {
          float* dst = ring + (st * stage + j) * kCols;
          const float* row_src = src + static_cast<size_t>(id) * dim;
#pragma unroll
          for (int k = 0; k < kReads; ++k) {
            const int c = lane + 32 * k;
            if (c < width) cp_async_4(dst + c, row_src + c);
          }
        }
      }
      cp_async_arrive(bar);
    }
  };
  for (int st = 0; st < stages; ++st) refill(st, st * stage, 0);

  // Stage by stage: one wait, then the stage's ids in order, with no
  // branch on an id (a full stage unrolled, so its loads issue together);
  // then the stage is refilled with the ids `slots` further on while the
  // other stages stay in flight.
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  float sum_w = 0.f, sum_w2 = 0.f;
  unsigned cur_valid = __ballot_sync(kFull, in_table(cur_id, vocab));
  int st = 0;
  uint32_t phase = 0;
  for (int l0 = 0; l0 < num_ids; l0 += stage) {
    if (l0 > 0 && (l0 & 31) == 0) {
      cur_id = nxt_id;
      cur_w = nxt_w;
      cur_valid = __ballot_sync(kFull, in_table(cur_id, vocab));
      nxt_id = chunk_id(l0 + 32);
      nxt_w = chunk_w(l0 + 32);
    }
    mbar_wait(bar0 + 8 * st, phase);
    const float* strips0 = ring + st * stage * kCols;
    // Adds id l0 + j; an id outside the table, or past L (id -1, weight
    // 0), reads the zero strip: exact zeros, as in the plain version.
    // `cur_valid` has bit i set where the chunk's id i is in the table.
    auto add = [&](int j) {
      const int bit = (l0 + j) & 31;
      const float w = __shfl_sync(kFull, cur_w, bit);
      const float* strip =
          (cur_valid >> bit) & 1u ? strips0 + j * kCols : zero;
#pragma unroll
      for (int k = 0; k < kReads; ++k) {
        const int c = (lane + 32 * k) * VW;  // past a ragged end: zeros
        const float* x = (c < width ? strip : zero) + c;
        if constexpr (VW == 4) {
          const float4 v = *reinterpret_cast<const float4*>(x);
          fold(acc[4 * k], w, v.x);
          fold(acc[4 * k + 1], w, v.y);
          fold(acc[4 * k + 2], w, v.z);
          fold(acc[4 * k + 3], w, v.w);
        } else if constexpr (VW == 2) {
          const float2 v = *reinterpret_cast<const float2*>(x);
          fold(acc[2 * k], w, v.x);
          fold(acc[2 * k + 1], w, v.y);
        } else {
          fold(acc[k], w, *x);
        }
      }
      sum_w = sum_w + w;
      fold(sum_w2, w, w);
    };
    if (stage == kStageSlots) {
#pragma unroll
      for (int j = 0; j < kStageSlots; ++j) add(j);
    } else {
      for (int j = 0; j < stage; ++j) add(j);
    }
    const int next = l0 + slots;
    if (next < num_ids) {
      if constexpr (BULK) fence_proxy_async();
      __syncwarp();  // every lane has read the stage before it refills
      refill(st, next, l0 & ~31);
    }
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }
  }

  const float d = denominator(combiner, sum_w, sum_w2);
  float* out_row = out + static_cast<size_t>(row) * dim + col0;
#pragma unroll
  for (int k = 0; k < kReads; ++k) {
    const int c = (lane + 32 * k) * VW;
    if (c < width) {
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(out_row + c) = make_float4(
            normalise(acc[4 * k], d), normalise(acc[4 * k + 1], d),
            normalise(acc[4 * k + 2], d), normalise(acc[4 * k + 3], d));
      } else if constexpr (VW == 2) {
        *reinterpret_cast<float2*>(out_row + c) = make_float2(
            normalise(acc[2 * k], d), normalise(acc[2 * k + 1], d));
      } else {
        out_row[c] = normalise(acc[k], d);
      }
    }
  }
}

struct AlignedGeometry {
  int cols;    // a strip's columns: 32 * CPL
  int strips;  // strips of an output row
  int stage;   // slots under one barrier
  int stages;  // barriers of a warp's ring (stage * stages slots)
  int blocks;  // grid
  int smem;    // dynamic shared memory of a block, bytes
};

// Strips as wide as the row (up to 1024 columns), halved while the grid
// has fewer than kFillWarpsPerSM warps an SM and they are wider than
// kMinStripCols; then as many slots (up to L and kMaxSlots) as a block's
// share of the SM's shared memory holds beside a zero strip a warp, a
// share set by the blocks each SM must take (at most kMaxBlocksPerSM).
cudaError_t aligned_geometry(int batch, int num_ids, int dim, int sms,
                             AlignedGeometry* g) {
  const int want = dim < kTileCols ? dim : kTileCols;
  int cols = kMinStripCols;
  while (cols < want) cols *= 2;
  const long long fill = static_cast<long long>(kFillWarpsPerSM) * sms;
  while (cols > kMinStripCols &&
         static_cast<long long>(batch) * ((dim + cols - 1) / cols) < fill)
    cols /= 2;
  const int strips = (dim + cols - 1) / cols;
  const long long blocks =
      (static_cast<long long>(batch) * strips + kWarpsPerBlock - 1) /
      kWarpsPerBlock;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  long long per_sm = (blocks + sms - 1) / sms;
  if (per_sm > kMaxBlocksPerSM) per_sm = kMaxBlocksPerSM;
  int budget = static_cast<int>(kSmemPerSM / per_sm) - kSmemReserved;
  if (budget > kSmemPerBlock) budget = kSmemPerBlock;
  const int slot_bytes = 4 * cols;
  int slots =
      (budget - 128) / (kWarpsPerBlock * (slot_bytes + 8)) - 1;  // + zero
  if (slots > kMaxSlots) slots = kMaxSlots;
  if (slots > num_ids) slots = num_ids;
  g->cols = cols;
  g->strips = strips;
  // A stage is a power of two (it tiles the 32-id chunks), at most
  // kStageSlots and at most the slots (>= 2: 4 KB strips, 4 blocks an SM).
  g->stage = kStageSlots;
  while (g->stage > slots) g->stage /= 2;
  g->stages = slots / g->stage;
  g->blocks = static_cast<int>(blocks);
  g->smem = ring_offset(g->stages) +
            kWarpsPerBlock * (g->stage * g->stages + 1) * slot_bytes;
  return cudaSuccess;
}

// Whether the bulk instance takes these arguments (see the design note).
bool bulk_instance(const void* table, const void* out, int dim) {
  return dim % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// The geometry on the current device.
cudaError_t plan(int batch, int num_ids, int dim, AlignedGeometry* g) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return aligned_geometry(batch, num_ids, dim, sms, g);
}

template <int CPL, bool BULK>
cudaError_t launch_aligned(const AlignedGeometry& g, const float* table,
                           const int* ids, const float* weights, float* out,
                           int batch, int num_ids, int vocab, int dim,
                           int combiner, cudaStream_t stream) {
  auto kernel = lookup_aligned_kernel<CPL, BULK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerBlock);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<g.blocks, kThreads, g.smem, stream>>>(
      table, ids, weights, out, batch, num_ids, vocab, dim, combiner,
      g.strips, g.stage, g.stages);
  return cudaGetLastError();
}

template <bool BULK>
cudaError_t dispatch_aligned(const AlignedGeometry& g, const float* table,
                             const int* ids, const float* weights,
                             float* out, int batch, int num_ids, int vocab,
                             int dim, int combiner, cudaStream_t stream) {
  switch (g.cols) {
    case 32:
      return launch_aligned<1, BULK>(g, table, ids, weights, out, batch,
                                     num_ids, vocab, dim, combiner, stream);
    case 64:
      return launch_aligned<2, BULK>(g, table, ids, weights, out, batch,
                                     num_ids, vocab, dim, combiner, stream);
    case 128:
      return launch_aligned<4, BULK>(g, table, ids, weights, out, batch,
                                     num_ids, vocab, dim, combiner, stream);
    case 256:
      return launch_aligned<8, BULK>(g, table, ids, weights, out, batch,
                                     num_ids, vocab, dim, combiner, stream);
    case 512:
      return launch_aligned<16, BULK>(g, table, ids, weights, out, batch,
                                      num_ids, vocab, dim, combiner, stream);
    default:
      return launch_aligned<32, BULK>(g, table, ids, weights, out, batch,
                                      num_ids, vocab, dim, combiner, stream);
  }
}

template <int NV, bool VEC>
cudaError_t launch(const float* table, const int* ids, const float* weights,
                   float* out, int batch, int num_ids, int vocab, int dim,
                   int combiner, cudaStream_t stream) {
  const dim3 grid((batch + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (dim + kTileCols - 1) / kTileCols);
  lookup_kernel<NV, VEC><<<grid, kThreads, 0, stream>>>(
      table, ids, weights, out, batch, num_ids, vocab, dim, combiner);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch(const float* table, const int* ids,
                     const float* weights, float* out, int batch,
                     int num_ids, int vocab, int dim, int combiner,
                     cudaStream_t stream) {
  const int tile = dim < kTileCols ? dim : kTileCols;
  const int nv = (tile + 127) / 128;
  if (nv <= 1)
    return launch<1, VEC>(table, ids, weights, out, batch, num_ids, vocab,
                          dim, combiner, stream);
  if (nv <= 2)
    return launch<2, VEC>(table, ids, weights, out, batch, num_ids, vocab,
                          dim, combiner, stream);
  if (nv <= 4)
    return launch<4, VEC>(table, ids, weights, out, batch, num_ids, vocab,
                          dim, combiner, stream);
  return launch<8, VEC>(table, ids, weights, out, batch, num_ids, vocab,
                        dim, combiner, stream);
}

bool bad_arguments(int batch, int num_ids, int vocab, int dim,
                   int combiner) {
  return batch <= 0 || num_ids <= 0 || vocab <= 0 || dim <= 0 ||
         combiner < 0 || combiner > 2;
}

int lookup(bool aligned, const void* table, const void* ids,
           const void* weights, void* out, int batch, int num_ids, int vocab,
           int dim, int combiner, void* stream) {
  if (bad_arguments(batch, num_ids, vocab, dim, combiner))
    return cudaErrorInvalidValue;
  const bool vec = bulk_instance(table, out, dim);
  auto t = static_cast<const float*>(table);
  auto i = static_cast<const int*>(ids);
  auto w = static_cast<const float*>(weights);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (aligned) {
    AlignedGeometry g;
    const cudaError_t err = plan(batch, num_ids, dim, &g);
    if (err != cudaSuccess) return err;
    return vec ? dispatch_aligned<true>(g, t, i, w, o, batch, num_ids,
                                        vocab, dim, combiner, s)
               : dispatch_aligned<false>(g, t, i, w, o, batch, num_ids,
                                         vocab, dim, combiner, s);
  }
  return vec ? dispatch<true>(t, i, w, o, batch, num_ids, vocab, dim,
                              combiner, s)
             : dispatch<false>(t, i, w, o, batch, num_ids, vocab, dim,
                               combiner, s);
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

// The aligned kernel's launch on the current device for these arguments,
// into plan[7]: {bulk instance (1) or 4-byte (0), strip columns, strips
// a row, slots a stage, stages a warp, blocks, shared memory a block in
// bytes}.
extern "C" int edl_embedding_lookup_aligned_plan(const void* table,
                                                 const void* out, int batch,
                                                 int num_ids, int dim,
                                                 int* out_plan) {
  if (bad_arguments(batch, num_ids, 1, dim, 0)) return cudaErrorInvalidValue;
  AlignedGeometry g;
  const cudaError_t err = plan(batch, num_ids, dim, &g);
  if (err != cudaSuccess) return err;
  const int values[7] = {bulk_instance(table, out, dim) ? 1 : 0, g.cols,
                         g.strips, g.stage, g.stages, g.blocks, g.smem};
  for (int k = 0; k < 7; ++k) out_plan[k] = values[k];
  return cudaSuccess;
}

extern "C" const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
