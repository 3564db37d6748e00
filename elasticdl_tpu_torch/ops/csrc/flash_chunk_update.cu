// Ring-attention chunk update for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Replaces the TPU kernel elasticdl_tpu/ops/flash_attention.py
// `flash_chunk_update` -> `_chunk_kernel` / `_scratch_tile_update`: folds
// one K/V chunk into the carried online-softmax state of a block of
// queries at global positions, the inner step of the ring forward
// (`ring_attention._ring_local_pallas_fwd`):
//
//   s = (q k^T) * scale              f32 accumulate, scale after the product
//   s = -1e30 where q_off + i < k_off + j   (causal), or past the chunk's end
//   m_new = max(m, rowmax s),  p = exp(s - m_new), p = 0 where masked
//   alpha = exp(m - m_new)
//   l = l * alpha + rowsum p,  acc = acc * alpha + (p in v's dtype) v
//
// q (BH, Sq, D), k/v (BH, Sk, D) in bf16 or f32; m, l (BH, Sq, 1) and
// acc (BH, Sq, D) f32. The carry is read from m_in/l_in/acc_in and
// written to m_out/l_out/acc_out, which may be the same buffers: a block
// owns its query rows, and reads its carry before its tile loop and
// writes it after. Nothing is normalised: the caller divides by
// max(l, 1e-30) after the last chunk.
//
// What bounds it on the H100: at the ring's local block (BH 4, Sq = Sk =
// 2048, D 128, bf16) a past chunk must move q, k, v (2.1 MB each) and the
// f32 carry in and out (8.4 MB), ~14.8 MB or 4.4 us at 3.35 TB/s, and
// do 8.6 GFLOP, 8.7 us at 989 TFLOP/s: compute bound on paper, a
// diagonal chunk half that. The score tile must never reach device
// memory. The Pallas grid's sequential k axis is a loop inside a block
// over the chunk's 64-key tiles; tiles wholly after every query of the
// block's 64-row q tile (global positions) are never loaded, and only a
// tile that crosses the diagonal or is ragged pays for the mask. bf16
// takes one of two kernels, by head dim:
//
// - D 64 and 128: `flash_chunk_wgmma_kernel`, the dq kernel's shape
//   (flash_attention_bwd.cu) with the forward's online softmax. The q
//   tile stays; a producer warpgroup loads it once by TMA, then streams
//   the 64-key K and V tiles by TMA into a four-slot ring (two slots a
//   consumer) under full and empty mbarriers. Two consumer warpgroups
//   take alternate key tiles, each with its own (m, l, acc) for the 64
//   rows in registers: consumer 0 starts from the carry, consumer 1 from
//   the empty state (-1e30, 0, 0). A consumer computes S = Q K^T with
//   wgmma m64n64k16 from shared memory (Q and K K-major in the 128-byte
//   swizzle TMA writes), takes the online softmax on S's accumulator in
//   log2 units (masks are selects; masked p is set to exact zero; p =
//   2^(s - m), never the fused 2^(s log2(e) - m log2(e)), which turns an
//   exact 0 into ~1e22 near +-1e30), packs p to bf16 in place as the
//   register A operand and adds acc += P V with wgmma reading the same
//   slot's V tile MN-major (the transpose bit). After the loop consumer
//   1's state reaches consumer 0 through the idle ring, and consumer 0
//   merges: m = max(m0, m1), each side scaled by 2^(m_i - m). The
//   carry's m comes in and m_out goes out in natural units; a row whose
//   maximum never rose above its carry's keeps the carry's m bit for
//   bit. The producer gives registers back with setmaxnreg (24) and the
//   consumers take 240. 145 KB of shared memory at D 128: one block an
//   SM, and the ring's local block (BH 4 x 2048) is 128 blocks, one
//   wave. Blocks start heads fastest, heaviest causal q tile first. A q
//   tile that no key reaches issues no TMA and copies its carry through
//   to the outputs; a consumer with no tile waits on no barrier. The
//   tensor maps are 3-D (D, S, BH): a ragged tile's rows past S arrive
//   as zeros (not the next head's rows), whose scores are 0, and keys
//   past Sk are masked all the same.
// - D 16 and 32: `flash_chunk_bf16_kernel`, the first design: 4 warps of 16
//   rows, both products on the tensor cores with mma.sync m16n8k16 (bf16
//   in, f32 accumulate), scores, probabilities and the accumulator in
//   registers (the S accumulator fragment is PV's A operand, packed to
//   bf16 in place), Q/K/V tiles in shared memory with rows padded by 16
//   bytes; the carry loads straight into the fragments.
//
// p's bf16 rounding depends on the running maximum it is taken against,
// so the bf16 results follow each route's order: 64-key tiles in turn
// (mma.sync), or the even tiles folded into the carry and the odd ones
// into an empty state, then merged (wgmma); `chunk_block_k` and
// `chunk_consumers` in ops/flash_attention.py name it, and the plain
// version folds in that order for the checks.
//
// Any Sq and Sk: ragged last q and K/V tiles are loaded with zero rows;
// keys past Sk are masked, q rows past Sq are neither read nor stored.
// Head dims 16, 32, 64 and 128 are template instances. f32 inputs take a
// scalar kernel with the same tiling (scores and accumulator in shared
// memory, two lanes per row). ptxas -v prints every kernel's registers,
// spills and shared memory at each build (chip_smoke.py shows them).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr int kBlock = 64;              // q rows per block, k rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = kBlock / kWarps;  // 16
constexpr float kNegInf = -1e30f;

template <int D>
struct Bf16Layout {
  static constexpr int ld = D + 8;
  static constexpr size_t tile = static_cast<size_t>(kBlock) * ld;  // elems
  static constexpr size_t bytes = 3 * tile * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_raw(const __nv_bfloat16* lo,
                                             const __nv_bfloat16* hi) {
  const uint32_t l = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t h = *reinterpret_cast<const uint16_t*>(hi);
  return l | (h << 16);
}

template <int D>
__device__ __forceinline__ void load_tile_padded(__nv_bfloat16* dst,
                                                 const __nv_bfloat16* src,
                                                 int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      chunk = *reinterpret_cast<const uint4*>(src + r * D + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * Bf16Layout<D>::ld + c * 8) = chunk;
  }
}

__device__ __forceinline__ int tile_rows(int start, int len) {
  return min(kBlock, len - start);
}

// A key is masked past the chunk's end (local position klocal >= sk) and,
// if causal, when its global position lies after the query's.
__device__ __forceinline__ bool key_masked(int qpos, int klocal, int k_offset,
                                           int sk, int causal) {
  return klocal >= sk || (causal && qpos < k_offset + klocal);
}

// Positions: q_offset, k_offset are the global positions of q[:, 0] and
// k[:, 0]; `q_start` below is global, `k_local` a position in the chunk.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_chunk_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* m_in, const float* l_in,
                        const float* acc_in, float* m_out, float* l_out,
                        float* acc_out, int sq, int sk, int q_offset,
                        int k_offset, float scale, int causal) {
  using L = Bf16Layout<D>;
  constexpr int ld = L::ld;
  constexpr int kSteps = D / 16;
  constexpr int kOutBlocks = D / 8;
  constexpr int kScoreBlocks = kBlock / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + L::tile;
  __nv_bfloat16* vs = ks + L::tile;

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int q_local = q_tile * kBlock;
  const int q_start = q_offset + q_local;
  const size_t q_head = static_cast<size_t>(bh) * sq * D;
  const size_t k_head = static_cast<size_t>(bh) * sk * D;
  const size_t row_head = static_cast<size_t>(bh) * sq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q_local + warp * kWarpRows + g;  // local rows row0, +8
  const int row1 = row0 + 8;
  const int qpos0 = q_offset + row0;
  const int qpos1 = qpos0 + 8;
  const bool live0 = row0 < sq;
  const bool live1 = row1 < sq;

  // The carry, straight into this lane's fragment positions.
  float m0 = live0 ? m_in[row_head + row0] : kNegInf;
  float m1 = live1 ? m_in[row_head + row1] : kNegInf;
  float l0 = live0 ? l_in[row_head + row0] : 0.f;
  float l1 = live1 ? l_in[row_head + row1] : 0.f;
  float acc[kOutBlocks][4];
  {
    const float* a0 = acc_in + q_head + static_cast<size_t>(row0) * D + 2 * t;
    const float* a1 = a0 + 8 * D;
    #pragma unroll
    for (int nb = 0; nb < kOutBlocks; ++nb) {
      const float2 x0 = live0 ? *reinterpret_cast<const float2*>(a0 + nb * 8)
                              : make_float2(0.f, 0.f);
      const float2 x1 = live1 ? *reinterpret_cast<const float2*>(a1 + nb * 8)
                              : make_float2(0.f, 0.f);
      acc[nb][0] = x0.x;
      acc[nb][1] = x0.y;
      acc[nb][2] = x1.x;
      acc[nb][3] = x1.y;
    }
  }

  load_tile_padded<D>(qs, q + q_head + static_cast<size_t>(q_local) * D,
                      tile_rows(q_local, sq));
  __syncthreads();
  uint32_t qa[kSteps][4];
  #pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const __nv_bfloat16* base =
        qs + (warp * kWarpRows + g) * ld + kk * 16 + 2 * t;
    qa[kk][0] = load_u32(base);
    qa[kk][1] = load_u32(base + 8 * ld);
    qa[kk][2] = load_u32(base + 8);
    qa[kk][3] = load_u32(base + 8 * ld + 8);
  }

  const int num_tiles = (sk + kBlock - 1) / kBlock;
  for (int tile = 0; tile < num_tiles; ++tile) {
    const int k_local = tile * kBlock;
    // Every key of this tile (and of every later one) lies after every
    // query of the block: nothing to fold.
    if (causal && q_start + kBlock - 1 < k_offset + k_local) break;
    const int k_rows = tile_rows(k_local, sk);
    const bool masked_tile =
        (causal && k_offset + k_local + kBlock - 1 > q_start) ||
        k_rows < kBlock;
    __syncthreads();
    load_tile_padded<D>(ks, k + k_head + static_cast<size_t>(k_local) * D,
                        k_rows);
    load_tile_padded<D>(vs, v + k_head + static_cast<size_t>(k_local) * D,
                        k_rows);
    __syncthreads();

    float s[kScoreBlocks][4];
    #pragma unroll
    for (int nb = 0; nb < kScoreBlocks; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      const __nv_bfloat16* kr = ks + (nb * 8 + g) * ld + 2 * t;
      #pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        mma_bf16(s[nb], qa[kk], load_u32(kr + kk * 16),
                 load_u32(kr + kk * 16 + 8));
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
    #pragma unroll
    for (int nb = 0; nb < kScoreBlocks; ++nb) {
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = k_local + nb * 8 + 2 * t + (i & 1);
        const int qpos = i < 2 ? qpos0 : qpos1;
        float x = s[nb][i] * scale;
        if (masked_tile && key_masked(qpos, kl, k_offset, sk, causal)) {
          x = kNegInf;
        }
        s[nb][i] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
    #pragma unroll
    for (int nb = 0; nb < kScoreBlocks; ++nb) {
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = k_local + nb * 8 + 2 * t + (i & 1);
        const int qpos = i < 2 ? qpos0 : qpos1;
        float p = expf(s[nb][i] - (i < 2 ? mn0 : mn1));
        // Zeroed, not left to underflow: a row whose keys are all masked
        // while its m is still -1e30 has exp(0) = 1 here.
        if (masked_tile && key_masked(qpos, kl, k_offset, sk, causal)) {
          p = 0.f;
        }
        s[nb][i] = p;
      }
      sum0 += s[nb][0] + s[nb][1];
      sum1 += s[nb][2] + s[nb][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float alpha0 = expf(m0 - mn0);
    const float alpha1 = expf(m1 - mn1);
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
    #pragma unroll
    for (int nb = 0; nb < kOutBlocks; ++nb) {
      acc[nb][0] *= alpha0;
      acc[nb][1] *= alpha0;
      acc[nb][2] *= alpha1;
      acc[nb][3] *= alpha1;
    }

    #pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const __nv_bfloat16* vr = vs + (kk * 16 + 2 * t) * ld + g;
      #pragma unroll
      for (int nb = 0; nb < kOutBlocks; ++nb) {
        const __nv_bfloat16* col = vr + nb * 8;
        mma_bf16(acc[nb], pa, pack_raw(col, col + ld),
                 pack_raw(col + 8 * ld, col + 9 * ld));
      }
    }
  }

  // Flush the carry; rows past Sq (a ragged last q tile) are not stored.
  float* o0 = acc_out + q_head + static_cast<size_t>(row0) * D + 2 * t;
  float* o1 = o0 + 8 * D;
  if (live0) {
    #pragma unroll
    for (int nb = 0; nb < kOutBlocks; ++nb) {
      *reinterpret_cast<float2*>(o0 + nb * 8) =
          make_float2(acc[nb][0], acc[nb][1]);
    }
    if (t == 0) {
      m_out[row_head + row0] = m0;
      l_out[row_head + row0] = l0;
    }
  }
  if (live1) {
    #pragma unroll
    for (int nb = 0; nb < kOutBlocks; ++nb) {
      *reinterpret_cast<float2*>(o1 + nb * 8) =
          make_float2(acc[nb][2], acc[nb][3]);
    }
    if (t == 0) {
      m_out[row_head + row1] = m1;
      l_out[row_head + row1] = l1;
    }
  }
}

// ---- bf16, D 64 and 128: wgmma over a TMA K/V ring --------------------

constexpr int kConsumers = 2;  // consumer warpgroups, on alternate key tiles
constexpr int kSlots = 4;      // K/V ring slots, two a consumer warpgroup
constexpr int kThreadsW = (kConsumers + 1) * 128;  // + a producer warpgroup
constexpr int kTmaWarp = kConsumers * 4;  // the producer warp issuing TMA
constexpr int kProducerRegs = 24;   // setmaxnreg: the producer gives its
constexpr int kConsumerRegs = 240;  // registers to the consumers
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInfLog2 = kNegInf * kLog2e;

// The consumer warpgroups alone meet here (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers * 128) : "memory");
}

// The grid is (q tiles, BH). Blocks start in the order of their linear
// index, so it is read heads fastest from the last q tile down: under the
// causal mask the last q tile meets the most keys, and every head's
// heaviest tile starts before any head's next one.
__device__ __forceinline__ int heaviest_first_tile() {
  return gridDim.x - 1 -
         static_cast<int>((blockIdx.x + gridDim.x * blockIdx.y) / gridDim.y);
}

__device__ __forceinline__ int heads_fastest_head() {
  return (blockIdx.x + gridDim.x * blockIdx.y) % gridDim.y;
}

// Number of 64-key tiles a q tile folds: under the causal mask, the tiles
// left of the first one wholly after every query of the tile.
__device__ __forceinline__ int chunk_num_tiles(int q_first, int k_offset,
                                               int sk, int causal) {
  const int all = (sk + kBlock - 1) / kBlock;
  if (!causal) return all;
  const int last_q = q_first + kBlock - 1;  // global position
  if (last_q < k_offset) return 0;
  return min(all, (last_q - k_offset) / kBlock + 1);
}

// Shared memory, every tile 1024-byte aligned (the 128-byte swizzle's
// period), each a 64-row tile as D/64 column blocks of 64 rows x 128
// bytes: Q, then the ring's slots (K, then V), then the mbarriers. After
// the loop the ring carries consumer 1's state to consumer 0.
template <int D>
struct ChunkTmaLayout {
  static constexpr uint32_t block = kBlock * kSwizzleRow;
  static constexpr uint32_t tile = D / 64 * block;
  static constexpr uint32_t ring = tile;
  static constexpr uint32_t slot = 2 * tile;
  static constexpr uint32_t barriers = ring + kSlots * slot;
  static constexpr size_t bytes = barriers + 128 + 1024;  // + alignment
  static_assert((D / 2 + 4) * 128 * 4 <= kSlots * slot, "state fits the ring");
};

// A q tile that no key reaches: its carry rows, copied as they are.
template <int D>
__device__ __forceinline__ void copy_carry(const float* m_in,
                                           const float* l_in,
                                           const float* acc_in, float* m_out,
                                           float* l_out, float* acc_out,
                                           size_t rows_at, int rows) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    m_out[rows_at + i] = m_in[rows_at + i];
    l_out[rows_at + i] = l_in[rows_at + i];
  }
  const float4* from = reinterpret_cast<const float4*>(acc_in + rows_at * D);
  float4* to = reinterpret_cast<float4*>(acc_out + rows_at * D);
  for (int i = threadIdx.x; i < rows * D / 4; i += blockDim.x) to[i] = from[i];
}

// ptxas sizes the block by its launch bound (three warpgroups: 168
// registers a thread), which setmaxnreg then moves to the consumers.
template <int D>
__global__ void __launch_bounds__(3 * 128, 1)
flash_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* m_in, const float* l_in,
                         const float* acc_in, float* m_out, float* l_out,
                         float* acc_out, int sq, int sk, int q_offset,
                         int k_offset, float scale, int causal) {
  using L = ChunkTmaLayout<D>;
  constexpr int kColBlocks = D / 64;
  constexpr int kOut = D / 2;  // accumulator floats a thread (64 x D)
  const int q_tile = heaviest_first_tile();
  const int bh = heads_fastest_head();
  const int q_start = q_tile * kBlock;  // local position of the tile's row 0
  const size_t rows_at = static_cast<size_t>(bh) * sq + q_start;
  const int count = chunk_num_tiles(q_offset + q_start, k_offset, sk, causal);
  if (count <= 0) {  // no key reaches the tile: no TMA, the carry goes through
    copy_carry<D>(m_in, l_in, acc_in, m_out, l_out, acc_out, rows_at,
                  tile_rows(q_start, sq));
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* aligned = smem_raw + (base - raw);
  const uint32_t full_bar = base + L::barriers;      // [slot]
  const uint32_t empty_bar = full_bar + 8 * kSlots;  // [slot]
  const uint32_t q_bar = empty_bar + 8 * kSlots;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full_bar + 8 * s, 1);   // the TMA lane's arrive, with bytes
      mbar_init(empty_bar + 8 * s, 4);  // the consuming warpgroup's warps
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kTmaWarp) {  // the producer warpgroup: one lane issues TMA
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kTmaWarp && lane == 0) {
      mbar_expect_tx(q_bar, L::tile);
      for (int c = 0; c < kColBlocks; ++c) {
        tma_load(base + c * L::block, &tm_q, q_bar, c * 64, q_start, bh);
      }
      for (int i = 0; i < count; ++i) {
        const int s = i % kSlots;
        if (i >= kSlots) {  // the consumer released tile i - kSlots
          mbar_wait(empty_bar + 8 * s, (i / kSlots - 1) & 1);
        }
        const uint32_t at = base + L::ring + s * L::slot;
        mbar_expect_tx(full_bar + 8 * s, 2 * L::tile);
        for (int c = 0; c < kColBlocks; ++c) {
          tma_load(at + c * L::block, &tm_k, full_bar + 8 * s, c * 64,
                   i * kBlock, bh);
          tma_load(at + L::tile + c * L::block, &tm_v, full_bar + 8 * s,
                   c * 64, i * kBlock, bh);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg takes key tiles wg, wg + 2, ...; in each,
  // warp w holds q rows 16 (w % 4) ... 16 (w % 4) + 15, this lane rows
  // row0 and row0 + 8 ("0" and "1" below).
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group: column pair
  const int row0 = (warp & 3) * 16 + g;
  const int gq0 = q_offset + q_start + row0;  // global positions
  const int gq1 = gq0 + 8;
  const bool in0 = q_start + row0 < sq;
  const bool in1 = q_start + row0 + 8 < sq;
  const float scale_log2 = scale * kLog2e;

  // Consumer 0 starts from the carry (m in log2 units), consumer 1 from
  // the empty state. acc[4 j + e] is row e < 2 ? row0 : row0 + 8, column
  // 8 j + 2 t + (e & 1).
  float carry_m0 = kNegInf, carry_m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[kOut];
  const size_t at0 = (rows_at + row0) * D + 2 * t;
  const size_t at1 = at0 + 8 * D;
  if (wg == 0) {
    if (in0) {
      carry_m0 = m_in[rows_at + row0];
      l0 = l_in[rows_at + row0];
    }
    if (in1) {
      carry_m1 = m_in[rows_at + row0 + 8];
      l1 = l_in[rows_at + row0 + 8];
    }
    #pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 x0 = in0 ? *reinterpret_cast<const float2*>(
                                  acc_in + at0 + 8 * j)
                            : make_float2(0.f, 0.f);
      const float2 x1 = in1 ? *reinterpret_cast<const float2*>(
                                  acc_in + at1 + 8 * j)
                            : make_float2(0.f, 0.f);
      acc[4 * j] = x0.x;
      acc[4 * j + 1] = x0.y;
      acc[4 * j + 2] = x1.x;
      acc[4 * j + 3] = x1.y;
    }
  } else {
    #pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  }
  float m0 = carry_m0 * kLog2e, m1 = carry_m1 * kLog2e;
  if (wg < count) mbar_wait(q_bar, 0);  // no tile: wait on nothing

  for (int i = wg; i < count; i += kConsumers) {
    const int slot = i % kSlots;
    mbar_wait(full_bar + 8 * slot, (i / kSlots) & 1);
    const uint32_t k_tile = base + L::ring + slot * L::slot;
    const uint32_t v_tile = k_tile + L::tile;
    const int k_start = i * kBlock;
    // Only tiles that cross the diagonal or end ragged hold masked keys.
    const bool edge =
        (causal && k_offset + k_start + kBlock - 1 > q_offset + q_start) ||
        k_start + kBlock > sk;

    // S = Q K^T: 64 rows x 64 keys, 16 columns of D a step. Inside a
    // 128-byte swizzled row a step moves the start by 32 bytes; past 64
    // columns it moves to the next column block.
    float s[32];
    wgmma_fence();
    #pragma unroll
    for (int kstep = 0; kstep < D / 16; ++kstep) {
      const uint32_t step = (kstep / 4) * L::block + (kstep % 4) * 32;
      wgmma_ss(s, gmma_desc(base + step, 16), gmma_desc(k_tile + step, 16),
               kstep > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(s);

    // Scale into log2 units, mask (a select: a key past Sk, whose zero-
    // filled row scores 0, or after the query), and the running max and
    // sum of rows row0 and row0 + 8; s[4 j + e] is key 8 j + 2 t + (e & 1).
    uint32_t dead = 0;  // this lane's masked scores, bit 4 j + e
    float mx0 = kNegInfLog2, mx1 = kNegInfLog2;
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (edge) {
          const int kl = k_start + 8 * j + 2 * t + (e & 1);
          if (kl >= sk || (causal && (e < 2 ? gq0 : gq1) < k_offset + kl)) {
            x = kNegInfLog2;
            dead |= 1u << (4 * j + e);
          }
        }
        s[4 * j + e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2_ftz(s[4 * j + e] - (e < 2 ? mn0 : mn1));
        // Zeroed, not left to underflow: a row whose keys are all masked
        // while its m is still -1e30 has 2^0 = 1 here.
        if ((dead >> (4 * j + e)) & 1u) p = 0.f;
        s[4 * j + e] = p;
      }
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float alpha0 = ex2_ftz(m0 - mn0);
    const float alpha1 = ex2_ftz(m1 - mn1);
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
    #pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }

    // acc += P V, 16 keys a step: p packed to bf16 (v's dtype) in the
    // register-A layout; V's 16 key rows start 16 x 128 bytes further each
    // step, read MN-major (the transpose bit); its column blocks lie one
    // block apart.
    uint32_t pa[4][4];
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      #pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      }
    }
    hold(acc);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(acc, pa[kk], gmma_desc(v_tile + kk * 16 * kSwizzleRow,
                                      L::block));
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(acc);
    hold(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * slot);  // slot free
  }

  if constexpr (kConsumers > 1) {
    // Consumer 1's state meets consumer 0's through the idle ring: thread
    // i of each holds the same rows and columns.
    float* other = reinterpret_cast<float*>(aligned + L::ring);
    const int tid = threadIdx.x & 127;
    consumers_sync();  // every product and every tile of both has landed
    if (wg == 1) {
      #pragma unroll
      for (int j = 0; j < kOut; ++j) other[j * 128 + tid] = acc[j];
      other[kOut * 128 + tid] = m0;
      other[(kOut + 1) * 128 + tid] = m1;
      other[(kOut + 2) * 128 + tid] = l0;
      other[(kOut + 3) * 128 + tid] = l1;
    }
    consumers_sync();
    if (wg == 1) return;
    const float om0 = other[kOut * 128 + tid];
    const float om1 = other[(kOut + 1) * 128 + tid];
    const float mm0 = fmaxf(m0, om0);
    const float mm1 = fmaxf(m1, om1);
    const float a0 = ex2_ftz(m0 - mm0), b0 = ex2_ftz(om0 - mm0);
    const float a1 = ex2_ftz(m1 - mm1), b1 = ex2_ftz(om1 - mm1);
    l0 = l0 * a0 + other[(kOut + 2) * 128 + tid] * b0;
    l1 = l1 * a1 + other[(kOut + 3) * 128 + tid] * b1;
    #pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const bool hi = (i & 3) >= 2;  // row0 + 8
      acc[i] = acc[i] * (hi ? a1 : a0) + other[i * 128 + tid] * (hi ? b1 : b0);
    }
    m0 = mm0;
    m1 = mm1;
  }

  // The carry out; m back in natural units, the carry's own where the
  // maximum never rose above it. Rows past Sq are not stored.
  if (in0) {
    #pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(acc_out + at0 + 8 * j) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    }
    if (t == 0) {
      m_out[rows_at + row0] = m0 == carry_m0 * kLog2e ? carry_m0 : m0 * kLn2;
      l_out[rows_at + row0] = l0;
    }
  }
  if (in1) {
    #pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(acc_out + at1 + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (t == 0) {
      m_out[rows_at + row0 + 8] =
          m1 == carry_m1 * kLog2e ? carry_m1 : m1 * kLn2;
      l_out[rows_at + row0 + 8] = l1;
    }
  }
}

// ---- f32: scalar FMAs over shared memory -----------------------------

template <int D>
struct F32Layout {
  static constexpr size_t q = 0;                                   // [64][D]
  static constexpr size_t k = q + kBlock * D * sizeof(float);      // [64][D]
  static constexpr size_t v = k + kBlock * D * sizeof(float);      // [64][D]
  static constexpr size_t s = v + kBlock * D * sizeof(float);      // [64][64]
  static constexpr size_t o = s + kBlock * kBlock * sizeof(float);  // [64][D]
  static constexpr size_t bytes = o + kBlock * D * sizeof(float);
};

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int rows) {
  constexpr int kVecs = kBlock * D / 4;
  const int valid = rows * D / 4;
  const float4* from = reinterpret_cast<const float4*>(src);
  float4* to = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < kVecs; i += kThreads) {
    to[i] = i < valid ? from[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_chunk_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, const float* m_in,
                       const float* l_in, const float* acc_in, float* m_out,
                       float* l_out, float* acc_out, int sq, int sk,
                       int q_offset, int k_offset, float scale, int causal) {
  using L = F32Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q);
  float* ks = reinterpret_cast<float*>(smem + L::k);
  float* vs = reinterpret_cast<float*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* os = reinterpret_cast<float*>(smem + L::o);

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q_local = q_tile * kBlock;
  const int q_start = q_offset + q_local;
  const size_t q_head = static_cast<size_t>(bh) * sq * D;
  const size_t k_head = static_cast<size_t>(bh) * sk * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Two lanes own each query row; each takes half its columns.
  const int row = warp * kWarpRows + (lane >> 1);
  const int half = lane & 1;
  const int r = q_local + row;             // local row
  const int qpos = q_offset + r;
  const bool live = r < sq;
  const size_t carry = static_cast<size_t>(bh) * sq + r;

  load_tile_f32<D>(qs, q + q_head + static_cast<size_t>(q_local) * D,
                   tile_rows(q_local, sq));
  float* orow = os + row * D + half * (D / 2);
  const float* arow = acc_in + q_head + static_cast<size_t>(r) * D +
                      half * (D / 2);
  for (int c = 0; c < D / 2; ++c) orow[c] = live ? arow[c] : 0.f;
  float m = live ? m_in[carry] : kNegInf;
  float l = live ? l_in[carry] : 0.f;
  const float* qr = qs + row * D;
  float* srow = ss + row * kBlock;
  const int c0 = half * (kBlock / 2);

  const int num_tiles = (sk + kBlock - 1) / kBlock;
  for (int tile = 0; tile < num_tiles; ++tile) {
    const int k_local = tile * kBlock;
    if (causal && q_start + kBlock - 1 < k_offset + k_local) break;
    const int k_rows = tile_rows(k_local, sk);
    __syncthreads();
    load_tile_f32<D>(ks, k + k_head + static_cast<size_t>(k_local) * D,
                     k_rows);
    load_tile_f32<D>(vs, v + k_head + static_cast<size_t>(k_local) * D,
                     k_rows);
    __syncthreads();

    float tile_max = kNegInf;
    for (int j = c0; j < c0 + kBlock / 2; ++j) {
      const float* kr = ks + j * D;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float x = dot * scale;
      if (key_masked(qpos, k_local + j, k_offset, sk, causal)) x = kNegInf;
      srow[j] = x;
      tile_max = fmaxf(tile_max, x);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);
    float psum = 0.f;
    for (int j = c0; j < c0 + kBlock / 2; ++j) {
      float p = expf(srow[j] - m_new);
      if (key_masked(qpos, k_local + j, k_offset, sk, causal)) p = 0.f;
      srow[j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the partner lane's half of srow is written
    for (int c = 0; c < D / 2; ++c) {
      float a = orow[c] * alpha;
      for (int j = 0; j < kBlock; ++j) {
        a = fmaf(srow[j], vs[j * D + half * (D / 2) + c], a);
      }
      orow[c] = a;
    }
    __syncwarp();
  }

  if (!live) return;  // a ragged last q tile's padding rows
  float* out = acc_out + q_head + static_cast<size_t>(r) * D + half * (D / 2);
  for (int c = 0; c < D / 2; ++c) out[c] = orow[c];
  if (half == 0) {
    m_out[carry] = m;
    l_out[carry] = l;
  }
}

// ---- launch ------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
  int bh, sq, sk, q_offset, k_offset;
  float scale;
  int causal;
};

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem_bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

template <int D>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = Bf16Layout<D>::bytes;
  cudaError_t err = configure(flash_chunk_bf16_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBlock - 1) / kBlock, a.bh);
  flash_chunk_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.m_in, a.l_in, a.acc_in,
      a.m_out, a.l_out, a.acc_out, a.sq, a.sk, a.q_offset, a.k_offset,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = F32Layout<D>::bytes;
  cudaError_t err = configure(flash_chunk_f32_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBlock - 1) / kBlock, a.bh);
  flash_chunk_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.m_in, a.l_in, a.acc_in, a.m_out,
      a.l_out, a.acc_out, a.sq, a.sk, a.q_offset, a.k_offset, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = ChunkTmaLayout<D>::bytes;
  cudaError_t err =
      configure(flash_chunk_wgmma_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return err;
  EncodeTiled encode = nullptr;
  err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[3];
  const void* data[3] = {a.q, a.k, a.v};
  const int rows[3] = {a.sq, a.sk, a.sk};
  for (int i = 0; i < 3; ++i) {
    err = make_map(encode, &maps[i], data[i], a.bh, rows[i], D, kBlock);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.sq + kBlock - 1) / kBlock, a.bh);
  flash_chunk_wgmma_kernel<D><<<grid, kThreadsW, smem, stream>>>(
      maps[0], maps[1], maps[2], a.m_in, a.l_in, a.acc_in, a.m_out, a.l_out,
      a.acc_out, a.sq, a.sk, a.q_offset, a.k_offset, a.scale, a.causal);
  return cudaGetLastError();
}

// bf16 head dims 64 and 128 take the wgmma kernel, 16 and 32 the
// mma.sync one; f32 the scalar kernel.
template <int D>
cudaError_t launch(const Args& a, int dtype, cudaStream_t stream) {
  if (dtype != 1) return launch_f32<D>(a, stream);
  if constexpr (D >= 64) {
    return launch_wgmma<D>(a, stream);
  } else {
    return launch_bf16<D>(a, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 16, 32, 64 or 128; any
// sq, sk >= 1; the *_out buffers may alias the *_in ones. Returns a
// cudaError_t (0 = success).
extern "C" int edl_flash_chunk_update(
    const void* q, const void* k, const void* v, const void* m_in,
    const void* l_in, const void* acc_in, void* m_out, void* l_out,
    void* acc_out, int bh, int sq, int sk, int head_dim, int dtype,
    int q_offset, int k_offset, float scale, int causal, void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0) {
    return cudaErrorInvalidValue;
  }
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const Args a{q, k, v,
               static_cast<const float*>(m_in),
               static_cast<const float*>(l_in),
               static_cast<const float*>(acc_in),
               static_cast<float*>(m_out), static_cast<float*>(l_out),
               static_cast<float*>(acc_out), bh, sq, sk, q_offset, k_offset,
               scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(a, dtype, s);
    case 32: return launch<32>(a, dtype, s);
    case 64: return launch<64>(a, dtype, s);
    case 128: return launch<128>(a, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
