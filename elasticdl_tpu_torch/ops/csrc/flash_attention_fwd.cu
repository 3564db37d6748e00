// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel elasticdl_tpu/ops/flash_attention.py
// `_flash_forward` -> `_fwd_kernel` / `_scratch_tile_update`: causal or
// full attention over (BH, S, D) with the online-softmax recurrence,
// returning o (BH, S, D) in the input dtype and lse = m + log(l) (BH, S)
// in f32.
//
// What bounds it on the H100: at the serving shape (BH 32, S 1024,
// D 128, causal, bf16) it must move q, k, v, o (8.4 MB each) and lse,
// 33.7 MB, i.e. ~10 us at 3.35 TB/s, against ~8.7 us for the 8.6 useful
// GFLOP at 989 TFLOP/s: memory bound, with little room to spare. The
// score matrix (BH x S x S f32, 134 MB here) is what must never reach
// device memory. The TPU grid's sequential "arbitrary" k axis becomes a
// loop over K/V tiles inside one thread block, heaviest causal q tiles
// first; K/V tiles wholly above the causal diagonal are never loaded.
// The score tile, the probabilities and the output accumulator never
// leave registers.
//
// bf16 takes one of two kernels, chosen statically by head dim:
//
// - D 64 and 128 (the flagship's heads): `flash_fwd_wgmma_kernel`. A
//   block takes 128 query rows: two consumer warpgroups of 64 rows and a
//   producer warp. The producer loads Q once, then each 128-key K/V tile,
//   with TMA into a two-slot ring, signalled by full and empty
//   mbarriers, so tile t+1's copy runs while tile t's products do. Each
//   warpgroup computes S = Q K^T with wgmma m64n128k16 from shared memory
//   (both operands K-major, in the 128-byte swizzle TMA writes), takes
//   the online softmax on S's accumulator, packs p to bf16 in place (the
//   accumulator's layout is the next wgmma's register-A layout) and adds
//   P V with wgmma reading V from shared memory as an MN-major operand.
//   (Running tile t's softmax under tile t-1's P V, with a producer
//   warpgroup and setmaxnreg to hold both, measured no faster on an
//   H100; nor did one persistent block an SM over (q tile, head) items
//   with Q double-buffered.) Blocks start heads fastest, heaviest causal
//   q tiles first. The tensor maps are 3-D (D, S, BH): the rows of a
//   ragged tile past S are zeros, not the next head's rows, and keys
//   past S are masked all the same. 160 KB of shared memory at D 128 and
//   288 threads: one block an SM.
// - D 16 and 32: `flash_fwd_bf16_kernel`, mma.sync m16n8k16. A block
//   takes 64 query rows with 4 warps of 16; K/V tiles of 64 keys flow
//   through a two-stage cp.async ring (16-byte copies; rows past S read
//   no bytes and are zero-filled), Q waits in the second stage until its
//   fragments are in registers, and fragments come from ldmatrix (x4,
//   .trans for V) over rows padded by 16 bytes, free of bank conflicts.
//   12 KB (D 16) or 20 KB (D 32) of shared memory and, from ptxas, 91 or
//   104 registers (the launch bounds' cap of 168 does not bind): the
//   register file holds five or four blocks an SM. 4 warps ran faster
//   than 8 (128 q rows a block) at D 16 and 32 on an H100, most at the
//   zoo twin's short sequences (tools/flash_fwd_ab.py, PERF.md).
//
// Any sequence length: keys past the end are masked like keys above the
// diagonal (only the diagonal and a ragged tile pay for the mask), and q
// rows past the end are not stored.
//
// f32 inputs (kept for the numeric check) take a scalar kernel: scores,
// probabilities and accumulator in shared memory, two lanes per row.
//
// Numerics follow the TPU kernel: s = (q.k) * scale in f32 after the
// product, masked keys (kpos > qpos if causal, kpos >= S) set to -1e30
// (not -inf), p = exp(s - m) zeroed where masked and cast to v's dtype
// before the PV product, o = acc / max(l, 1e-30), lse = m + log(l) (the
// wgmma kernel keeps s and m in log2 units and takes 2^(s - m)). p is
// rounded against each tile's running max, so the bf16 results follow
// the key-tile width (128 for the wgmma kernel, 64 otherwise).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "hopper.cuh"  // cp.async, ldmatrix, mbarriers, TMA, wgmma

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A bf16 grid is (q tiles, BH). Blocks start in the order of their
// linear index, so the index is read heads fastest: every head's
// heaviest causal q tile starts before any head's next one, and the
// light tiles fill the last wave (x fastest left the later heads'
// heavy tiles for last).
__device__ __forceinline__ int heaviest_first_tile() {
  const int id = blockIdx.x + gridDim.x * blockIdx.y;
  return gridDim.x - 1 - id / gridDim.y;
}

__device__ __forceinline__ int heaviest_first_head() {
  return (blockIdx.x + gridDim.x * blockIdx.y) % gridDim.y;
}

// ---- bf16 ring kernel: mma.sync over a cp.async K/V ring ---------------

constexpr int kKeysA = 64;    // keys a K/V tile
constexpr int kStagesA = 2;   // ring stages
constexpr int kWarpsA = 4;    // warps a block, 16 q rows each
constexpr int kThreadsA = kWarpsA * 32;

// Shared-memory rows in bf16 elements, padded by 16 bytes: the 8 rows an
// ldmatrix reads fall on distinct banks.
template <int D>
struct RingLayout {
  static constexpr int ld = D + 8;
  static constexpr int tile = kKeysA * ld;  // one K or V tile, elements
  static constexpr size_t bytes = kStagesA * 2 * tile * sizeof(bf16);
};


// Starts the copy of `rows` rows of a contiguous (.., D) global tile into
// padded shared rows; rows at or past `valid` are zero-filled (the copy
// reads no bytes for them).
template <int D, int kThreads>
__device__ __forceinline__ void copy_tile_async(bf16* dst, const bf16* src,
                                                int rows, int valid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int bytes = r < valid ? 16 : 0;
    cp_async_16(dst + r * RingLayout<D>::ld + c * 8,
                src + (bytes ? r : 0) * D + c * 8, bytes);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsA, 3)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int seq_len, float scale,
                      int causal) {
  using L = RingLayout<D>;
  constexpr int ld = L::ld;
  constexpr int kThreads = kThreadsA;
  constexpr int kRows = kWarpsA * 16;  // q rows a block
  constexpr int kSteps = D / 16;      // k-steps of QK^T
  constexpr int kOutBlocks = D / 8;   // n-blocks of PV
  constexpr int kScoreBlocks = kKeysA / 8;
  static_assert(kRows * ld <= 2 * L::tile, "Q waits in one ring stage");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // stage s: K, then V
  bf16* qs = ring + 2 * L::tile;               // Q waits in stage 1

  const int q_tile = heaviest_first_tile();
  const int bh = heaviest_first_head();
  const int q_start = q_tile * kRows;
  const size_t head = static_cast<size_t>(bh) * seq_len * D;
  const bf16* k_head = k + head;
  const bf16* v_head = v + head;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // fragment row group
  const int t = lane & 3;     // thread in group: column pair
  const int row0 = warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const int qpos0 = q_start + row0;
  const int qpos1 = qpos0 + 8;
  const int all_tiles = (seq_len + kKeysA - 1) / kKeysA;
  const int num_tiles =
      causal ? min(all_tiles, (q_start + kRows + kKeysA - 1) / kKeysA)
             : all_tiles;

  // Q and K/V tile 0 in flight together; once Q's fragments are in
  // registers, stage 1 is free for tile 1.
  copy_tile_async<D, kThreads>(
      qs, q + head + static_cast<size_t>(q_start) * D, kRows,
      seq_len - q_start);
  cp_async_commit();
  copy_tile_async<D, kThreads>(ring, k_head, kKeysA, seq_len);
  copy_tile_async<D, kThreads>(ring + L::tile, v_head, kKeysA, seq_len);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[kSteps][4];
  #pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * ld + kk * 16 +
                            (lane >> 4) * 8);
  }
  __syncthreads();

  float acc[kOutBlocks][4];
  #pragma unroll
  for (int nb = 0; nb < kOutBlocks; ++nb) {
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int tile = 0; tile < num_tiles; ++tile) {
    const int k_start = tile * kKeysA;
    if (tile + 1 < num_tiles) {  // tile + 1's copy runs under this tile
      bf16* next = ring + ((tile + 1) % kStagesA) * 2 * L::tile;
      const int next_start = k_start + kKeysA;
      const size_t from = static_cast<size_t>(next_start) * D;
      copy_tile_async<D, kThreads>(next, k_head + from, kKeysA,
                                   seq_len - next_start);
      copy_tile_async<D, kThreads>(next + L::tile, v_head + from, kKeysA,
                                   seq_len - next_start);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const int ring_stage = tile % kStagesA;
    const bf16* ks = ring + ring_stage * 2 * L::tile;
    const bf16* vs = ks + L::tile;
    // Only the diagonal tiles and a ragged last tile hold masked keys.
    const bool edge = (causal && k_start + kKeysA > q_start) ||
                      k_start + kKeysA > seq_len;

    // S = Q K^T for this warp's 16 rows x 64 keys, f32. One ldmatrix.x4
    // gives the B fragments of two 8-key blocks.
    float s[kScoreBlocks][4];
    #pragma unroll
    for (int nb = 0; nb < kScoreBlocks; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    }
    #pragma unroll
    for (int nb = 0; nb < kScoreBlocks; nb += 2) {
      const bf16* kr =
          ks + (nb * 8 + (lane & 7) + (lane >> 4) * 8) * ld +
          ((lane >> 3) & 1) * 8;
      #pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, kr + kk * 16);
        mma_bf16(s[nb], qa[kk], b[0], b[1]);
        mma_bf16(s[nb + 1], qa[kk], b[2], b[3]);
      }
    }

    // Scale, mask, and the running max / sum of rows row0 and row0 + 8.
    uint32_t drop = 0;  // this lane's masked scores, bit 4 nb + i
    float mx0 = kNegInf, mx1 = kNegInf;
    #pragma unroll
    for (int nb = 0; nb < kScoreBlocks; ++nb) {
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nb][i] * scale;
        if (edge) {
          const int kpos = k_start + nb * 8 + 2 * t + (i & 1);
          const int qpos = i < 2 ? qpos0 : qpos1;
          if (kpos >= seq_len || (causal && kpos > qpos)) {
            x = kNegInf;
            drop |= 1u << (nb * 4 + i);
          }
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
        float p = exp2f((s[nb][i] - (i < 2 ? mn0 : mn1)) * kLog2e);
        if ((drop >> (nb * 4 + i)) & 1u) p = 0.f;
        s[nb][i] = p;
      }
      sum0 += s[nb][0] + s[nb][1];
      sum1 += s[nb][2] + s[nb][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float alpha0 = exp2f((m0 - mn0) * kLog2e);
    const float alpha1 = exp2f((m1 - mn1) * kLog2e);
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

    // acc += P V: P's A fragments are S's accumulators, packed to bf16;
    // one ldmatrix.x4.trans gives V's B fragments of two 8-column blocks.
    #pragma unroll
    for (int kk = 0; kk < kKeysA / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const bf16* vr = vs + (kk * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
      #pragma unroll
      for (int nb = 0; nb < kOutBlocks; nb += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vr + nb * 8);
        mma_bf16(acc[nb], pa, b[0], b[1]);
        mma_bf16(acc[nb + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage: refill it
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  // Rows past the sequence's end (a ragged last q tile) are not stored.
  bf16* out0 = o + head + static_cast<size_t>(qpos0) * D + 2 * t;
  bf16* out1 = out0 + 8 * D;
  float* lrow = lse + static_cast<size_t>(bh) * seq_len;
  if (qpos0 < seq_len) {
    #pragma unroll
    for (int nb = 0; nb < kOutBlocks; ++nb) {
      *reinterpret_cast<uint32_t*>(out0 + nb * 8) =
          pack_bf16(acc[nb][0] * inv0, acc[nb][1] * inv0);
    }
    if (t == 0) lrow[qpos0] = m0 + logf(fmaxf(l0, 1e-30f));
  }
  if (qpos1 < seq_len) {
    #pragma unroll
    for (int nb = 0; nb < kOutBlocks; ++nb) {
      *reinterpret_cast<uint32_t*>(out1 + nb * 8) =
          pack_bf16(acc[nb][2] * inv1, acc[nb][3] * inv1);
    }
    if (t == 0) lrow[qpos1] = m1 + logf(fmaxf(l1, 1e-30f));
  }
}

// ---- bf16 wgmma kernel: a TMA ring with mbarriers (D 64 and 128) -------

constexpr int kRowsB = 128;   // q rows a block: two consumer warpgroups
constexpr int kKeysB = 128;   // keys a K/V tile
constexpr int kSlotsB = 2;    // K/V ring slots
constexpr int kConsumerWarps = 8;
constexpr int kThreadsB = kConsumerWarps * 32 + 32;  // + the producer warp

// Shared memory, every tile 1024-byte aligned (the 128-byte swizzle's
// period): Q as D/64 column blocks of 128 rows x 128 bytes, then the
// ring's slots (K, then V, each as column blocks of 128 keys), then the
// mbarriers.
template <int D>
struct TmaLayout {
  static constexpr uint32_t q_block = kRowsB * kSwizzleRow;
  static constexpr uint32_t kv_block = kKeysB * kSwizzleRow;
  static constexpr uint32_t q_bytes = kRowsB * D * 2;
  static constexpr uint32_t kv_bytes = kKeysB * D * 2;  // one K or V tile
  static constexpr uint32_t ring = q_bytes;
  static constexpr uint32_t barriers = ring + kSlotsB * 2 * kv_bytes;
  static constexpr size_t bytes = barriers + 64 + 1024;  // + alignment
};


template <int D>
__global__ void __launch_bounds__(kThreadsB, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       bf16* __restrict__ o, float* __restrict__ lse,
                       int seq_len, float scale, int causal) {
  using L = TmaLayout<D>;
  constexpr int kColBlocks = D / 64;
  constexpr int kOut = D / 2;  // accumulator floats a thread (64 x D)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full_bar = base + L::barriers;       // [slot]
  const uint32_t empty_bar = full_bar + 8 * kSlotsB;  // [slot]
  const uint32_t q_bar = empty_bar + 8 * kSlotsB;

  const int q_tile = heaviest_first_tile();
  const int bh = heaviest_first_head();
  const int q_start = q_tile * kRowsB;
  const int all_tiles = (seq_len + kKeysB - 1) / kKeysB;
  const int num_tiles =
      causal ? min(all_tiles, (q_start + kRowsB + kKeysB - 1) / kKeysB)
             : all_tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlotsB; ++i) {
      mbar_init(full_bar + 8 * i, 1);  // the producer's arrive + bytes
      mbar_init(empty_bar + 8 * i, kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: one lane issues TMA
    if (lane == 0) {
      mbar_expect_tx(q_bar, L::q_bytes);
      for (int c = 0; c < kColBlocks; ++c) {
        tma_load(base + c * L::q_block, &tm_q, q_bar, c * 64, q_start, bh);
      }
      for (int tile = 0; tile < num_tiles; ++tile) {
        const int s = tile % kSlotsB;
        if (tile >= kSlotsB) {  // the consumers released tile - kSlotsB
          mbar_wait(empty_bar + 8 * s, (tile / kSlotsB - 1) & 1);
        }
        const uint32_t kt = base + L::ring + s * 2 * L::kv_bytes;
        mbar_expect_tx(full_bar + 8 * s, 2 * L::kv_bytes);
        for (int c = 0; c < kColBlocks; ++c) {
          tma_load(kt + c * L::kv_block, &tm_k, full_bar + 8 * s, c * 64,
                   tile * kKeysB, bh);
          tma_load(kt + L::kv_bytes + c * L::kv_block, &tm_v,
                   full_bar + 8 * s, c * 64, tile * kKeysB, bh);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg takes q rows wg * 64 ... wg * 64 + 63.
  const int wg = warp >> 2;
  const int g = lane >> 2;    // fragment row group
  const int t = lane & 3;     // thread in group: column pair
  const int row0 = wg * 64 + (warp & 3) * 16 + g;  // rows row0, row0 + 8
  const int qpos0 = q_start + row0;
  const int qpos1 = qpos0 + 8;
  const uint32_t q_wg = base + wg * 64 * kSwizzleRow;

  float acc[kOut];
  #pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  // Scores are kept in log2 units, s * scale * log2(e), so p = 2^(s - m)
  // takes one subtraction; the mask value and the running max's start
  // are -1e30 in natural units, and lse goes back through ln(2).
  constexpr float kNegInfLog2 = kNegInf * kLog2e;
  const float scale_log2 = scale * kLog2e;
  float m0 = kNegInfLog2, m1 = kNegInfLog2, l0 = 0.f, l1 = 0.f;
  mbar_wait(q_bar, 0);

  for (int tile = 0; tile < num_tiles; ++tile) {
    const int slot = tile % kSlotsB;
    mbar_wait(full_bar + 8 * slot, (tile / kSlotsB) & 1);
    const uint32_t k_tile = base + L::ring + slot * 2 * L::kv_bytes;
    const uint32_t v_tile = k_tile + L::kv_bytes;
    const int k_start = tile * kKeysB;
    // Only the diagonal tile and a ragged last tile hold masked keys.
    const bool edge = (causal && k_start + kKeysB > q_start + wg * 64) ||
                      k_start + kKeysB > seq_len;

    // S = Q K^T: 64 rows x 128 keys, 16 columns of D a step. Inside a
    // 128-byte swizzled row a step moves the start by 32 bytes; past 64
    // columns it moves to the next column block.
    float s[kKeysB / 2];
    wgmma_fence();
    #pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t step = (ks % 4) * 32;
      wgmma_ss(s, gmma_desc(q_wg + (ks / 4) * L::q_block + step, 16),
               gmma_desc(k_tile + (ks / 4) * L::kv_block + step, 16),
               ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(s);

    // Scale, mask, and the running max / sum of rows row0 and row0 + 8;
    // s[4 j + i] is row i < 2 ? row0 : row0 + 8, key 8 j + 2 t + (i & 1).
    uint64_t dead = 0;  // this lane's masked scores, bit 4 j + i
    float mx0 = kNegInfLog2, mx1 = kNegInfLog2;
    #pragma unroll
    for (int j = 0; j < kKeysB / 8; ++j) {
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[4 * j + i] * scale_log2;
        if (edge) {
          const int kpos = k_start + 8 * j + 2 * t + (i & 1);
          const int qpos = i < 2 ? qpos0 : qpos1;
          if (kpos >= seq_len || (causal && kpos > qpos)) {
            x = kNegInfLog2;
            dead |= 1ull << (4 * j + i);
          }
        }
        s[4 * j + i] = x;
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
    for (int j = 0; j < kKeysB / 8; ++j) {
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = ex2_ftz(s[4 * j + i] - (i < 2 ? mn0 : mn1));
        if ((dead >> (4 * j + i)) & 1u) p = 0.f;
        s[4 * j + i] = p;
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
      acc[4 * j + 0] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }

    // acc += P V, 16 keys a step: p packed to bf16 in the register-A
    // layout; V's 16 key rows start 16 x 128 bytes further each step.
    uint32_t pa[kKeysB / 16][4];
    #pragma unroll
    for (int kk = 0; kk < kKeysB / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    hold(acc);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < kKeysB / 16; ++kk) {
      wgmma_rs(acc, pa[kk],
               gmma_desc(v_tile + kk * 16 * kSwizzleRow, L::kv_block));
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(acc);
    hold(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * slot);  // slot free
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  // Rows past the sequence's end (a ragged last q tile) are not stored.
  const size_t head = static_cast<size_t>(bh) * seq_len * D;
  bf16* out0 = o + head + static_cast<size_t>(qpos0) * D + 2 * t;
  bf16* out1 = out0 + 8 * D;
  float* lrow = lse + static_cast<size_t>(bh) * seq_len;
  if (qpos0 < seq_len) {
    #pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out0 + 8 * j) =
          pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    }
    if (t == 0) lrow[qpos0] = m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
  }
  if (qpos1 < seq_len) {
    #pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out1 + 8 * j) =
          pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
    if (t == 0) lrow[qpos1] = m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
  }
}

// ---- f32: scalar FMAs over shared memory -----------------------------

constexpr int kBlock = 64;              // q rows per block, k rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = kBlock / kWarps;  // 16

// Rows of the tile starting at `start` that lie inside the sequence.
__device__ __forceinline__ int tile_rows(int start, int seq_len) {
  return min(kBlock, seq_len - start);
}

// A key is masked above the causal diagonal and past the sequence's end
// (the zero rows of a ragged last K/V tile).
__device__ __forceinline__ bool key_masked(int qpos, int kpos, int seq_len,
                                           int causal) {
  return kpos >= seq_len || (causal && qpos < kpos);
}

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
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int seq_len, float scale,
                     int causal) {
  using L = F32Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q);
  float* ks = reinterpret_cast<float*>(smem + L::k);
  float* vs = reinterpret_cast<float*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* os = reinterpret_cast<float*>(smem + L::o);

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q_start = q_tile * kBlock;
  const size_t head = static_cast<size_t>(bh) * seq_len * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Two lanes own each query row; each takes half its columns.
  const int row = warp * kWarpRows + (lane >> 1);
  const int half = lane & 1;
  const int qpos = q_start + row;

  load_tile_f32<D>(qs, q + head + static_cast<size_t>(q_start) * D,
                   tile_rows(q_start, seq_len));
  float* orow = os + row * D + half * (D / 2);
  for (int c = 0; c < D / 2; ++c) orow[c] = 0.f;
  float m = kNegInf;
  float l = 0.f;
  const float* qr = qs + row * D;
  float* srow = ss + row * kBlock;
  const int c0 = half * (kBlock / 2);

  const int num_tiles = causal ? q_tile + 1 : gridDim.x;
  for (int tile = 0; tile < num_tiles; ++tile) {
    const int k_start = tile * kBlock;
    const int k_rows = tile_rows(k_start, seq_len);
    __syncthreads();
    load_tile_f32<D>(ks, k + head + static_cast<size_t>(k_start) * D, k_rows);
    load_tile_f32<D>(vs, v + head + static_cast<size_t>(k_start) * D, k_rows);
    __syncthreads();

    float tile_max = kNegInf;
    for (int j = c0; j < c0 + kBlock / 2; ++j) {
      const float* kr = ks + j * D;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float x = dot * scale;
      if (key_masked(qpos, k_start + j, seq_len, causal)) x = kNegInf;
      srow[j] = x;
      tile_max = fmaxf(tile_max, x);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);
    float psum = 0.f;
    for (int j = c0; j < c0 + kBlock / 2; ++j) {
      float p = expf(srow[j] - m_new);
      if (key_masked(qpos, k_start + j, seq_len, causal)) p = 0.f;
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

  if (qpos >= seq_len) return;  // a ragged last q tile's padding rows
  const float l_safe = fmaxf(l, 1e-30f);
  float* out = o + head + static_cast<size_t>(qpos) * D + half * (D / 2);
  for (int c = 0; c < D / 2; ++c) out[c] = orow[c] / l_safe;
  if (half == 0) {
    lse[static_cast<size_t>(bh) * seq_len + qpos] = m + logf(l_safe);
  }
}

// ---- launch ------------------------------------------------------------

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
cudaError_t launch_ring(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int seq_len, float scale,
                        int causal, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = RingLayout<D>::bytes;
  cudaError_t err = configure(flash_fwd_bf16_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return err;
  constexpr int rows = kWarpsA * 16;
  const dim3 grid((seq_len + rows - 1) / rows, bh);
  flash_fwd_bf16_kernel<D><<<grid, kThreadsA, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), seq_len, scale, causal);
  return cudaGetLastError();
}


template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int seq_len, float scale,
                         int causal, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = TmaLayout<D>::bytes;
  cudaError_t err = configure(flash_fwd_wgmma_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return err;
  EncodeTiled encode = nullptr;
  err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[3];
  const void* data[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    err = make_map(encode, &maps[i], data[i], bh, seq_len, D,
                   i == 0 ? kRowsB : kKeysB);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((seq_len + kRowsB - 1) / kRowsB, bh);
  flash_fwd_wgmma_kernel<D><<<grid, kThreadsB, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o),
      static_cast<float*>(lse), seq_len, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int seq_len, float scale,
                       int causal, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = F32Layout<D>::bytes;
  cudaError_t err = configure(flash_fwd_f32_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kBlock - 1) / kBlock, bh);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), seq_len, scale, causal);
  return cudaGetLastError();
}

// bf16 head dims 64 and 128 take the wgmma kernel (128-key tiles), 16
// and 32 the mma.sync kernel (64-key tiles); the key-tile width is
// mirrored by forward_block_k in ops/flash_attention.py.
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int seq_len, int dtype, float scale,
                   int causal, cudaStream_t stream) {
  if (dtype == 0) {
    return launch_f32<D>(q, k, v, o, lse, bh, seq_len, scale, causal,
                         stream);
  }
  if constexpr (D >= 64) {
    return launch_wgmma<D>(q, k, v, o, lse, bh, seq_len, scale, causal,
                           stream);
  } else {
    return launch_ring<D>(q, k, v, o, lse, bh, seq_len, scale, causal,
                          stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 16, 32, 64 or 128; any
// seq_len >= 1; q, k, v, o 16-byte aligned. Returns a cudaError_t
// (0 = success).
extern "C" int edl_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int bh, int seq_len, int head_dim,
                                       int dtype, float scale, int causal,
                                       void* stream) {
  if (bh <= 0 || bh > 65535 || seq_len <= 0) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(o)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
      return cudaErrorMisalignedAddress;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  decltype(&launch<16>) fn = nullptr;
  switch (head_dim) {
    case 16: fn = launch<16>; break;
    case 32: fn = launch<32>; break;
    case 64: fn = launch<64>; break;
    case 128: fn = launch<128>; break;
    default: return cudaErrorInvalidValue;
  }
  return fn(q, k, v, o, lse, bh, seq_len, dtype, scale, causal, s);
}

extern "C" const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
