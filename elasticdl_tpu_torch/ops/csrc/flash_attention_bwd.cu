// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the two TPU kernels of elasticdl_tpu/ops/flash_attention.py
// `flash_chunk_grads`:
//   - dq   (`_dq_kernel`,  pallas_call at :493): dQ = sum_k dS K * scale,
//   - dk/dv (`_dkv_kernel`, pallas_call at :528): dK = sum_q dS^T Q * scale,
//     dV = sum_q P^T dO,
// with P = exp(S * scale - lse), S = Q K^T, dS = P o (dO V^T - delta) and
// delta = rowsum(dO o O) computed by the caller. q/do are (BH, Sq, D),
// k/v (BH, Sk, D), lse/delta (BH, Sq) f32; dq (BH, Sq, D), dk/dv
// (BH, Sk, D) are written in f32. Sq != Sk is allowed; q_offset/k_offset
// are the global positions of q[., 0] and k[., 0], and the causal mask
// keeps q_offset + i >= k_offset + j (the ring backward's contract).
//
// What bounds it on the H100, at the flagship shape (BH 32, S 1024,
// D 128, causal, bf16): dq reads q, k, v, dO (8.39 MB each) and lse,
// delta (0.13 MB each) and writes dq in f32 (16.78 MB): 50.6 MB, 15.1 us
// at 3.35 TB/s, against 3 products x 4.30 GFLOP = 12.9 GFLOP, 13.0 us
// at 989 TFLOP/s. dk/dv reads the same and writes dk and dv in f32
// (33.6 MB): 67.4 MB, 20.1 us, against 4 x 4.30 = 17.2 GFLOP, 17.4 us.
// Both are memory bound, barely, at that shape. At the ring's local
// block (BH 4, Sq = Sk = 2048, D 128) a past chunk has every pair
// unmasked, and dk/dv is bound by its 17.2 GFLOP of products. The
// products must run on the tensor cores and the (S x S) probabilities
// must never reach device memory.
//
// Because lse is known, a probability needs no running max and its bf16
// rounding is elementwise: the tile widths below do not change the
// results. The TPU grids' sequential axes become loops inside a block.
//
// dq: one block per (bh, 64-row q tile) loops over the 64-key K/V tiles
// that the causal mask leaves reachable. The grid is read heads fastest
// from the last q tile down, so every head's heaviest q tile starts
// first. A probability and dS stay in registers: S's accumulator
// fragment, with P and dS taken on it, is repacked in place as the A
// operand of dS K. bf16 takes one of two kernels, by head dim:
//
// - D 64 and 128: `flash_bwd_dq_wgmma_kernel`, #4's design turned round
//   (the q tile stays, the keys stream). Two consumer warpgroups share
//   the block's 64 q rows and take alternate key tiles. A producer
//   warpgroup loads Q and dO once by TMA, then streams each K and V tile
//   by TMA into a four-slot ring (two slots a consumer) under full and
//   empty mbarriers. A consumer computes S and dP with wgmma m64n64k16
//   from shared memory (Q, K, dO, V K-major in the 128-byte swizzle TMA
//   writes), takes p = 2^(s scale log2(e) - lse log2(e)) and dS on the
//   accumulators (each thread's rows' lse and delta sit in registers,
//   read once), packs dS to bf16 in place and adds dq += dS K with wgmma
//   reading the same K tile MN-major (the transpose bit); its dq sum
//   stays in registers across the loop, and at the end the second
//   consumer's sum reaches the first through the idle ring, always in
//   that order. The producer gives registers back with setmaxnreg (24)
//   and the consumers take 240: the sum (64 at D 128), S and dP (64) and
//   the packed dS (16). 161 KB of shared memory at D 128: one block an
//   SM, and the ring's local block (BH 4 x 2048) is 128 blocks, one wave.
//   A q tile that no key reaches issues no TMA and stores zeros.
// - D 16 and 32: `flash_bwd_dq_ring_kernel`, mma.sync. Four warps own 16
//   q rows each. Q and dO are copied once by cp.async and held as A
//   fragments; K and V stream through a two-slot cp.async ring, so tile
//   t+1's copy runs under tile t's products; fragments come from ldmatrix
//   (x4, and .trans for K as the B operand of dS K) over rows padded by
//   16 bytes, free of bank conflicts. A ragged key tile's rows past Sk
//   repeat row Sk - 1 (the copy stays inside the tensor) and the mask
//   zeroes their p, which keeps them out of dq.
//
// dk/dv: one block per (bh, 64-key tile) loops over the 64-query tiles
// at or below the diagonal. The grid is read heads fastest, so every
// head's first k tile (under the causal mask the heaviest: it meets
// every query) starts before any head's next one. Computing S^T = K Q^T
// puts P^T and dS^T in the accumulator layout that is the A operand of
// the next products, so p and ds never leave registers. bf16 takes one
// of two kernels, by head dim:
//
// - D 64 and 128: `flash_bwd_dkv_wgmma_kernel`. Two consumer warpgroups
//   share the block's 64 keys and take alternate q tiles. A producer
//   warpgroup loads K and V once by TMA, then streams each Q and dO tile
//   by TMA into a four-slot ring (two slots a consumer) under full and
//   empty mbarriers, while another of its warps writes the tile's lse
//   (in log2 units) and delta into the slot: the next tiles' copies run
//   under this tile's products. A consumer computes S^T and dP^T with
//   wgmma m64n64k16 from shared memory (K, V, Q and dO K-major in the
//   128-byte swizzle TMA writes), takes p = 2^(s scale log2(e) -
//   lse log2(e)) and dS^T on the accumulators, packs both to bf16 in
//   place, and adds dV += P^T dO and dK += dS^T Q with wgmma reading dO
//   and Q as MN-major operands (the transpose bit); its dK and dV sums
//   stay in registers across the loop, and at the end the second
//   consumer's sums reach the first through the idle ring. ptxas sizes
//   the 384-thread block at 168 registers a thread; the producer gives
//   registers back with setmaxnreg (24) and the consumers take 240, which
//   hold both sums (128), S^T and dP^T (64) and the packed P^T and dS^T
//   without spilling. 163 KB of shared memory at D 128: one block an SM.
//   On an H100 two consumers on alternate q tiles ran 15-28% faster than
//   one consumer a block (both shapes); issuing the next tile's scores
//   before waiting for this tile's dV and dK products, or each consumer
//   storing one of the two sums, ran no faster (PERF.md). The tensor maps are 3-D (D, S, BH): a ragged tile's rows
//   past Sq arrive as zeros, and their p is set to 0 all the same.
// - D 16 and 32: `flash_bwd_dkv_ring_kernel`, mma.sync. Four warps own 16
//   keys each. K and V, and each Q/dO tile with its lse and delta, are
//   copied by cp.async, Q/dO through a two-slot ring, so tile t+1's copy
//   runs under tile t's products; fragments come from ldmatrix (x4, and
//   .trans for the dO and Q operands of P^T dO and dS^T Q) over rows
//   padded by 16 bytes, free of bank conflicts. A ragged q tile's rows
//   past Sq repeat row Sq - 1 (the copy stays inside the tensor, and no
//   row is left to chance) and the mask zeroes their p, which keeps them
//   out of dK and dV.
//
// ptxas -v prints every kernel's registers, spills and shared memory at
// each build (chip_smoke.py shows them; PERF.md keeps them).
//
// Any Sq and Sk: rows past the end of a ragged last tile are masked (dq:
// keys past Sk like keys above the diagonal; dk/dv: queries past Sq) and
// not stored. A k tile that no query reaches stores zeros.
//
// Rounding points follow the TPU kernel: S and dP accumulate in f32, the
// scale multiplies S in f32 after the product, ds is cast to k's dtype
// before dS K and to q's dtype before dS^T Q, p to dO's dtype before
// P^T dO, and dq, dk are scaled once, in f32, before the store.
//
// f32 inputs (kept for the numeric check) take scalar kernels with the
// same tiling: two lanes per row, dS (and P) tiles in shared memory, the
// accumulators in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"  // cp.async, ldmatrix, mbarriers, TMA, wgmma

namespace {

constexpr int kBlock = 64;              // rows per block, rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = kBlock / kWarps;  // 16
constexpr int kBf16BlocksPerSm = 2;
constexpr float kLog2e = 1.4426950408889634f;

// ---- shared helpers --------------------------------------------------

__device__ __forceinline__ int tile_rows(int start, int len) {
  return min(kBlock, len - start);
}

// Number of 64-key tiles a q tile needs: under the causal mask, the
// tiles left of the first one wholly above the diagonal.
__device__ __forceinline__ int dq_num_tiles(int q_first, int k_offset,
                                            int sk, int causal) {
  const int all = (sk + kBlock - 1) / kBlock;
  if (!causal) return all;
  const int last_q = q_first + kBlock - 1;  // global position
  if (last_q < k_offset) return 0;
  return min(all, (last_q - k_offset) / kBlock + 1);
}

// First 64-query tile a k tile needs: the tiles before it lie wholly
// above the diagonal.
__device__ __forceinline__ int dkv_first_tile(int k_first, int q_offset,
                                              int causal) {
  if (!causal) return 0;
  const int need = k_first - q_offset - (kBlock - 1);
  return need <= 0 ? 0 : (need + kBlock - 1) / kBlock;
}

// A bf16 dK/dV grid is (k tiles, BH). Blocks start in the order of their
// linear index, so the index is read heads fastest: every head's first k
// tile (the heaviest under the causal mask) starts before any head's
// next one.
__device__ __forceinline__ int heads_fastest_tile() {
  return (blockIdx.x + gridDim.x * blockIdx.y) / gridDim.y;
}

__device__ __forceinline__ int heads_fastest_head() {
  return (blockIdx.x + gridDim.x * blockIdx.y) % gridDim.y;
}

// A bf16 dq grid is (q tiles, BH), read heads fastest from the last q tile
// down: under the causal mask the last q tile meets the most keys, so
// every head's heaviest tile starts before any head's next one.
__device__ __forceinline__ int heaviest_first_tile() {
  return gridDim.x - 1 - heads_fastest_tile();
}

// ---- bf16 dK/dV, D 16 and 32: mma.sync over a cp.async Q/dO ring -------

constexpr int kSlotsA = 2;  // Q/dO ring slots

// Shared memory: K, V (64 padded rows each), then the ring's slots, each
// Q, dO (64 padded rows each) and the tile's lse and delta (64 f32 each).
template <int D>
struct DkvRingLayout {
  static constexpr int ld = D + 8;  // padded row stride (elements)
  static constexpr int tile = kBlock * ld;
  static constexpr size_t ring = 2 * tile * sizeof(__nv_bfloat16);
  static constexpr size_t stats = 2 * tile * sizeof(__nv_bfloat16);
  static constexpr size_t slot = stats + 2 * kBlock * sizeof(float);
  static constexpr size_t bytes = ring + kSlotsA * slot;
};

// Starts the copy of a 64-row tile of a contiguous (.., D) tensor into
// padded shared rows. Rows at or past `valid` repeat row valid - 1: the
// copy never leaves the tensor, and the kernel masks those rows.
template <int D>
__device__ __forceinline__ void copy_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int valid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    cp_async_16(dst + r * DkvRingLayout<D>::ld + c * 8,
                src + min(r, valid - 1) * D + c * 8, 16);
  }
}

// Starts the copy of a q tile into a ring slot: Q, dO, and lse, delta
// (thread i < 64 copies lse row i, the others delta row i - 64).
template <int D>
__device__ __forceinline__ void copy_q_tile_async(
    unsigned char* slot, const __nv_bfloat16* q, const __nv_bfloat16* dout,
    const float* lse, const float* delta, int bh, int sq, int q_start) {
  using L = DkvRingLayout<D>;
  const int valid = tile_rows(q_start, sq);
  const size_t at = (static_cast<size_t>(bh) * sq + q_start);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(slot);
  copy_rows_async<D>(qs, q + at * D, valid);
  copy_rows_async<D>(qs + L::tile, dout + at * D, valid);
  float* stats = reinterpret_cast<float*>(slot + L::stats);
  const int r = threadIdx.x & (kBlock - 1);
  cp_async_4(stats + threadIdx.x,
             (threadIdx.x < kBlock ? lse : delta) + at + min(r, valid - 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads, kBf16BlocksPerSm)
flash_bwd_dkv_ring_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int sq, int sk, int q_offset, int k_offset,
                          float scale, int causal) {
  using L = DkvRingLayout<D>;
  constexpr int ld = L::ld;
  constexpr int kSteps = D / 16;
  constexpr int kOutBlocks = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + L::tile;
  unsigned char* ring = smem + L::ring;

  const int k_tile = heads_fastest_tile();
  const int bh = heads_fastest_head();
  const int k_start = k_tile * kBlock;
  const int k_rows = tile_rows(k_start, sk);
  const size_t khead = static_cast<size_t>(bh) * sk * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = warp * kWarpRows + g;  // this lane's key rows
  const int gk0 = k_offset + k_start + row0;
  const int gk1 = gk0 + 8;
  const int num_q_tiles = (sq + kBlock - 1) / kBlock;
  const int first = dkv_first_tile(k_offset + k_start, q_offset, causal);
  const int count = num_q_tiles - first;  // <= 0: no query reaches it

  // K, V and the first q tile in flight together.
  if (count > 0) {
    copy_rows_async<D>(ks, k + khead + static_cast<size_t>(k_start) * D,
                       k_rows);
    copy_rows_async<D>(vs, v + khead + static_cast<size_t>(k_start) * D,
                       k_rows);
    copy_q_tile_async<D>(ring, q, dout, lse, delta, bh, sq, first * kBlock);
  }
  cp_async_commit();

  float dka[kOutBlocks][4], dva[kOutBlocks][4];
  #pragma unroll
  for (int nb = 0; nb < kOutBlocks; ++nb) {
    dka[nb][0] = dka[nb][1] = dka[nb][2] = dka[nb][3] = 0.f;
    dva[nb][0] = dva[nb][1] = dva[nb][2] = dva[nb][3] = 0.f;
  }

  for (int i = 0; i < count; ++i) {
    const int q_start = (first + i) * kBlock;
    if (i + 1 < count) {  // tile i + 1's copy runs under this tile
      copy_q_tile_async<D>(ring + ((i + 1) % kSlotsA) * L::slot, q, dout,
                           lse, delta, bh, sq, q_start + kBlock);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const int slot = i % kSlotsA;
    const __nv_bfloat16* qs =
        reinterpret_cast<const __nv_bfloat16*>(ring + slot * L::slot);
    const __nv_bfloat16* dos = qs + L::tile;
    const float* lse_s =
        reinterpret_cast<const float*>(ring + slot * L::slot + L::stats);
    const float* dl_s = lse_s + kBlock;
    const int q_rows = tile_rows(q_start, sq);
    // Only tiles that cross the diagonal or end ragged hold masked pairs.
    const bool masked_tile =
        (causal && q_offset + q_start < k_offset + k_start + kBlock - 1) ||
        q_rows < kBlock;

    #pragma unroll 1
    for (int qc = 0; qc < kBlock / 16; ++qc) {
      // S^T = K Q^T and dP^T = V dO^T for 16 keys x 16 queries: K and V
      // give A fragments, Q and dO rows the B fragments of two 8-query
      // blocks, one ldmatrix.x4 each.
      float st[2][4], dpt[2][4];
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        st[h][0] = st[h][1] = st[h][2] = st[h][3] = 0.f;
        dpt[h][0] = dpt[h][1] = dpt[h][2] = dpt[h][3] = 0.f;
      }
      const int a_at = (warp * kWarpRows + (lane & 15)) * ld + (lane >> 4) * 8;
      const int b_at = (qc * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                       ((lane >> 3) & 1) * 8;
      #pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t ka[4], va[4], qb[4], db[4];
        ldmatrix_x4(ka, ks + a_at + kk * 16);
        ldmatrix_x4(va, vs + a_at + kk * 16);
        ldmatrix_x4(qb, qs + b_at + kk * 16);
        ldmatrix_x4(db, dos + b_at + kk * 16);
        mma_bf16(st[0], ka, qb[0], qb[1]);
        mma_bf16(st[1], ka, qb[2], qb[3]);
        mma_bf16(dpt[0], va, db[0], db[1]);
        mma_bf16(dpt[1], va, db[2], db[3]);
      }
      // P^T and dS^T = P^T o (dP^T - delta[col]).
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = qc * 16 + h * 8 + 2 * t + (e & 1);  // query in tile
          const bool hi = e >= 2;
          float p = expf(st[h][e] * scale - lse_s[c]);
          if (masked_tile &&
              (c >= q_rows ||
               (causal && q_offset + q_start + c < (hi ? gk1 : gk0)))) {
            p = 0.f;
          }
          dpt[h][e] = p * (dpt[h][e] - dl_s[c]);
          st[h][e] = p;
        }
      }
      const uint32_t pa[4] = {
          pack_bf16(st[0][0], st[0][1]), pack_bf16(st[0][2], st[0][3]),
          pack_bf16(st[1][0], st[1][1]), pack_bf16(st[1][2], st[1][3]),
      };
      const uint32_t dsa[4] = {
          pack_bf16(dpt[0][0], dpt[0][1]), pack_bf16(dpt[0][2], dpt[0][3]),
          pack_bf16(dpt[1][0], dpt[1][1]), pack_bf16(dpt[1][2], dpt[1][3]),
      };
      // dV += P^T dO and dK += dS^T Q over these 16 queries: one
      // ldmatrix.x4.trans gives the B fragments of two 8-column blocks.
      const int t_at = (qc * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
      #pragma unroll
      for (int nb = 0; nb < kOutBlocks; nb += 2) {
        uint32_t db[4], qb[4];
        ldmatrix_x4_trans(db, dos + t_at + nb * 8);
        ldmatrix_x4_trans(qb, qs + t_at + nb * 8);
        mma_bf16(dva[nb], pa, db[0], db[1]);
        mma_bf16(dva[nb + 1], pa, db[2], db[3]);
        mma_bf16(dka[nb], dsa, qb[0], qb[1]);
        mma_bf16(dka[nb + 1], dsa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with this slot: refill it
  }

  // dK (scaled once, in f32) and dV; zeros where no query reached.
  const size_t at0 = khead + static_cast<size_t>(k_start + row0) * D + 2 * t;
  const size_t at1 = at0 + 8 * D;
  if (row0 < k_rows) {
    #pragma unroll
    for (int nb = 0; nb < kOutBlocks; ++nb) {
      *reinterpret_cast<float2*>(dk + at0 + nb * 8) =
          make_float2(dka[nb][0] * scale, dka[nb][1] * scale);
      *reinterpret_cast<float2*>(dv + at0 + nb * 8) =
          make_float2(dva[nb][0], dva[nb][1]);
    }
  }
  if (row0 + 8 < k_rows) {
    #pragma unroll
    for (int nb = 0; nb < kOutBlocks; ++nb) {
      *reinterpret_cast<float2*>(dk + at1 + nb * 8) =
          make_float2(dka[nb][2] * scale, dka[nb][3] * scale);
      *reinterpret_cast<float2*>(dv + at1 + nb * 8) =
          make_float2(dva[nb][2], dva[nb][3]);
    }
  }
}

// ---- bf16 dK/dV, D 64 and 128: wgmma over a TMA Q/dO ring --------------

constexpr int kConsumersB = 2;   // consumer warpgroups, on alternate q tiles
constexpr int kSlotsB = 4;       // Q/dO ring slots, two a consumer warpgroup
constexpr int kThreadsB = (kConsumersB + 1) * 128;  // + a producer warpgroup
constexpr int kTmaWarp = kConsumersB * 4;  // the producer warp issuing TMA
constexpr int kStatsWarp = kTmaWarp + 1;   // the one writing lse, delta
constexpr int kProducerRegs = 24;  // setmaxnreg: the producer gives its
constexpr int kConsumerRegs = 240;  // registers to the consumers

// The consumer warpgroups alone meet here (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumersB * 128) : "memory");
}

// Shared memory, every tile 1024-byte aligned (the 128-byte swizzle's
// period), each a 64-row tile as D/64 column blocks of 64 rows x 128
// bytes: K, V, then the ring's slots (Q, then dO), then each slot's lse
// (log2 units) and delta, 64 f32 each, then the mbarriers. After the
// loop the ring carries the second consumer warpgroup's sums to the
// first.
template <int D>
struct DkvTmaLayout {
  static constexpr uint32_t block = kBlock * kSwizzleRow;
  static constexpr uint32_t tile = D / 64 * block;
  static constexpr uint32_t v = tile;
  static constexpr uint32_t ring = 2 * tile;
  static constexpr uint32_t slot = 2 * tile;
  static constexpr uint32_t stats = ring + kSlotsB * slot;
  static constexpr uint32_t barriers = stats + kSlotsB * 2 * kBlock * 4;
  static constexpr size_t bytes = barriers + 64 + 1024;  // + alignment
  static_assert(2 * D / 2 * 128 * 4 <= kSlotsB * slot, "sums fit the ring");
};

template <int D>
__global__ void __launch_bounds__(kThreadsB, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int sq, int sk, int q_offset, int k_offset,
                           float scale, int causal) {
  using L = DkvTmaLayout<D>;
  constexpr int kColBlocks = D / 64;
  constexpr int kOut = D / 2;  // accumulator floats a thread (64 x D)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* aligned = smem_raw + (base - raw);
  float* stats = reinterpret_cast<float*>(aligned + L::stats);
  const uint32_t full_bar = base + L::barriers;       // [slot]
  const uint32_t empty_bar = full_bar + 8 * kSlotsB;  // [slot]
  const uint32_t kv_bar = empty_bar + 8 * kSlotsB;

  const int k_tile = heads_fastest_tile();
  const int bh = heads_fastest_head();
  const int k_start = k_tile * kBlock;
  const int num_q_tiles = (sq + kBlock - 1) / kBlock;
  const int first_tile =
      dkv_first_tile(k_offset + k_start, q_offset, causal);
  const int count = num_q_tiles - first_tile;  // <= 0: no query reaches it
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlotsB; ++s) {
      // The TMA lane's arrive (with the bytes) and the stats warp's 32.
      mbar_init(full_bar + 8 * s, 1 + 32);
      mbar_init(empty_bar + 8 * s, 4);  // the consuming warpgroup's warps
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kTmaWarp) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kTmaWarp && lane == 0 && count > 0) {
      mbar_expect_tx(kv_bar, 2 * L::tile);
      for (int c = 0; c < kColBlocks; ++c) {
        tma_load(base + c * L::block, &tm_k, kv_bar, c * 64, k_start, bh);
        tma_load(base + L::v + c * L::block, &tm_v, kv_bar, c * 64,
                 k_start, bh);
      }
      for (int i = 0; i < count; ++i) {
        const int s = i % kSlotsB;
        if (i >= kSlotsB) {  // the consumers released tile i - kSlotsB
          mbar_wait(empty_bar + 8 * s, (i / kSlotsB - 1) & 1);
        }
        const uint32_t at = base + L::ring + s * L::slot;
        const int q_start = (first_tile + i) * kBlock;
        mbar_expect_tx(full_bar + 8 * s, 2 * L::tile);
        for (int c = 0; c < kColBlocks; ++c) {
          tma_load(at + c * L::block, &tm_q, full_bar + 8 * s, c * 64,
                   q_start, bh);
          tma_load(at + L::tile + c * L::block, &tm_do, full_bar + 8 * s,
                   c * 64, q_start, bh);
        }
      }
    } else if (warp == kStatsWarp) {  // lse (log2 units), delta: 2 rows a lane
      for (int i = 0; i < count; ++i) {
        const int s = i % kSlotsB;
        if (i >= kSlotsB) {
          mbar_wait(empty_bar + 8 * s, (i / kSlotsB - 1) & 1);
        }
        const int q_start = (first_tile + i) * kBlock;
        const size_t at = static_cast<size_t>(bh) * sq + q_start;
        float* out = stats + s * 2 * kBlock;
        for (int r = lane; r < kBlock; r += 32) {
          const bool in = q_start + r < sq;
          out[r] = in ? lse[at + r] * kLog2e : 0.f;
          out[kBlock + r] = in ? delta[at + r] : 0.f;
        }
        mbar_arrive(full_bar + 8 * s);  // release: the stores are seen
      }
    }
    return;
  }

  // The consumers: warpgroup wg takes q tiles wg, wg + 2, ...; in each,
  // warp w holds keys 16 (w % 4) ... 16 (w % 4) + 15.
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group: column pair
  const int row0 = (warp & 3) * 16 + g;  // this lane's keys: row0, row0 + 8
  const int gk0 = k_offset + k_start + row0;
  const int gk1 = gk0 + 8;
  const float scale_log2 = scale * kLog2e;
  float dka[kOut], dva[kOut];
  #pragma unroll
  for (int i = 0; i < kOut; ++i) dka[i] = dva[i] = 0.f;
  if (count > 0) mbar_wait(kv_bar, 0);

  for (int i = wg; i < count; i += kConsumersB) {
    const int slot = i % kSlotsB;
    mbar_wait(full_bar + 8 * slot, (i / kSlotsB) & 1);
    const uint32_t q_tile = base + L::ring + slot * L::slot;
    const uint32_t do_tile = q_tile + L::tile;
    const float* lse_s = stats + slot * 2 * kBlock;
    const float* dl_s = lse_s + kBlock;
    const int q_start = (first_tile + i) * kBlock;
    // Only tiles that cross the diagonal or end ragged hold masked pairs.
    const bool edge =
        (causal && q_offset + q_start < k_offset + k_start + kBlock - 1) ||
        q_start + kBlock > sq;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, 16 columns of
    // D a step. Inside a 128-byte swizzled row a step moves the start by
    // 32 bytes; past 64 columns it moves to the next column block.
    float st[32], dpt[32];
    wgmma_fence();
    #pragma unroll
    for (int kstep = 0; kstep < D / 16; ++kstep) {
      const uint32_t step = (kstep / 4) * L::block + (kstep % 4) * 32;
      wgmma_ss(st, gmma_desc(base + step, 16), gmma_desc(q_tile + step, 16),
               kstep > 0);
      wgmma_ss(dpt, gmma_desc(base + L::v + step, 16),
               gmma_desc(do_tile + step, 16), kstep > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(st);
    hold(dpt);

    // P^T and dS^T = P^T o (dP^T - delta); st[4 j + e] is key e < 2 ?
    // row0 : row0 + 8, query 8 j + 2 t + (e & 1) of the tile.
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float p = ex2_ftz(fmaf(st[4 * j + e], scale_log2, -lse_s[c]));
        if (edge && (q_start + c >= sq ||
                     (causal && q_offset + q_start + c < (e < 2 ? gk0 : gk1)))) {
          p = 0.f;
        }
        dpt[4 * j + e] = p * (dpt[4 * j + e] - dl_s[c]);
        st[4 * j + e] = p;
      }
    }
    // Packed to bf16 in the register-A layout, 16 queries a k-step.
    uint32_t pa[4][4], da[4][4];
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      #pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        da[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: dO's and Q's 16 query rows start
    // 16 x 128 bytes further each k-step; their column blocks lie one
    // block apart.
    hold(dva);
    hold(dka);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(dva, pa[kk], gmma_desc(do_tile + kk * 16 * kSwizzleRow,
                                      L::block));
      wgmma_rs(dka, da[kk], gmma_desc(q_tile + kk * 16 * kSwizzleRow,
                                      L::block));
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(dva);
    hold(dka);
    hold(pa);
    hold(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * slot);  // slot free
  }

  // The second warpgroup's sums meet the first's through the idle ring:
  // thread i of each holds the same elements.
  float* sums = reinterpret_cast<float*>(aligned + L::ring);
  const int tid = threadIdx.x & 127;
  consumers_sync();  // every product of both warpgroups has completed
  if (wg == 1) {
    #pragma unroll
    for (int j = 0; j < kOut; ++j) {
      sums[j * 128 + tid] = dka[j];
      sums[(kOut + j) * 128 + tid] = dva[j];
    }
  }
  consumers_sync();
  if (wg == 1) return;
  #pragma unroll
  for (int j = 0; j < kOut; ++j) {
    dka[j] += sums[j * 128 + tid];
    dva[j] += sums[(kOut + j) * 128 + tid];
  }

  // dK (scaled once, in f32) and dV, rows past Sk not stored; zeros where
  // no query reached. dka[4 j + e] is key e < 2 ? row0 : row0 + 8,
  // column 8 j + 2 t + (e & 1).
  const size_t head = static_cast<size_t>(bh) * sk * D;
  const size_t at0 = head + static_cast<size_t>(k_start + row0) * D + 2 * t;
  const size_t at1 = at0 + 8 * D;
  if (k_start + row0 < sk) {
    #pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dk + at0 + 8 * j) =
          make_float2(dka[4 * j] * scale, dka[4 * j + 1] * scale);
      *reinterpret_cast<float2*>(dv + at0 + 8 * j) =
          make_float2(dva[4 * j], dva[4 * j + 1]);
    }
  }
  if (k_start + row0 + 8 < sk) {
    #pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dk + at1 + 8 * j) =
          make_float2(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
      *reinterpret_cast<float2*>(dv + at1 + 8 * j) =
          make_float2(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

// ---- bf16 dq, D 16 and 32: mma.sync over a cp.async K/V ring -----------

// Shared memory: Q, dO (64 padded rows each), then the ring's slots, each
// a K and a V tile (64 padded rows each).
template <int D>
struct DqRingLayout {
  static constexpr int ld = DkvRingLayout<D>::ld;  // copy_rows_async's
  static constexpr int tile = kBlock * ld;
  static constexpr int slot = 2 * tile;
  static constexpr size_t bytes =
      static_cast<size_t>(2 * tile + kSlotsA * slot) * sizeof(bf16);
};

template <int D>
__global__ void __launch_bounds__(kThreads, kBf16BlocksPerSm)
flash_bwd_dq_ring_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int sq, int sk,
                         int q_offset, int k_offset, float scale,
                         int causal) {
  using L = DqRingLayout<D>;
  constexpr int ld = L::ld;
  constexpr int kSteps = D / 16;
  constexpr int kOutBlocks = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + L::tile;
  bf16* ring = dos + L::tile;

  const int q_tile = heaviest_first_tile();
  const int bh = heads_fastest_head();
  const int q_start = q_tile * kBlock;
  const int q_rows = tile_rows(q_start, sq);
  const size_t qhead = static_cast<size_t>(bh) * sq * D;
  const size_t khead = static_cast<size_t>(bh) * sk * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = warp * kWarpRows + g;  // this lane's rows: row0, row0+8
  const int gq0 = q_offset + q_start + row0;  // global positions
  const int gq1 = gq0 + 8;
  const int count = dq_num_tiles(q_offset + q_start, k_offset, sk, causal);
  // Starts the copy of key tile i into its slot: rows past Sk repeat row
  // Sk - 1 (the copy stays inside the tensor) and the mask keeps them out.
  auto copy_kv = [&](int i) {
    bf16* slot = ring + (i % kSlotsA) * L::slot;
    const int valid = tile_rows(i * kBlock, sk);
    const size_t at = khead + static_cast<size_t>(i) * kBlock * D;
    copy_rows_async<D>(slot, k + at, valid);
    copy_rows_async<D>(slot + L::tile, v + at, valid);
  };

  // Q and dO, then the first K/V tile, in flight together; a q tile that
  // no key reaches copies nothing and stores zeros.
  if (count > 0) {
    copy_rows_async<D>(qs, q + qhead + static_cast<size_t>(q_start) * D,
                       q_rows);
    copy_rows_async<D>(dos, dout + qhead + static_cast<size_t>(q_start) * D,
                       q_rows);
  }
  cp_async_commit();
  if (count > 0) copy_kv(0);
  cp_async_commit();

  // This lane's rows' lse (log2 units) and delta; rows past Sq read 0.
  const float* lrow = lse + static_cast<size_t>(bh) * sq + q_start;
  const float* drow = delta + static_cast<size_t>(bh) * sq + q_start;
  const float lse0 = row0 < q_rows ? lrow[row0] * kLog2e : 0.f;
  const float lse1 = row0 + 8 < q_rows ? lrow[row0 + 8] * kLog2e : 0.f;
  const float dl0 = row0 < q_rows ? drow[row0] : 0.f;
  const float dl1 = row0 + 8 < q_rows ? drow[row0 + 8] : 0.f;
  const float scale_log2 = scale * kLog2e;

  float acc[kOutBlocks][4];
  #pragma unroll
  for (int nb = 0; nb < kOutBlocks; ++nb) {
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  }
  // Q's and dO's A fragments stay in registers (16 at D 32).
  uint32_t qa[kSteps][4], da[kSteps][4];
  if (count > 0) {
    cp_async_wait<1>();  // Q and dO have landed
    __syncthreads();
    const int a_at = (warp * kWarpRows + (lane & 15)) * ld + (lane >> 4) * 8;
    #pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      ldmatrix_x4(qa[kk], qs + a_at + kk * 16);
      ldmatrix_x4(da[kk], dos + a_at + kk * 16);
    }
  }

  for (int i = 0; i < count; ++i) {
    const int k_start = i * kBlock;
    if (i + 1 < count) copy_kv(i + 1);  // runs under this tile's products
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const bf16* ks = ring + (i % kSlotsA) * L::slot;
    const bf16* vs = ks + L::tile;
    // Only tiles that cross the diagonal or end ragged hold masked keys.
    const bool masked_tile =
        (causal && k_offset + k_start + kBlock - 1 > q_offset + q_start) ||
        k_start + kBlock > sk;

    #pragma unroll 1
    for (int kc = 0; kc < kBlock / 16; ++kc) {
      // S = Q K^T and dP = dO V^T for 16 rows x 16 keys: K and V rows
      // give the B fragments of two 8-key blocks, one ldmatrix.x4 each.
      float s[2][4], dp[2][4];
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
        dp[h][0] = dp[h][1] = dp[h][2] = dp[h][3] = 0.f;
      }
      const int b_at = (kc * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                       ((lane >> 3) & 1) * 8;
      #pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, ks + b_at + kk * 16);
        ldmatrix_x4(vb, vs + b_at + kk * 16);
        mma_bf16(s[0], qa[kk], kb[0], kb[1]);
        mma_bf16(s[1], qa[kk], kb[2], kb[3]);
        mma_bf16(dp[0], da[kk], vb[0], vb[1]);
        mma_bf16(dp[1], da[kk], vb[2], vb[3]);
      }
      // dS = P o (dP - delta), P = 2^(S scale log2(e) - lse log2(e)).
      float ds[2][4];
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = k_start + kc * 16 + h * 8 + 2 * t + (e & 1);
          const bool hi = e >= 2;
          float p = ex2_ftz(fmaf(s[h][e], scale_log2, -(hi ? lse1 : lse0)));
          if (masked_tile &&
              (kl >= sk || (causal && (hi ? gq1 : gq0) < k_offset + kl))) {
            p = 0.f;
          }
          ds[h][e] = p * (dp[h][e] - (hi ? dl1 : dl0));
        }
      }
      // dq += dS (in k's dtype) K: dS's accumulators are the A fragment;
      // one ldmatrix.x4.trans of K gives the B fragments of two 8-column
      // blocks.
      const uint32_t dsa[4] = {
          pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
          pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3]),
      };
      const int t_at = (kc * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
      #pragma unroll
      for (int nb = 0; nb < kOutBlocks; nb += 2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, ks + t_at + nb * 8);
        mma_bf16(acc[nb], dsa, kb[0], kb[1]);
        mma_bf16(acc[nb + 1], dsa, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with this slot: refill it
  }

  // dq, scaled once in f32; zeros where no key reached.
  float* out0 = dq + qhead + static_cast<size_t>(q_start + row0) * D + 2 * t;
  float* out1 = out0 + 8 * D;
  if (row0 < q_rows) {
    #pragma unroll
    for (int nb = 0; nb < kOutBlocks; ++nb) {
      *reinterpret_cast<float2*>(out0 + nb * 8) =
          make_float2(acc[nb][0] * scale, acc[nb][1] * scale);
    }
  }
  if (row0 + 8 < q_rows) {
    #pragma unroll
    for (int nb = 0; nb < kOutBlocks; ++nb) {
      *reinterpret_cast<float2*>(out1 + nb * 8) =
          make_float2(acc[nb][2] * scale, acc[nb][3] * scale);
    }
  }
}

// ---- bf16 dq, D 64 and 128: wgmma over a TMA K/V ring ------------------

// Shared memory, every tile 1024-byte aligned, each a 64-row tile as D/64
// column blocks of 64 rows x 128 bytes: Q, dO, then the ring's slots (K,
// then V), then the mbarriers. After the loop the ring carries the second
// consumer warpgroup's sum to the first.
template <int D>
struct DqTmaLayout {
  static constexpr uint32_t block = kBlock * kSwizzleRow;
  static constexpr uint32_t tile = D / 64 * block;
  static constexpr uint32_t dout = tile;
  static constexpr uint32_t ring = 2 * tile;
  static constexpr uint32_t slot = 2 * tile;
  static constexpr uint32_t barriers = ring + kSlotsB * slot;
  static constexpr size_t bytes = barriers + 128 + 1024;  // + alignment
  static_assert(D / 2 * 128 * 4 <= kSlotsB * slot, "the sum fits the ring");
};

template <int D>
__global__ void __launch_bounds__(kThreadsB, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq, int sq, int sk,
                          int q_offset, int k_offset, float scale,
                          int causal) {
  using L = DqTmaLayout<D>;
  constexpr int kColBlocks = D / 64;
  constexpr int kOut = D / 2;  // accumulator floats a thread (64 x D)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* aligned = smem_raw + (base - raw);
  const uint32_t full_bar = base + L::barriers;       // [slot]
  const uint32_t empty_bar = full_bar + 8 * kSlotsB;  // [slot]
  const uint32_t qdo_bar = empty_bar + 8 * kSlotsB;

  const int q_tile = heaviest_first_tile();
  const int bh = heads_fastest_head();
  const int q_start = q_tile * kBlock;
  const int count = dq_num_tiles(q_offset + q_start, k_offset, sk, causal);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlotsB; ++s) {
      mbar_init(full_bar + 8 * s, 1);   // the TMA lane's arrive, with bytes
      mbar_init(empty_bar + 8 * s, 4);  // the consuming warpgroup's warps
    }
    mbar_init(qdo_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kTmaWarp) {  // the producer warpgroup: one lane issues TMA
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kTmaWarp && lane == 0 && count > 0) {
      mbar_expect_tx(qdo_bar, 2 * L::tile);
      for (int c = 0; c < kColBlocks; ++c) {
        tma_load(base + c * L::block, &tm_q, qdo_bar, c * 64, q_start, bh);
        tma_load(base + L::dout + c * L::block, &tm_do, qdo_bar, c * 64,
                 q_start, bh);
      }
      for (int i = 0; i < count; ++i) {
        const int s = i % kSlotsB;
        if (i >= kSlotsB) {  // the consumer released tile i - kSlotsB
          mbar_wait(empty_bar + 8 * s, (i / kSlotsB - 1) & 1);
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
  // warp w holds q rows 16 (w % 4) ... 16 (w % 4) + 15.
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group: column pair
  const int row0 = (warp & 3) * 16 + g;  // this lane's rows: row0, row0 + 8
  const int gq0 = q_offset + q_start + row0;
  const int gq1 = gq0 + 8;
  const float scale_log2 = scale * kLog2e;
  // The rows' lse (log2 units) and delta, read once; rows past Sq read 0.
  const size_t rows_at = static_cast<size_t>(bh) * sq + q_start;
  const bool in0 = q_start + row0 < sq;
  const bool in1 = q_start + row0 + 8 < sq;
  const float lse0 = in0 ? lse[rows_at + row0] * kLog2e : 0.f;
  const float lse1 = in1 ? lse[rows_at + row0 + 8] * kLog2e : 0.f;
  const float dl0 = in0 ? delta[rows_at + row0] : 0.f;
  const float dl1 = in1 ? delta[rows_at + row0 + 8] : 0.f;
  float dqa[kOut];
  #pragma unroll
  for (int i = 0; i < kOut; ++i) dqa[i] = 0.f;
  if (wg < count) mbar_wait(qdo_bar, 0);  // no tile: wait on nothing

  for (int i = wg; i < count; i += kConsumersB) {
    const int slot = i % kSlotsB;
    mbar_wait(full_bar + 8 * slot, (i / kSlotsB) & 1);
    const uint32_t k_tile = base + L::ring + slot * L::slot;
    const uint32_t v_tile = k_tile + L::tile;
    const int k_start = i * kBlock;
    // Only tiles that cross the diagonal or end ragged hold masked keys.
    const bool edge =
        (causal && k_offset + k_start + kBlock - 1 > q_offset + q_start) ||
        k_start + kBlock > sk;

    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys, 16 columns of D a
    // step. Inside a 128-byte swizzled row a step moves the start by 32
    // bytes; past 64 columns it moves to the next column block.
    float s[32], dp[32];
    wgmma_fence();
    #pragma unroll
    for (int kstep = 0; kstep < D / 16; ++kstep) {
      const uint32_t step = (kstep / 4) * L::block + (kstep % 4) * 32;
      wgmma_ss(s, gmma_desc(base + step, 16), gmma_desc(k_tile + step, 16),
               kstep > 0);
      wgmma_ss(dp, gmma_desc(base + L::dout + step, 16),
               gmma_desc(v_tile + step, 16), kstep > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(s);
    hold(dp);

    // dS = P o (dP - delta); s[4 j + e] is row e < 2 ? row0 : row0 + 8,
    // key 8 j + 2 t + (e & 1) of the tile. The mask is a select, so a
    // row no key reaches (lse -1e30: 2^(...) is inf) gets p = 0, not NaN.
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = k_start + 8 * j + 2 * t + (e & 1);
        float p = ex2_ftz(fmaf(s[4 * j + e], scale_log2,
                               -(e < 2 ? lse0 : lse1)));
        if (edge && (kl >= sk ||
                     (causal && (e < 2 ? gq0 : gq1) < k_offset + kl))) {
          p = 0.f;
        }
        dp[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
      }
    }
    // dS packed to bf16 (k's dtype) in the register-A layout, 16 keys a
    // k-step.
    uint32_t da[4][4];
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      #pragma unroll
      for (int r = 0; r < 4; ++r) {
        da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    }

    // dq += dS K: K's 16 key rows start 16 x 128 bytes further each
    // k-step, read MN-major (the transpose bit); its column blocks lie one
    // block apart.
    hold(dqa);
    wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(dqa, da[kk], gmma_desc(k_tile + kk * 16 * kSwizzleRow,
                                      L::block));
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(dqa);
    hold(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * slot);  // slot free
  }

  // The second warpgroup's sum meets the first's through the idle ring:
  // thread i of each holds the same elements, added in this order.
  float* sums = reinterpret_cast<float*>(aligned + L::ring);
  const int tid = threadIdx.x & 127;
  consumers_sync();  // every product of both warpgroups has completed
  if (wg == 1) {
    #pragma unroll
    for (int j = 0; j < kOut; ++j) sums[j * 128 + tid] = dqa[j];
  }
  consumers_sync();
  if (wg == 1) return;
  #pragma unroll
  for (int j = 0; j < kOut; ++j) dqa[j] += sums[j * 128 + tid];

  // dq, scaled once in f32; rows past Sq not stored; zeros where no key
  // reached. dqa[4 j + e] is row e < 2 ? row0 : row0 + 8, column
  // 8 j + 2 t + (e & 1).
  const size_t at0 = (rows_at + row0) * D + 2 * t;
  const size_t at1 = at0 + 8 * D;
  if (in0) {
    #pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dq + at0 + 8 * j) =
          make_float2(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
    }
  }
  if (in1) {
    #pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dq + at1 + 8 * j) =
          make_float2(dqa[4 * j + 2] * scale, dqa[4 * j + 3] * scale);
    }
  }
}

// ---- f32: scalar FMAs, two lanes per row ------------------------------

template <int D>
struct F32DqLayout {
  static constexpr size_t tile = static_cast<size_t>(kBlock) * D;  // floats
  static constexpr size_t bytes =
      (4 * tile + static_cast<size_t>(kBlock) * kBlock) * sizeof(float);
};

template <int D>
struct F32DkvLayout {
  static constexpr size_t tile = static_cast<size_t>(kBlock) * D;
  static constexpr size_t bytes =
      (4 * tile + 2 * static_cast<size_t>(kBlock) * kBlock + 2 * kBlock) *
      sizeof(float);
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

__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int rows) {
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    dst[i] = i < rows ? src[i] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_f32(const float* a, const float* b) {
  float acc = 0.f;
  #pragma unroll 8
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int sq, int sk, int q_offset,
                        int k_offset, float scale, int causal) {
  using L = F32DqLayout<D>;
  constexpr int kHalf = D / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + L::tile;
  float* ks = dos + L::tile;
  float* vs = ks + L::tile;
  float* dss = vs + L::tile;  // [64][64]

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q_start = q_tile * kBlock;
  const int q_rows = tile_rows(q_start, sq);
  const size_t qhead = static_cast<size_t>(bh) * sq * D;
  const size_t khead = static_cast<size_t>(bh) * sk * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = warp * kWarpRows + (lane >> 1);
  const int half = lane & 1;
  const int gq = q_offset + q_start + row;

  load_tile_f32<D>(qs, q + qhead + static_cast<size_t>(q_start) * D, q_rows);
  load_tile_f32<D>(dos, dout + qhead + static_cast<size_t>(q_start) * D,
                   q_rows);
  const size_t rows_at = static_cast<size_t>(bh) * sq + q_start;
  const float l = row < q_rows ? lse[rows_at + row] : 0.f;
  const float dl = row < q_rows ? delta[rows_at + row] : 0.f;
  float acc[kHalf];
  #pragma unroll
  for (int c = 0; c < kHalf; ++c) acc[c] = 0.f;
  const float* qr = qs + row * D;
  const float* dr = dos + row * D;
  float* dsrow = dss + row * kBlock;

  const int num_tiles =
      dq_num_tiles(q_offset + q_start, k_offset, sk, causal);
  for (int tile = 0; tile < num_tiles; ++tile) {
    const int k_start = tile * kBlock;
    const int k_rows = tile_rows(k_start, sk);
    __syncthreads();
    load_tile_f32<D>(ks, k + khead + static_cast<size_t>(k_start) * D, k_rows);
    load_tile_f32<D>(vs, v + khead + static_cast<size_t>(k_start) * D, k_rows);
    __syncthreads();
    for (int j = half * (kBlock / 2); j < (half + 1) * (kBlock / 2); ++j) {
      const int kl = k_start + j;
      float p = expf(dot_f32<D>(qr, ks + j * D) * scale - l);
      if (kl >= sk || (causal && gq < k_offset + kl)) p = 0.f;
      dsrow[j] = p * (dot_f32<D>(dr, vs + j * D) - dl);
    }
    __syncwarp();  // the partner lane's half of the row is written
    for (int j = 0; j < kBlock; ++j) {
      const float ds = dsrow[j];
      const float* kr = ks + j * D + half * kHalf;
      #pragma unroll
      for (int c = 0; c < kHalf; ++c) acc[c] = fmaf(ds, kr[c], acc[c]);
    }
    __syncwarp();
  }
  if (row >= q_rows) return;
  float* out = dq + qhead + static_cast<size_t>(q_start + row) * D +
               half * kHalf;
  #pragma unroll
  for (int c = 0; c < kHalf; ++c) out[c] = acc[c] * scale;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int sq, int sk, int q_offset, int k_offset,
                         float scale, int causal) {
  using L = F32DkvLayout<D>;
  constexpr int kHalf = D / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + L::tile;
  float* qs = vs + L::tile;
  float* dos = qs + L::tile;
  float* ps = dos + L::tile;          // P^T [64 keys][64 queries]
  float* dss = ps + kBlock * kBlock;  // dS^T
  float* lse_s = dss + kBlock * kBlock;
  float* dl_s = lse_s + kBlock;

  const int k_tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int k_start = k_tile * kBlock;
  const int k_rows = tile_rows(k_start, sk);
  const size_t qhead = static_cast<size_t>(bh) * sq * D;
  const size_t khead = static_cast<size_t>(bh) * sk * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = warp * kWarpRows + (lane >> 1);  // key row
  const int half = lane & 1;
  const int gk = k_offset + k_start + row;

  load_tile_f32<D>(ks, k + khead + static_cast<size_t>(k_start) * D, k_rows);
  load_tile_f32<D>(vs, v + khead + static_cast<size_t>(k_start) * D, k_rows);
  float dka[kHalf], dva[kHalf];
  #pragma unroll
  for (int c = 0; c < kHalf; ++c) dka[c] = dva[c] = 0.f;
  const float* kr = ks + row * D;
  const float* vr = vs + row * D;
  float* prow = ps + row * kBlock;
  float* dsrow = dss + row * kBlock;

  const int num_q_tiles = (sq + kBlock - 1) / kBlock;
  for (int tile = dkv_first_tile(k_offset + k_start, q_offset, causal);
       tile < num_q_tiles; ++tile) {
    const int q_start = tile * kBlock;
    const int q_rows = tile_rows(q_start, sq);
    __syncthreads();
    load_tile_f32<D>(qs, q + qhead + static_cast<size_t>(q_start) * D,
                     q_rows);
    load_tile_f32<D>(dos, dout + qhead + static_cast<size_t>(q_start) * D,
                     q_rows);
    const size_t rows_at = static_cast<size_t>(bh) * sq + q_start;
    load_rows_f32(lse_s, lse + rows_at, q_rows);
    load_rows_f32(dl_s, delta + rows_at, q_rows);
    __syncthreads();
    for (int c = half * (kBlock / 2); c < (half + 1) * (kBlock / 2); ++c) {
      float p = expf(dot_f32<D>(kr, qs + c * D) * scale - lse_s[c]);
      if (c >= q_rows || (causal && q_offset + q_start + c < gk)) p = 0.f;
      prow[c] = p;
      dsrow[c] = p * (dot_f32<D>(vr, dos + c * D) - dl_s[c]);
    }
    __syncwarp();
    for (int c = 0; c < kBlock; ++c) {
      const float p = prow[c];
      const float ds = dsrow[c];
      const float* dr = dos + c * D + half * kHalf;
      const float* qr = qs + c * D + half * kHalf;
      #pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        dva[d] = fmaf(p, dr[d], dva[d]);
        dka[d] = fmaf(ds, qr[d], dka[d]);
      }
    }
    __syncwarp();
  }
  if (row >= k_rows) return;
  const size_t at = khead + static_cast<size_t>(k_start + row) * D +
                    half * kHalf;
  #pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    dk[at + c] = dka[c] * scale;
    dv[at + c] = dva[c];
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  int bh, sq, sk, q_offset, k_offset, causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq_wgmma(const Args& a, float* dq) {
  static bool configured = false;
  const size_t smem = DqTmaLayout<D>::bytes;
  cudaError_t err =
      configure(flash_bwd_dq_wgmma_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return err;
  EncodeTiled encode = nullptr;
  err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  const void* data[4] = {a.q, a.k, a.v, a.dout};
  const int rows[4] = {a.sq, a.sk, a.sk, a.sq};
  for (int i = 0; i < 4; ++i) {
    err = make_map(encode, &maps[i], data[i], a.bh, rows[i], D, kBlock);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.sq + kBlock - 1) / kBlock, a.bh);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kThreadsB, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, dq, a.sq, a.sk,
      a.q_offset, a.k_offset, a.scale, a.causal);
  return cudaGetLastError();
}

// bf16 head dims 64 and 128 take the wgmma kernel, 16 and 32 the
// mma.sync one; f32 the scalar kernel.
template <int D>
cudaError_t launch_dq(const Args& a, int dtype, float* dq) {
  const dim3 grid((a.sq + kBlock - 1) / kBlock, a.bh);
  if (dtype == 1) {
    if constexpr (D >= 64) {
      return launch_dq_wgmma<D>(a, dq);
    } else {
      static bool configured = false;
      const size_t smem = DqRingLayout<D>::bytes;
      cudaError_t err =
          configure(flash_bwd_dq_ring_kernel<D>, smem, &configured);
      if (err != cudaSuccess) return err;
      flash_bwd_dq_ring_kernel<D><<<grid, kThreads, smem, a.stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
          a.lse, a.delta, dq, a.sq, a.sk, a.q_offset, a.k_offset, a.scale,
          a.causal);
    }
  } else {
    static bool configured = false;
    const size_t smem = F32DqLayout<D>::bytes;
    cudaError_t err = configure(flash_bwd_dq_f32_kernel<D>, smem, &configured);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_f32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, dq, a.sq, a.sk, a.q_offset, a.k_offset, a.scale,
        a.causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const Args& a, float* dk, float* dv) {
  static bool configured = false;
  const size_t smem = DkvTmaLayout<D>::bytes;
  cudaError_t err =
      configure(flash_bwd_dkv_wgmma_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return err;
  EncodeTiled encode = nullptr;
  err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  const void* data[4] = {a.q, a.k, a.v, a.dout};
  const int rows[4] = {a.sq, a.sk, a.sk, a.sq};
  for (int i = 0; i < 4; ++i) {
    err = make_map(encode, &maps[i], data[i], a.bh, rows[i], D, kBlock);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.sk + kBlock - 1) / kBlock, a.bh);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, kThreadsB, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, dk, dv, a.sq,
      a.sk, a.q_offset, a.k_offset, a.scale, a.causal);
  return cudaGetLastError();
}

// bf16 head dims 64 and 128 take the wgmma kernel, 16 and 32 the
// mma.sync one; f32 the scalar kernel.
template <int D>
cudaError_t launch_dkv(const Args& a, int dtype, float* dk, float* dv) {
  const dim3 grid((a.sk + kBlock - 1) / kBlock, a.bh);
  if (dtype == 1) {
    if constexpr (D >= 64) {
      return launch_dkv_wgmma<D>(a, dk, dv);
    } else {
      static bool configured = false;
      const size_t smem = DkvRingLayout<D>::bytes;
      cudaError_t err =
          configure(flash_bwd_dkv_ring_kernel<D>, smem, &configured);
      if (err != cudaSuccess) return err;
      flash_bwd_dkv_ring_kernel<D><<<grid, kThreads, smem, a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.q),
          static_cast<const __nv_bfloat16*>(a.k),
          static_cast<const __nv_bfloat16*>(a.v),
          static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta, dk,
          dv, a.sq, a.sk, a.q_offset, a.k_offset, a.scale, a.causal);
    }
  } else {
    static bool configured = false;
    const size_t smem = F32DkvLayout<D>::bytes;
    cudaError_t err =
        configure(flash_bwd_dkv_f32_kernel<D>, smem, &configured);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, dk, dv, a.sq, a.sk, a.q_offset, a.k_offset, a.scale,
        a.causal);
  }
  return cudaGetLastError();
}

bool valid(int bh, int sq, int sk, int dtype) {
  return bh > 0 && bh <= 65535 && sq > 0 && sk > 0 &&
         (dtype == 0 || dtype == 1);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int bh, int sq, int sk,
               int q_offset, int k_offset, float scale, int causal,
               void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), bh, sq, sk, q_offset,
              k_offset, causal, scale, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout alike); head_dim 16,
// 32, 64 or 128; any sq, sk >= 1. lse and delta are (bh, sq) f32; the
// gradients are f32. Returns a cudaError_t (0 = success).
extern "C" int edl_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
    int head_dim, int dtype, int q_offset, int k_offset, float scale,
    int causal, void* stream) {
  if (!valid(bh, sq, sk, dtype)) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, bh, sq, sk, q_offset,
                           k_offset, scale, causal, stream);
  float* out = static_cast<float*>(dq);
  switch (head_dim) {
    case 16: return launch_dq<16>(a, dtype, out);
    case 32: return launch_dq<32>(a, dtype, out);
    case 64: return launch_dq<64>(a, dtype, out);
    case 128: return launch_dq<128>(a, dtype, out);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int edl_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
    int sk, int head_dim, int dtype, int q_offset, int k_offset, float scale,
    int causal, void* stream) {
  if (!valid(bh, sq, sk, dtype)) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, bh, sq, sk, q_offset,
                           k_offset, scale, causal, stream);
  float* dk_out = static_cast<float*>(dk);
  float* dv_out = static_cast<float*>(dv);
  switch (head_dim) {
    case 16: return launch_dkv<16>(a, dtype, dk_out, dv_out);
    case 32: return launch_dkv<32>(a, dtype, dk_out, dv_out);
    case 64: return launch_dkv<64>(a, dtype, dk_out, dv_out);
    case 128: return launch_dkv<128>(a, dtype, dk_out, dv_out);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
