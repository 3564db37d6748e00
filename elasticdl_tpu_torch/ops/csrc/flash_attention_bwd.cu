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
// Both are memory bound, barely: the products must run on the tensor
// cores and the (S x S) probabilities must never reach device memory.
//
// Design (bf16). The TPU grids' sequential axes become loops inside a
// block. dq: one block per (bh, 64-row q tile) loops over the K/V tiles
// that the causal mask leaves reachable (heaviest q tiles first). dk/dv:
// one block per (bh, 64-row k tile) loops over the q tiles at or below
// the diagonal. Four warps own 16 rows each and run every product with
// mma.sync m16n8k16 (bf16 in, f32 accumulate), as the forward kernel
// does. Because lse is known, a probability needs no row max: keys (dq)
// or queries (dk/dv) are taken 16 at a time, so a warp holds only a
// 16 x 16 piece of S and of dP; its accumulator fragment is repacked in
// registers as the A operand of the next product (dS K for dq; P^T dO
// and dS^T Q for dk/dv, where computing S^T = K Q^T puts P^T and dS^T in
// that layout directly). Tiles sit in shared memory with rows padded by
// 16 bytes (no bank conflicts on fragment loads).
//
// Registers (D 128): dq keeps the Q and dO A fragments (32 + 32) and the
// dq accumulator (64) in registers; dk/dv keeps both accumulators
// (64 + 64) and reloads the K and V A fragments from shared memory for
// each 16-query piece, which keeps it clear of the 255-register cap.
// Both bf16 kernels are built for two blocks per SM: ptxas gives each
// 210 registers a thread at D 128 with no spills (128 and 178 at D 64),
// and a block takes 70,144 bytes of shared memory, so two blocks share
// an SM. ptxas -v prints the counts at every build.
// Not yet done: wgmma, TMA or cp.async pipelining of the streamed tiles.
//
// Any Sq and Sk: rows past the end of a ragged last tile load as zeros,
// keys past Sk (dq) and queries past Sq (dk/dv) are masked like keys
// above the diagonal, and rows past the end are not stored.
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

namespace {

constexpr int kBlock = 64;              // rows per block, rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = kBlock / kWarps;  // 16
constexpr int kBf16BlocksPerSm = 2;

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

// ---- bf16: tensor-core fragments in registers ------------------------

template <int D>
struct Bf16Tiles {
  static constexpr int ld = D + 8;  // padded row stride (elements)
  static constexpr size_t tile = static_cast<size_t>(kBlock) * ld;
  static constexpr size_t bytes =
      4 * tile * sizeof(__nv_bfloat16) + 2 * kBlock * sizeof(float);
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_raw(const __nv_bfloat16* lo,
                                             const __nv_bfloat16* hi) {
  const uint32_t l = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t h = *reinterpret_cast<const uint16_t*>(hi);
  return l | (h << 16);
}

// A fragment (16 rows x 16 columns at `base`, row stride ld).
template <int ld>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* base) {
  a[0] = load_u32(base);
  a[1] = load_u32(base + 8 * ld);
  a[2] = load_u32(base + 8);
  a[3] = load_u32(base + 8 * ld + 8);
}

// Copies the first `rows` rows of a contiguous 64 x D global tile into
// padded shared rows; rows past the end are zeroed.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      chunk = *reinterpret_cast<const uint4*>(src + r * D + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * Bf16Tiles<D>::ld + c * 8) = chunk;
  }
}

__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int rows) {
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    dst[i] = i < rows ? src[i] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, kBf16BlocksPerSm)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int sq, int sk,
                         int q_offset, int k_offset, float scale,
                         int causal) {
  using T = Bf16Tiles<D>;
  constexpr int ld = T::ld;
  constexpr int kSteps = D / 16;     // k-steps over D
  constexpr int kOutBlocks = D / 8;  // n-blocks of dS K
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + T::tile;
  __nv_bfloat16* ks = dos + T::tile;
  __nv_bfloat16* vs = ks + T::tile;

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int bh = blockIdx.y;
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

  load_tile_bf16<D>(qs, q + qhead + static_cast<size_t>(q_start) * D, q_rows);
  load_tile_bf16<D>(dos, dout + qhead + static_cast<size_t>(q_start) * D,
                    q_rows);
  __syncthreads();
  uint32_t qa[kSteps][4], da[kSteps][4];
  #pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    load_a<ld>(qa[kk], qs + row0 * ld + kk * 16 + 2 * t);
    load_a<ld>(da[kk], dos + row0 * ld + kk * 16 + 2 * t);
  }
  const float* lrow = lse + static_cast<size_t>(bh) * sq + q_start;
  const float* drow = delta + static_cast<size_t>(bh) * sq + q_start;
  const float lse0 = row0 < q_rows ? lrow[row0] : 0.f;
  const float lse1 = row0 + 8 < q_rows ? lrow[row0 + 8] : 0.f;
  const float dl0 = row0 < q_rows ? drow[row0] : 0.f;
  const float dl1 = row0 + 8 < q_rows ? drow[row0 + 8] : 0.f;

  float acc[kOutBlocks][4];
  #pragma unroll
  for (int nb = 0; nb < kOutBlocks; ++nb) {
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  }

  const int num_tiles =
      dq_num_tiles(q_offset + q_start, k_offset, sk, causal);
  for (int tile = 0; tile < num_tiles; ++tile) {
    const int k_start = tile * kBlock;
    const int k_rows = tile_rows(k_start, sk);
    // Only tiles that cross the diagonal or end ragged hold masked keys.
    const bool masked_tile =
        (causal && k_offset + k_start + kBlock - 1 > q_offset + q_start) ||
        k_rows < kBlock;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D>(ks, k + khead + static_cast<size_t>(k_start) * D,
                      k_rows);
    load_tile_bf16<D>(vs, v + khead + static_cast<size_t>(k_start) * D,
                      k_rows);
    __syncthreads();

    #pragma unroll 1
    for (int kc = 0; kc < kBlock / 16; ++kc) {
      // S and dP for 16 rows x 16 keys: two n-blocks of 8 keys.
      float s[2][4], dp[2][4];
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
        dp[h][0] = dp[h][1] = dp[h][2] = dp[h][3] = 0.f;
        const int key = kc * 16 + h * 8 + g;
        const __nv_bfloat16* kr = ks + key * ld + 2 * t;
        const __nv_bfloat16* vr = vs + key * ld + 2 * t;
        #pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          mma_bf16(s[h], qa[kk], load_u32(kr + kk * 16),
                   load_u32(kr + kk * 16 + 8));
          mma_bf16(dp[h], da[kk], load_u32(vr + kk * 16),
                   load_u32(vr + kk * 16 + 8));
        }
      }
      // dS = P o (dP - delta), P = exp(S * scale - lse).
      float ds[2][4];
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kl = k_start + kc * 16 + h * 8 + 2 * t + (i & 1);
          const bool hi = i >= 2;
          float p = expf(s[h][i] * scale - (hi ? lse1 : lse0));
          if (masked_tile &&
              (kl >= sk || (causal && (hi ? gq1 : gq0) < k_offset + kl))) {
            p = 0.f;
          }
          ds[h][i] = p * (dp[h][i] - (hi ? dl1 : dl0));
        }
      }
      // dq += dS (in k's dtype) K: dS's accumulators are the A fragment.
      const uint32_t dsa[4] = {
          pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
          pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3]),
      };
      const __nv_bfloat16* kr = ks + (kc * 16 + 2 * t) * ld + g;
      #pragma unroll
      for (int nb = 0; nb < kOutBlocks; ++nb) {
        const __nv_bfloat16* col = kr + nb * 8;
        mma_bf16(acc[nb], dsa, pack_raw(col, col + ld),
                 pack_raw(col + 8 * ld, col + 9 * ld));
      }
    }
  }

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

template <int D>
__global__ void __launch_bounds__(kThreads, kBf16BlocksPerSm)
flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int sq, int sk, int q_offset, int k_offset,
                          float scale, int causal) {
  using T = Bf16Tiles<D>;
  constexpr int ld = T::ld;
  constexpr int kSteps = D / 16;
  constexpr int kOutBlocks = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + T::tile;
  __nv_bfloat16* qs = vs + T::tile;
  __nv_bfloat16* dos = qs + T::tile;
  float* lse_s = reinterpret_cast<float*>(dos + T::tile);
  float* dl_s = lse_s + kBlock;

  const int k_tile = blockIdx.x;  // causal: the first k tiles are heaviest
  const int bh = blockIdx.y;
  const int k_start = k_tile * kBlock;
  const int k_rows = tile_rows(k_start, sk);
  const size_t qhead = static_cast<size_t>(bh) * sq * D;
  const size_t khead = static_cast<size_t>(bh) * sk * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = warp * kWarpRows + g;  // this lane's key rows
  const int gk0 = k_offset + k_start + row0;
  const int gk1 = gk0 + 8;

  load_tile_bf16<D>(ks, k + khead + static_cast<size_t>(k_start) * D, k_rows);
  load_tile_bf16<D>(vs, v + khead + static_cast<size_t>(k_start) * D, k_rows);

  float dka[kOutBlocks][4], dva[kOutBlocks][4];
  #pragma unroll
  for (int nb = 0; nb < kOutBlocks; ++nb) {
    dka[nb][0] = dka[nb][1] = dka[nb][2] = dka[nb][3] = 0.f;
    dva[nb][0] = dva[nb][1] = dva[nb][2] = dva[nb][3] = 0.f;
  }

  const int num_q_tiles = (sq + kBlock - 1) / kBlock;
  for (int tile = dkv_first_tile(k_offset + k_start, q_offset, causal);
       tile < num_q_tiles; ++tile) {
    const int q_start = tile * kBlock;
    const int q_rows = tile_rows(q_start, sq);
    const bool masked_tile =
        (causal && q_offset + q_start < k_offset + k_start + kBlock - 1) ||
        q_rows < kBlock;
    __syncthreads();  // every warp is done with the previous q tile
    load_tile_bf16<D>(qs, q + qhead + static_cast<size_t>(q_start) * D,
                      q_rows);
    load_tile_bf16<D>(dos, dout + qhead + static_cast<size_t>(q_start) * D,
                      q_rows);
    const size_t rows_at = static_cast<size_t>(bh) * sq + q_start;
    load_rows_f32(lse_s, lse + rows_at, q_rows);
    load_rows_f32(dl_s, delta + rows_at, q_rows);
    __syncthreads();

    #pragma unroll 1
    for (int qc = 0; qc < kBlock / 16; ++qc) {
      // S^T = K Q^T and dP^T = V dO^T for 16 keys x 16 queries.
      float st[2][4], dpt[2][4];
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        st[h][0] = st[h][1] = st[h][2] = st[h][3] = 0.f;
        dpt[h][0] = dpt[h][1] = dpt[h][2] = dpt[h][3] = 0.f;
      }
      #pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t ka[4], va[4];
        load_a<ld>(ka, ks + row0 * ld + kk * 16 + 2 * t);
        load_a<ld>(va, vs + row0 * ld + kk * 16 + 2 * t);
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int query = qc * 16 + h * 8 + g;
          const __nv_bfloat16* qr = qs + query * ld + kk * 16 + 2 * t;
          const __nv_bfloat16* dr = dos + query * ld + kk * 16 + 2 * t;
          mma_bf16(st[h], ka, load_u32(qr), load_u32(qr + 8));
          mma_bf16(dpt[h], va, load_u32(dr), load_u32(dr + 8));
        }
      }
      // P^T and dS^T = P^T o (dP^T - delta[col]).
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = qc * 16 + h * 8 + 2 * t + (i & 1);  // query in tile
          const bool hi = i >= 2;
          float p = expf(st[h][i] * scale - lse_s[c]);
          if (masked_tile &&
              (c >= q_rows ||
               (causal && q_offset + q_start + c < (hi ? gk1 : gk0)))) {
            p = 0.f;
          }
          dpt[h][i] = p * (dpt[h][i] - dl_s[c]);
          st[h][i] = p;
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
      // dV += P^T dO and dK += dS^T Q over these 16 queries.
      const __nv_bfloat16* dr = dos + (qc * 16 + 2 * t) * ld + g;
      const __nv_bfloat16* qr = qs + (qc * 16 + 2 * t) * ld + g;
      #pragma unroll
      for (int nb = 0; nb < kOutBlocks; ++nb) {
        const __nv_bfloat16* dcol = dr + nb * 8;
        mma_bf16(dva[nb], pa, pack_raw(dcol, dcol + ld),
                 pack_raw(dcol + 8 * ld, dcol + 9 * ld));
        const __nv_bfloat16* qcol = qr + nb * 8;
        mma_bf16(dka[nb], dsa, pack_raw(qcol, qcol + ld),
                 pack_raw(qcol + 8 * ld, qcol + 9 * ld));
      }
    }
  }

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
cudaError_t launch_dq(const Args& a, int dtype, float* dq) {
  const dim3 grid((a.sq + kBlock - 1) / kBlock, a.bh);
  if (dtype == 1) {
    static bool configured = false;
    const size_t smem = Bf16Tiles<D>::bytes;
    cudaError_t err =
        configure(flash_bwd_dq_bf16_kernel<D>, smem, &configured);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta, dq, a.sq,
        a.sk, a.q_offset, a.k_offset, a.scale, a.causal);
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
cudaError_t launch_dkv(const Args& a, int dtype, float* dk, float* dv) {
  const dim3 grid((a.sk + kBlock - 1) / kBlock, a.bh);
  if (dtype == 1) {
    static bool configured = false;
    const size_t smem = Bf16Tiles<D>::bytes;
    cudaError_t err =
        configure(flash_bwd_dkv_bf16_kernel<D>, smem, &configured);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_bf16_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta, dk, dv,
        a.sq, a.sk, a.q_offset, a.k_offset, a.scale, a.causal);
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
