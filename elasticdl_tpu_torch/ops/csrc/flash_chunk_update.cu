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
// owns its query rows, and every lane reads its carry before the tile
// loop and writes it after. Nothing is normalised: the caller divides by
// max(l, 1e-30) after the last chunk.
//
// What bounds it on the H100: at the ring's local block (BH 4, Sq = Sk =
// 2048, D 128, bf16) a past chunk must move q, k, v (2.1 MB each) and the
// f32 carry in and out (8.4 MB), ~14.8 MB or 4.4 us at 3.35 TB/s, and
// do 8.6 GFLOP, 8.7 us at 989 TFLOP/s: compute bound on paper, a
// diagonal chunk half that. The score tile must never reach device
// memory.
//
// Design: the forward kernel's (flash_attention_fwd.cu) tile loop with a
// carry in and out, kept in its own file so the forward's build and
// register budget do not move. One block per (bh, 64-row q tile); the
// Pallas grid's sequential k axis is a loop inside the block over the
// chunk's 64-key tiles. bf16: 4 warps of 16 rows, both products on the
// tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate), scores,
// probabilities and the accumulator in registers (the S accumulator
// fragment is PV's A operand, packed to bf16 in place), Q/K/V tiles in
// shared memory with rows padded by 16 bytes. The carry loads straight
// into the fragments. Tiles wholly above the causal diagonal
// (q_start + 63 < k_start, global positions) are skipped, and so are all
// later ones; only a tile that crosses the diagonal or is ragged pays for
// the mask. At the ring's block the grid is 32 x BH blocks, about one a
// SM: not yet done are splitting the keys over more blocks, a K/V
// pipeline (cp.async/TMA) and wgmma, which are what close the gap to the
// bound.
//
// Any Sq and Sk: ragged last q and K/V tiles are loaded with zero rows;
// keys past Sk are masked, q rows past Sq are neither read nor stored.
// Head dims 16, 32, 64 and 128 are template instances. f32 inputs take a
// scalar kernel with the same tiling (scores and accumulator in shared
// memory, two lanes per row).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

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
cudaError_t launch(const Args& a, int dtype, cudaStream_t stream) {
  return dtype == 1 ? launch_bf16<D>(a, stream) : launch_f32<D>(a, stream);
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
