// In-place embedding row updates for Hopper (sm_90a), bound with ctypes.
//
// Replaces two TPU kernels of elasticdl_tpu/ops/pallas_embedding.py:
//
// - `_inplace_row_update` (kernel #7 of PERF.md's table), the serial row
//   kernels `_sgd_kernel`, `_momentum_kernel`, `_adagrad_kernel`,
//   `_adam_kernel` and `_adam_amsgrad_kernel`: here `row_update_kernel`,
//   one kernel templated on the rule, one warp per unique id;
// - `_fused_row_update` (#8), `_fused_sgd_kernel` and
//   `_fused_momentum_kernel`: here `fused_row_update_kernel`, one block
//   per 8 rows, every load of the 8 rows issued before any row's math.
//
// Contract: ids (n,) int32 are deduplicated; a pad id (>= V, or < 0)
// gets no read and no write, so an optimizer with decaying slots (Adam,
// momentum) leaves a pad's row alone. grads (n, D) f32. The (V, D) f32
// table and its slot tables are updated in place (the TPU kernels alias
// them with input_output_aliases). Adam's bias corrections
// bc1 = 1 - beta1^t and bc2 = 1 - beta2^t come in as two f32 arguments,
// computed by the wrapper on the host in f32 from the host step count.
//
// Rules (per element; s0, s1, s2 are the slots in slot_names order):
//   SGD       t -= lr * g
//   Momentum  v = mu * v + g; t -= lr * (nesterov ? mu * v + g : v)
//   Adagrad   a = a + g * g; t -= lr * g / (sqrt(a) + eps)
//   Adam      m = b1 m + (1-b1) g; v = b2 v + (1-b2) g g;
//             t -= lr * (m / bc1) / (sqrt(v / bc2) + eps)
//   AMSGrad   as Adam, with vmax = max(vmax, v / bc2) in place of v / bc2
// in the JAX kernels' order of operations.
//
// What bounds them on the H100: bytes. Each touched row is read and
// written once with its slots, and its gradient read once: Adagrad at
// 16,384 rows of D 256 moves 5 KB a row, 83.9 MB, ~25 us at 3.35 TB/s;
// SGD 3 KB a row, Momentum 5 KB. A handful of flops an element is
// nothing beside that. The rows are scattered, so what the design must
// do is keep many independent row loads in flight.
//
// Design: `row_update_kernel` gives each id a warp (four a block); lanes
// span D with 16-byte loads when D % 4 == 0 and every pointer is 16-byte
// aligned, 4-byte loads otherwise. The TPU kernel's one-row grid step
// becomes thousands of warps in flight at once. `fused_row_update_kernel`
// is the math of the SGD and momentum rules with the TPU fused kernel's
// schedule: a block takes 8 consecutive ids, its threads span D, and
// each thread issues its columns' loads of all 8 rows (table, velocity,
// gradient) before it updates and stores any of them.
//
// Numerics: nvcc contracts a * b + c into a fused multiply-add (the JAX
// and plain versions round the product first), so an updated value may
// differ from the plain version's in the last bit or two; sqrt and the
// divisions are IEEE (no fast math).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kFusedRows = 8;

enum Rule { kSgd = 0, kMomentum = 1, kAdagrad = 2, kAdam = 3, kAmsgrad = 4 };

struct Hyper {
  float lr, momentum, eps, beta1, beta2, one_minus_beta1, one_minus_beta2;
  float bc1, bc2;
  int nesterov;
};

template <int RULE>
__device__ __forceinline__ void update(float& t, float& s0, float& s1,
                                       float& s2, float g, const Hyper& h) {
  if (RULE == kSgd) {
    t = t - h.lr * g;
  } else if (RULE == kMomentum) {
    const float vel = h.momentum * s0 + g;
    s0 = vel;
    const float step = h.nesterov ? h.momentum * vel + g : vel;
    t = t - h.lr * step;
  } else if (RULE == kAdagrad) {
    const float acc = s0 + g * g;
    s0 = acc;
    t = t - h.lr * g / (sqrtf(acc) + h.eps);
  } else {
    const float m = h.beta1 * s0 + h.one_minus_beta1 * g;
    const float v = h.beta2 * s1 + h.one_minus_beta2 * g * g;
    s0 = m;
    s1 = v;
    const float m_hat = m / h.bc1;
    float v_hat = v / h.bc2;
    if (RULE == kAmsgrad) {
      v_hat = fmaxf(s2, v_hat);
      s2 = v_hat;
    }
    t = t - h.lr * m_hat / (sqrtf(v_hat) + h.eps);
  }
}

__host__ __device__ constexpr int slots_of(int rule) {
  return rule == kSgd ? 0 : rule == kAdam ? 2 : rule == kAmsgrad ? 3 : 1;
}

template <int RULE>
__device__ __forceinline__ void update4(float4& t, float4& s0, float4& s1,
                                        float4& s2, const float4& g,
                                        const Hyper& h) {
  update<RULE>(t.x, s0.x, s1.x, s2.x, g.x, h);
  update<RULE>(t.y, s0.y, s1.y, s2.y, g.y, h);
  update<RULE>(t.z, s0.z, s1.z, s2.z, g.z, h);
  update<RULE>(t.w, s0.w, s1.w, s2.w, g.w, h);
}

template <typename T>
__device__ __forceinline__ T load(const float* p) {
  return *reinterpret_cast<const T*>(p);
}

template <typename T>
__device__ __forceinline__ void store(float* p, const T& x) {
  *reinterpret_cast<T*>(p) = x;
}

template <int RULE, bool VEC>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
row_update_kernel(float* __restrict__ table, float* __restrict__ slot0,
                  float* __restrict__ slot1, float* __restrict__ slot2,
                  const int* __restrict__ ids,
                  const float* __restrict__ grads, int n, int vocab,
                  int dim, Hyper h) {
  constexpr int kSlots = slots_of(RULE);
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const int id = __ldg(ids + i);
  if (id < 0 || id >= vocab) return;   // a pad: no read, no write
  const size_t row = static_cast<size_t>(id) * dim;
  const float* g_row = grads + static_cast<size_t>(i) * dim;
  if (VEC) {
    for (int c = lane * 4; c < dim; c += 128) {
      float4 t = load<float4>(table + row + c);
      const float4 g = __ldg(reinterpret_cast<const float4*>(g_row + c));
      float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0, s2 = s0;
      if (kSlots > 0) s0 = load<float4>(slot0 + row + c);
      if (kSlots > 1) s1 = load<float4>(slot1 + row + c);
      if (kSlots > 2) s2 = load<float4>(slot2 + row + c);
      update4<RULE>(t, s0, s1, s2, g, h);
      store(table + row + c, t);
      if (kSlots > 0) store(slot0 + row + c, s0);
      if (kSlots > 1) store(slot1 + row + c, s1);
      if (kSlots > 2) store(slot2 + row + c, s2);
    }
  } else {
    for (int c = lane; c < dim; c += 32) {
      float t = table[row + c];
      const float g = __ldg(g_row + c);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      if (kSlots > 0) s0 = slot0[row + c];
      if (kSlots > 1) s1 = slot1[row + c];
      if (kSlots > 2) s2 = slot2[row + c];
      update<RULE>(t, s0, s1, s2, g, h);
      table[row + c] = t;
      if (kSlots > 0) slot0[row + c] = s0;
      if (kSlots > 1) slot1[row + c] = s1;
      if (kSlots > 2) slot2[row + c] = s2;
    }
  }
}

// One row's columns under SGD or momentum (v: the velocity; unused by
// SGD).
template <int RULE>
__device__ __forceinline__ void apply_rule(float& t, float& v, float g,
                                           const Hyper& h) {
  float s1 = 0.f, s2 = 0.f;
  update<RULE>(t, v, s1, s2, g, h);
}

template <int RULE>
__device__ __forceinline__ void apply_rule(float4& t, float4& v,
                                           const float4& g, const Hyper& h) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  update4<RULE>(t, v, s, s, g, h);
}

// SGD (kSgd) or momentum (kMomentum): 8 rows a block. Vec is float4
// (16-byte loads) or float.
template <int RULE, typename Vec>
__global__ void fused_row_update_kernel(float* __restrict__ table,
                                        float* __restrict__ velocity,
                                        const int* __restrict__ ids,
                                        const float* __restrict__ grads,
                                        int n, int vocab, int dim, Hyper h) {
  constexpr bool kVel = RULE == kMomentum;
  constexpr int kWidth = sizeof(Vec) / sizeof(float);
  const int first = blockIdx.x * kFusedRows;
  size_t row[kFusedRows];
  bool live[kFusedRows];
#pragma unroll
  for (int k = 0; k < kFusedRows; ++k) {
    const int id = first + k < n ? __ldg(ids + first + k) : -1;
    live[k] = id >= 0 && id < vocab;     // pads and rows past n: skipped
    row[k] = static_cast<size_t>(live[k] ? id : 0) * dim;
  }
  for (int c = threadIdx.x * kWidth; c < dim; c += blockDim.x * kWidth) {
    Vec t[kFusedRows], v[kFusedRows] = {}, g[kFusedRows];
#pragma unroll
    for (int k = 0; k < kFusedRows; ++k) {   // every load first ...
      if (live[k]) {
        t[k] = load<Vec>(table + row[k] + c);
        g[k] = load<Vec>(grads + static_cast<size_t>(first + k) * dim + c);
        if (kVel) v[k] = load<Vec>(velocity + row[k] + c);
      }
    }
#pragma unroll
    for (int k = 0; k < kFusedRows; ++k) {   // ... then each row's math
      if (live[k]) {
        apply_rule<RULE>(t[k], v[k], g[k], h);
        store(table + row[k] + c, t[k]);
        if (kVel) store(velocity + row[k] + c, v[k]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int RULE>
cudaError_t launch_rows(bool vec, float* table, float* s0, float* s1,
                        float* s2, const int* ids, const float* grads, int n,
                        int vocab, int dim, const Hyper& h,
                        cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (vec)
    row_update_kernel<RULE, true><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
        table, s0, s1, s2, ids, grads, n, vocab, dim, h);
  else
    row_update_kernel<RULE, false><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
        table, s0, s1, s2, ids, grads, n, vocab, dim, h);
  return cudaGetLastError();
}

template <int RULE>
cudaError_t launch_fused(bool vec, float* table, float* velocity,
                         const int* ids, const float* grads, int n,
                         int vocab, int dim, const Hyper& h,
                         cudaStream_t stream) {
  const int blocks = (n + kFusedRows - 1) / kFusedRows;
  const int lanes = vec ? (dim + 3) / 4 : dim;       // threads to span D
  int threads = (lanes + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > 256 ? 256 : threads;
  if (vec)
    fused_row_update_kernel<RULE, float4><<<blocks, threads, 0, stream>>>(
        table, velocity, ids, grads, n, vocab, dim, h);
  else
    fused_row_update_kernel<RULE, float><<<blocks, threads, 0, stream>>>(
        table, velocity, ids, grads, n, vocab, dim, h);
  return cudaGetLastError();
}

Hyper make_hyper(float lr, float momentum, int nesterov, float eps,
                 float beta1, float beta2, float one_minus_beta1,
                 float one_minus_beta2, float bc1, float bc2) {
  Hyper h;
  h.lr = lr;
  h.momentum = momentum;
  h.nesterov = nesterov;
  h.eps = eps;
  h.beta1 = beta1;
  h.beta2 = beta2;
  h.one_minus_beta1 = one_minus_beta1;
  h.one_minus_beta2 = one_minus_beta2;
  h.bc1 = bc1;
  h.bc2 = bc2;
  return h;
}

}  // namespace

// rule: 0 SGD, 1 momentum, 2 Adagrad, 3 Adam, 4 AMSGrad; slot0..2 in the
// optimizer's slot_names order (null where the rule has fewer slots).
// Returns a cudaError_t (0 = launched). n == 0 launches nothing.
extern "C" int edl_row_update(int rule, void* table, void* slot0,
                              void* slot1, void* slot2, const void* ids,
                              const void* grads, int n, int vocab, int dim,
                              float lr, float momentum, int nesterov,
                              float eps, float beta1, float beta2,
                              float one_minus_beta1, float one_minus_beta2,
                              float bc1, float bc2, void* stream) {
  if (n < 0 || vocab <= 0 || dim <= 0 || rule < kSgd || rule > kAmsgrad)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Hyper h = make_hyper(lr, momentum, nesterov, eps, beta1, beta2,
                             one_minus_beta1, one_minus_beta2, bc1, bc2);
  const bool vec = dim % 4 == 0 && aligned16(table) && aligned16(slot0) &&
                   aligned16(slot1) && aligned16(slot2) && aligned16(grads);
  auto t = static_cast<float*>(table);
  auto s0 = static_cast<float*>(slot0);
  auto s1 = static_cast<float*>(slot1);
  auto s2 = static_cast<float*>(slot2);
  auto i = static_cast<const int*>(ids);
  auto g = static_cast<const float*>(grads);
  auto s = static_cast<cudaStream_t>(stream);
  switch (rule) {
    case kSgd: return launch_rows<kSgd>(vec, t, s0, s1, s2, i, g, n, vocab, dim, h, s);
    case kMomentum: return launch_rows<kMomentum>(vec, t, s0, s1, s2, i, g, n, vocab, dim, h, s);
    case kAdagrad: return launch_rows<kAdagrad>(vec, t, s0, s1, s2, i, g, n, vocab, dim, h, s);
    case kAdam: return launch_rows<kAdam>(vec, t, s0, s1, s2, i, g, n, vocab, dim, h, s);
    default: return launch_rows<kAmsgrad>(vec, t, s0, s1, s2, i, g, n, vocab, dim, h, s);
  }
}

// rule: 0 SGD (velocity null) or 1 momentum.
extern "C" int edl_fused_row_update(int rule, void* table, void* velocity,
                                    const void* ids, const void* grads,
                                    int n, int vocab, int dim, float lr,
                                    float momentum, int nesterov,
                                    void* stream) {
  if (n < 0 || vocab <= 0 || dim <= 0 || (rule != kSgd && rule != kMomentum))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Hyper h = make_hyper(lr, momentum, nesterov, 0.f, 0.f, 0.f, 0.f, 0.f,
                             1.f, 1.f);
  const bool vec = dim % 4 == 0 && aligned16(table) && aligned16(velocity) &&
                   aligned16(grads);
  auto t = static_cast<float*>(table);
  auto v = static_cast<float*>(velocity);
  auto i = static_cast<const int*>(ids);
  auto g = static_cast<const float*>(grads);
  auto s = static_cast<cudaStream_t>(stream);
  return rule == kSgd
             ? launch_fused<kSgd>(vec, t, v, i, g, n, vocab, dim, h, s)
             : launch_fused<kMomentum>(vec, t, v, i, g, n, vocab, dim, h, s);
}

extern "C" const char* edl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
