// Host-tier embedding row store: C++ hot path.
//
// Counterpart of the reference's native state plane: the Go PS row map
// (elasticdl/pkg/common/embedding_table.go) plus the C++/Eigen fused
// optimizer kernels (elasticdl/pkg/kernel/capi/kernel_api.cc). The Python
// GIL serializes per-row dict work exactly like it serialized the
// reference's Python PS (docs/designs/high_performance_ps.md) — so the
// row map, lazy init, and row-granular optimizer updates live here, with
// a ctypes binding (no pybind11 in the image).
//
// Layout: open-addressed id->index map + one contiguous float arena
// (dim-strided rows) — pointer-stable, cache-friendly sequential
// updates, O(1) amortized insert. Rows can be erased (tiered-store
// eviction, storage/tiered.py): the slot goes on a free list and is
// reused by the next materialization, so the arena's high-water mark
// is bounded by the hot-tier budget, not by every id ever touched.
//
// Build: g++ -O3 -shared -fPIC (see native/__init__.py; no external deps).

#include <cstdint>
#include <climits>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

// splitmix64: deterministic per-(seed, id, col) init hash.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

static inline float unit_uniform(uint64_t h) {
  // 24 high bits -> [0, 1)
  return static_cast<float>(h >> 40) * (1.0f / 16777216.0f);
}

// Empty-slot sentinel must be a value no caller can use as an id;
// INT64_MIN (not -1) keeps negative ids (signed feature hashes) valid.
constexpr int64_t kEmptyKey = INT64_MIN;

struct IdMap {
  // Open addressing, power-of-two capacity, empty slot = kEmptyKey.
  std::vector<int64_t> keys;
  std::vector<int64_t> vals;
  size_t count = 0;

  IdMap() : keys(1024, kEmptyKey), vals(1024, 0) {}

  void grow() {
    std::vector<int64_t> old_keys = std::move(keys);
    std::vector<int64_t> old_vals = std::move(vals);
    size_t cap = old_keys.size() * 2;
    keys.assign(cap, kEmptyKey);
    vals.assign(cap, 0);
    for (size_t i = 0; i < old_keys.size(); ++i) {
      if (old_keys[i] != kEmptyKey) insert_nogrow(old_keys[i], old_vals[i]);
    }
  }

  void insert_nogrow(int64_t key, int64_t val) {
    size_t mask = keys.size() - 1;
    size_t slot = splitmix64(static_cast<uint64_t>(key)) & mask;
    while (keys[slot] != kEmptyKey) slot = (slot + 1) & mask;
    keys[slot] = key;
    vals[slot] = val;
  }

  // Returns row index, or -1 if absent.
  int64_t find(int64_t key) const {
    size_t mask = keys.size() - 1;
    size_t slot = splitmix64(static_cast<uint64_t>(key)) & mask;
    while (keys[slot] != kEmptyKey) {
      if (keys[slot] == key) return vals[slot];
      slot = (slot + 1) & mask;
    }
    return -1;
  }

  void insert(int64_t key, int64_t val) {
    if ((count + 1) * 10 >= keys.size() * 7) grow();  // 0.7 load factor
    insert_nogrow(key, val);
    ++count;
  }

  // Backward-shift deletion (linear probing, no tombstones): walk the
  // probe chain past the hole and pull back any entry whose probe
  // distance spans the hole, so find() never meets a false empty slot.
  bool erase(int64_t key) {
    size_t mask = keys.size() - 1;
    size_t slot = splitmix64(static_cast<uint64_t>(key)) & mask;
    while (keys[slot] != key) {
      if (keys[slot] == kEmptyKey) return false;
      slot = (slot + 1) & mask;
    }
    size_t hole = slot;
    size_t next = (hole + 1) & mask;
    while (keys[next] != kEmptyKey) {
      size_t ideal = splitmix64(static_cast<uint64_t>(keys[next])) & mask;
      if (((next - ideal) & mask) >= ((next - hole) & mask)) {
        keys[hole] = keys[next];
        vals[hole] = vals[next];
        hole = next;
      }
      next = (next + 1) & mask;
    }
    keys[hole] = kEmptyKey;
    --count;
    return true;
  }
};

struct RowStore {
  int64_t dim;
  uint32_t seed;
  int init_mode;      // 0 = uniform(-scale, scale), 1 = constant
  float init_scale;   // uniform half-range
  float const_value;  // constant init value (slot tables)
  IdMap map;
  std::vector<float> arena;
  // slot -> owning id (kEmptyKey when the slot is on the free list);
  // doubles as export order for live slots.
  std::vector<int64_t> slot_ids;
  std::vector<int64_t> free_slots;  // erased arena slots, reused LIFO
  // Monotonic count of row materializations. The Python dirty-tracking
  // heuristic compares this across a get(): num_rows (live count) is
  // NOT a safe proxy once erase exists — a get that re-materializes an
  // evicted row into a reused slot leaves the arena size unchanged.
  int64_t created = 0;

  float* row_ptr(int64_t idx) { return arena.data() + idx * dim; }

  // Lazy init on first touch (reference
  // pkg/common/embedding_table.go:36-44, ps/embedding_table.py:51-62).
  int64_t get_or_create(int64_t id) {
    int64_t idx = map.find(id);
    if (idx >= 0) return idx;
    if (!free_slots.empty()) {
      idx = free_slots.back();
      free_slots.pop_back();
      slot_ids[idx] = id;
    } else {
      idx = static_cast<int64_t>(slot_ids.size());
      arena.resize(arena.size() + dim);
      slot_ids.push_back(id);
    }
    float* r = row_ptr(idx);
    if (init_mode == 1) {
      for (int64_t c = 0; c < dim; ++c) r[c] = const_value;
    } else {
      uint64_t base = (static_cast<uint64_t>(seed) << 32) ^
                      static_cast<uint64_t>(id);
      for (int64_t c = 0; c < dim; ++c) {
        float u = unit_uniform(
            splitmix64(base + 0x9E3779B97F4A7C15ULL * (c + 1)));
        r[c] = (2.0f * u - 1.0f) * init_scale;
      }
    }
    map.insert(id, idx);
    ++created;
    return idx;
  }
};

}  // namespace

extern "C" {

void* rs_create(int64_t dim, uint32_t seed, int init_mode, float init_scale,
                float const_value) {
  RowStore* s = new RowStore();
  s->dim = dim;
  s->seed = seed;
  s->init_mode = init_mode;
  s->init_scale = init_scale;
  s->const_value = const_value;
  return s;
}

void rs_destroy(void* p) { delete static_cast<RowStore*>(p); }

int64_t rs_num_rows(void* p) {
  // LIVE rows (erased slots excluded), not arena high-water.
  return static_cast<int64_t>(static_cast<RowStore*>(p)->map.count);
}

int64_t rs_created_count(void* p) {
  return static_cast<RowStore*>(p)->created;
}

// Erase rows (tier demotion). Absent ids are ignored; returns how many
// were actually erased. Slots go on the free list for reuse.
int64_t rs_erase(void* p, const int64_t* ids, int64_t n) {
  RowStore* s = static_cast<RowStore*>(p);
  int64_t erased = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t idx = s->map.find(ids[i]);
    if (idx < 0) continue;
    s->map.erase(ids[i]);
    s->slot_ids[idx] = kEmptyKey;
    s->free_slots.push_back(idx);
    ++erased;
  }
  return erased;
}

// Membership without materialization: out[i] = 1 iff ids[i] is live.
void rs_contains(void* p, const int64_t* ids, int64_t n, uint8_t* out) {
  RowStore* s = static_cast<RowStore*>(p);
  for (int64_t i = 0; i < n; ++i) out[i] = s->map.find(ids[i]) >= 0;
}

int64_t rs_dim(void* p) { return static_cast<RowStore*>(p)->dim; }

void rs_get(void* p, const int64_t* ids, int64_t n, float* out) {
  RowStore* s = static_cast<RowStore*>(p);
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out + i * s->dim, s->row_ptr(s->get_or_create(ids[i])),
                sizeof(float) * s->dim);
  }
}

void rs_set(void* p, const int64_t* ids, int64_t n, const float* values) {
  RowStore* s = static_cast<RowStore*>(p);
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(s->row_ptr(s->get_or_create(ids[i])), values + i * s->dim,
                sizeof(float) * s->dim);
  }
}

// Export live rows in slot order (erased slots skipped):
// ids_out[num_rows], rows_out[num_rows*dim].
void rs_export(void* p, int64_t* ids_out, float* rows_out) {
  RowStore* s = static_cast<RowStore*>(p);
  int64_t out = 0;
  for (size_t slot = 0; slot < s->slot_ids.size(); ++slot) {
    if (s->slot_ids[slot] == kEmptyKey) continue;
    ids_out[out] = s->slot_ids[slot];
    std::memcpy(rows_out + out * s->dim,
                s->row_ptr(static_cast<int64_t>(slot)),
                sizeof(float) * s->dim);
    ++out;
  }
}

// ---- fused row optimizers (reference kernel_api.cc, vectorized by the
// compiler; sparse variants do row-map lookup + update in one pass,
// unlike the reference's per-row cgo round trips, kernel.go:25-29) ----

void rs_sgd(void* p, const int64_t* ids, int64_t n, const float* grads,
            float lr) {
  RowStore* s = static_cast<RowStore*>(p);
  const int64_t dim = s->dim;
  for (int64_t i = 0; i < n; ++i) {
    float* w = s->row_ptr(s->get_or_create(ids[i]));
    const float* g = grads + i * dim;
    for (int64_t c = 0; c < dim; ++c) w[c] -= lr * g[c];
  }
}

void rs_momentum(void* p, void* vel_p, const int64_t* ids, int64_t n,
                 const float* grads, float lr, float momentum, int nesterov) {
  RowStore* s = static_cast<RowStore*>(p);
  RowStore* vs = static_cast<RowStore*>(vel_p);
  const int64_t dim = s->dim;
  for (int64_t i = 0; i < n; ++i) {
    float* w = s->row_ptr(s->get_or_create(ids[i]));
    float* v = vs->row_ptr(vs->get_or_create(ids[i]));
    const float* g = grads + i * dim;
    for (int64_t c = 0; c < dim; ++c) {
      v[c] = momentum * v[c] + g[c];
      w[c] -= lr * (nesterov ? momentum * v[c] + g[c] : v[c]);
    }
  }
}

void rs_adagrad(void* p, void* accum_p, const int64_t* ids, int64_t n,
                const float* grads, float lr, float epsilon) {
  RowStore* s = static_cast<RowStore*>(p);
  RowStore* as = static_cast<RowStore*>(accum_p);
  const int64_t dim = s->dim;
  for (int64_t i = 0; i < n; ++i) {
    float* w = s->row_ptr(s->get_or_create(ids[i]));
    float* a = as->row_ptr(as->get_or_create(ids[i]));
    const float* g = grads + i * dim;
    for (int64_t c = 0; c < dim; ++c) {
      a[c] += g[c] * g[c];
      w[c] -= lr * g[c] / (std::sqrt(a[c]) + epsilon);
    }
  }
}

// Bias-corrected Adam with optional amsgrad (max_p may be null), matching
// embedding/optimizer.py Adam.apply_rows and reference kernel_api.cc:40-77.
void rs_adam(void* p, void* m_p, void* v_p, void* max_p, const int64_t* ids,
             int64_t n, const float* grads, float lr, float beta1,
             float beta2, float epsilon, int64_t step) {
  RowStore* s = static_cast<RowStore*>(p);
  RowStore* ms = static_cast<RowStore*>(m_p);
  RowStore* vs = static_cast<RowStore*>(v_p);
  RowStore* xs = static_cast<RowStore*>(max_p);  // nullable
  const int64_t dim = s->dim;
  const float bc1 = 1.0f - std::pow(beta1, static_cast<float>(step));
  const float bc2 = 1.0f - std::pow(beta2, static_cast<float>(step));
  for (int64_t i = 0; i < n; ++i) {
    float* w = s->row_ptr(s->get_or_create(ids[i]));
    float* m = ms->row_ptr(ms->get_or_create(ids[i]));
    float* v = vs->row_ptr(vs->get_or_create(ids[i]));
    float* x = xs ? xs->row_ptr(xs->get_or_create(ids[i])) : nullptr;
    const float* g = grads + i * dim;
    for (int64_t c = 0; c < dim; ++c) {
      m[c] = beta1 * m[c] + (1.0f - beta1) * g[c];
      v[c] = beta2 * v[c] + (1.0f - beta2) * g[c] * g[c];
      float m_hat = m[c] / bc1;
      float v_hat = v[c] / bc2;
      if (x) {
        x[c] = v_hat > x[c] ? v_hat : x[c];
        v_hat = x[c];
      }
      w[c] -= lr * m_hat / (std::sqrt(v_hat) + epsilon);
    }
  }
}

}  // extern "C"
