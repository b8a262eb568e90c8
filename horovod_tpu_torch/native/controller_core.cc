// Controller negotiation core — native implementation of the rank-0
// coordinator bookkeeping and the response cache.
//
// Reference equivalents (reimplemented, not copied):
//   - IncrementTensorCount: controller.cc:837-860 — a tensor becomes
//     "ready" when all world_size ranks have reported it.
//   - ResponseCache: response_cache.cc/h:45-100 — LRU bit-indexed cache of
//     negotiated signatures so repeat iterations skip the coordinator
//     round-trip; bounded capacity with LRU eviction.
//
// Exposed as a C ABI consumed via ctypes (horovod_tpu_torch/native/__init__.py),
// mirroring how the reference exposes its core through extern "C"
// (operations.cc:690-878).

#include <cstdint>
#include <cstring>
#include <list>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct NegotiationTable {
  int world_size;
  std::mutex mu;
  // name -> bitmask-ish count of ranks that reported (vector<bool> per
  // name keeps duplicate reports idempotent, as the reference's
  // std::unordered_set<int32_t> ranks does).
  std::unordered_map<std::string, std::vector<uint8_t>> pending;
};

struct LruCache {
  size_t capacity;
  std::mutex mu;
  std::list<std::string> order;  // front = most recent
  std::unordered_map<std::string, std::list<std::string>::iterator> index;
};

}  // namespace

extern "C" {

// -- negotiation table ------------------------------------------------------

void* hvd_nt_new(int world_size) {
  auto* t = new NegotiationTable();
  t->world_size = world_size;
  return t;
}

void hvd_nt_free(void* h) { delete static_cast<NegotiationTable*>(h); }

// Record that `rank` submitted `name`. Returns 1 when the entry just
// became complete (all ranks reported; entry is then cleared), 0 when
// still pending, -1 on duplicate submission by the same rank (the
// duplicate-in-flight error of common.h:163-166).
int hvd_nt_increment(void* h, const char* name, int rank) {
  auto* t = static_cast<NegotiationTable*>(h);
  std::lock_guard<std::mutex> g(t->mu);
  // Validate BEFORE touching the table: an out-of-range rank must not
  // default-construct a phantom pending entry (which could never
  // complete and would inflate pending_count forever).
  if (rank < 0 || rank >= t->world_size) return -1;
  auto& ranks = t->pending[name];
  if (ranks.empty()) ranks.assign(t->world_size, 0);
  if (ranks[rank]) return -1;
  ranks[rank] = 1;
  int count = 0;
  for (uint8_t r : ranks) count += r;
  if (count == t->world_size) {
    t->pending.erase(name);
    return 1;
  }
  return 0;
}

// Number of tensors currently mid-negotiation (StallInspector input).
int64_t hvd_nt_pending(void* h) {
  auto* t = static_cast<NegotiationTable*>(h);
  std::lock_guard<std::mutex> g(t->mu);
  return static_cast<int64_t>(t->pending.size());
}

// Ranks missing for `name`, written as bytes into out (1 = missing);
// returns count of missing ranks, or -1 if name unknown.
int hvd_nt_missing(void* h, const char* name, uint8_t* out, int out_len) {
  auto* t = static_cast<NegotiationTable*>(h);
  std::lock_guard<std::mutex> g(t->mu);
  auto it = t->pending.find(name);
  if (it == t->pending.end()) return -1;
  int missing = 0;
  for (int r = 0; r < t->world_size && r < out_len; ++r) {
    out[r] = it->second[r] ? 0 : 1;
    missing += out[r];
  }
  return missing;
}

// -- LRU response cache -----------------------------------------------------

void* hvd_lru_new(int64_t capacity) {
  auto* c = new LruCache();
  c->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 1;
  return c;
}

void hvd_lru_free(void* h) { delete static_cast<LruCache*>(h); }

// Returns 1 on hit (and refreshes recency), 0 on miss.
int hvd_lru_lookup(void* h, const char* key) {
  auto* c = static_cast<LruCache*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  auto it = c->index.find(key);
  if (it == c->index.end()) return 0;
  c->order.splice(c->order.begin(), c->order, it->second);
  return 1;
}

// Insert key; if capacity exceeded, evicts LRU entry and copies the
// evicted key into evicted_out (if non-null, up to out_len-1 chars).
// Returns 1 if an eviction happened else 0.
int hvd_lru_put(void* h, const char* key, char* evicted_out, int out_len) {
  auto* c = static_cast<LruCache*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  auto it = c->index.find(key);
  if (it != c->index.end()) {
    c->order.splice(c->order.begin(), c->order, it->second);
    return 0;
  }
  c->order.push_front(key);
  c->index[key] = c->order.begin();
  if (c->order.size() > c->capacity) {
    const std::string& victim = c->order.back();
    if (evicted_out && out_len > 0) {
      std::strncpy(evicted_out, victim.c_str(), out_len - 1);
      evicted_out[out_len - 1] = '\0';
    }
    c->index.erase(victim);
    c->order.pop_back();
    return 1;
  }
  return 0;
}

int64_t hvd_lru_size(void* h) {
  auto* c = static_cast<LruCache*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  return static_cast<int64_t>(c->order.size());
}

void hvd_lru_erase(void* h, const char* key) {
  auto* c = static_cast<LruCache*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  auto it = c->index.find(key);
  if (it == c->index.end()) return;
  c->order.erase(it->second);
  c->index.erase(it);
}

}  // extern "C"
