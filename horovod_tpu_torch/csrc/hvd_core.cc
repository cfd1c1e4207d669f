// hvd_core.cc — the native control-plane core of the PyTorch port.
//
// Copy of horovod_tpu/csrc/hvd_core.cc, the JAX package's native core, with
// its logic unchanged: the port builds it into a library of its own
// (horovod_tpu_torch/csrc/native.py) and never loads the JAX package's.
//
// Reference (horovod/common/, SURVEY.md §2.1): the coordinator/worker
// negotiation logic (controller.cc:74 ComputeResponseList, :496
// ConstructResponse, :1115 IncrementTensorCount), the ResponseCache
// (response_cache.h:45 — LRU keyed by tensor name+params, 3-bit status,
// INVALID on shape change), the fusion planner (controller.cc:901
// FuseResponses — <=threshold buckets with mixed-dtype look-ahead), the
// TensorQueue (tensor_queue.h:28), and the StallInspector
// (stall_inspector.h:30 — warn when a strict subset of ranks reported a
// tensor for >warning_time, optional shutdown).
//
// What does NOT live here: collective execution (torch.distributed, NCCL
// or gloo) and the transport between ranks (the c10d store, in
// ops/negotiation.py).  The logic here is transport-free, which also makes
// it unit-testable in one process.
//
// Exposed as a plain C ABI (see the extern "C" block) consumed via ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <list>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace hvd {

// ---------------------------------------------------------------------------
// Common types
// ---------------------------------------------------------------------------

struct TensorSig {
  std::string name;
  std::string dtype;
  std::vector<int64_t> shape;
  int op;              // ReduceOp / collective kind id
  double prescale;
  double postscale;
  int process_set_id;

  bool ParamsMatch(const TensorSig& o) const {
    return dtype == o.dtype && shape == o.shape && op == o.op &&
           prescale == o.prescale && postscale == o.postscale &&
           process_set_id == o.process_set_id;
  }
};

// ---------------------------------------------------------------------------
// ResponseCache (response_cache.h:45-90)
// ---------------------------------------------------------------------------

// 3-bit status mirror of the reference's CacheState.
enum CacheResult { CACHE_MISS = 0, CACHE_HIT = 1, CACHE_INVALID = 2 };

class ResponseCache {
 public:
  explicit ResponseCache(size_t capacity) : capacity_(capacity) {}

  int Lookup(const TensorSig& sig) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = index_.find(sig.name);
    if (it == index_.end()) return CACHE_MISS;
    const TensorSig& cached = it->second->sig;
    if (!cached.ParamsMatch(sig)) {
      // Shape/param change invalidates (response_cache INVALID → forces
      // renegotiation; reference controller.cc:92-128 classification).
      return CACHE_INVALID;
    }
    // LRU touch.
    lru_.splice(lru_.begin(), lru_, it->second);
    return CACHE_HIT;
  }

  // Put after successful negotiation; assigns a stable cache bit.  Returns
  // the assigned bit (the reference synchronizes bit vectors across ranks —
  // bits are assigned in identical order because negotiation completes in
  // identical order on all ranks).
  int64_t Put(const TensorSig& sig) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = index_.find(sig.name);
    if (it != index_.end()) {
      it->second->sig = sig;
      lru_.splice(lru_.begin(), lru_, it->second);
      return it->second->bit;
    }
    if (capacity_ == 0) return -1;
    if (lru_.size() >= capacity_) {
      // Evict LRU tail.
      auto& victim = lru_.back();
      free_bits_.insert(victim.bit);
      index_.erase(victim.sig.name);
      lru_.pop_back();
    }
    int64_t bit;
    if (!free_bits_.empty()) {
      bit = *free_bits_.begin();
      free_bits_.erase(free_bits_.begin());
    } else {
      bit = next_bit_++;
    }
    lru_.push_front(Entry{sig, bit});
    index_[sig.name] = lru_.begin();
    return bit;
  }

  bool Invalidate(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = index_.find(name);
    if (it == index_.end()) return false;
    free_bits_.insert(it->second->bit);
    lru_.erase(it->second);
    index_.erase(it);
    return true;
  }

  void Clear() {
    std::lock_guard<std::mutex> lk(mu_);
    lru_.clear();
    index_.clear();
    free_bits_.clear();
    next_bit_ = 0;
  }

  size_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return lru_.size();
  }

 private:
  struct Entry {
    TensorSig sig;
    int64_t bit;
  };
  size_t capacity_;
  std::mutex mu_;
  std::list<Entry> lru_;
  std::unordered_map<std::string, std::list<Entry>::iterator> index_;
  std::set<int64_t> free_bits_;
  int64_t next_bit_ = 0;
};

// ---------------------------------------------------------------------------
// MessageTable / negotiation (controller.cc:1115 IncrementTensorCount,
// :496 ConstructResponse)
// ---------------------------------------------------------------------------

class MessageTable {
 public:
  explicit MessageTable(int size) : size_(size) {}

  void SetSize(int size) {
    std::lock_guard<std::mutex> lk(mu_);
    size_ = size;
  }

  // Record rank's request for a named collective.  Returns:
  //   0  -> recorded, not yet ready
  //   1  -> ready (every rank reported)
  //  -1  -> duplicate submission from this rank (DUPLICATE_NAME_ERROR,
  //         common.h:239)
  int Increment(const TensorSig& sig, int rank) {
    std::lock_guard<std::mutex> lk(mu_);
    auto& rec = table_[sig.name];
    if (rec.ranks.count(rank)) return -1;
    rec.ranks.insert(rank);
    rec.sigs.push_back({rank, sig});
    if (rec.first_ts == 0) rec.first_ts = ++clock_;
    return (int)rec.ranks.size() == size_ ? 1 : 0;
  }

  // Validate cross-rank consistency once ready (ConstructResponse error
  // checking: mismatched dtypes / shapes / ops produce an ERROR response).
  // Returns empty string when consistent, else the error text.
  std::string Validate(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = table_.find(name);
    if (it == table_.end()) return "unknown tensor " + name;
    auto& sigs = it->second.sigs;
    if (sigs.empty()) return "no requests for " + name;
    const TensorSig& ref = sigs.front().second;
    for (auto& [rank, sig] : sigs) {
      if (sig.dtype != ref.dtype) {
        return "Mismatched data types for collective " + name + ": rank " +
               std::to_string(sigs.front().first) + " sent " + ref.dtype +
               ", rank " + std::to_string(rank) + " sent " + sig.dtype;
      }
      if (sig.op != ref.op) {
        return "Mismatched ops for collective " + name;
      }
      if (sig.process_set_id != ref.process_set_id) {
        return "Mismatched process sets for collective " + name + ": rank " +
               std::to_string(sigs.front().first) + " used set " +
               std::to_string(ref.process_set_id) + ", rank " +
               std::to_string(rank) + " used set " +
               std::to_string(sig.process_set_id);
      }
      if (sig.prescale != ref.prescale || sig.postscale != ref.postscale) {
        return "Mismatched prescale/postscale factors for collective " + name;
      }
      // Allreduce-family requires identical shapes; allgather-family
      // (op in [1000, 2000) by convention, see negotiation.py KIND_IDS)
      // permits differing dim0.
      bool allgather_like = sig.op >= 1000 && sig.op < 2000;
      if (allgather_like) {
        if (sig.shape.size() != ref.shape.size())
          return "Mismatched ranks (ndims) for allgather " + name;
        for (size_t i = 1; i < sig.shape.size(); ++i)
          if (sig.shape[i] != ref.shape[i])
            return "Mismatched trailing dimensions for allgather " + name;
      } else if (sig.shape != ref.shape) {
        return "Mismatched shapes for collective " + name;
      }
    }
    return "";
  }

  // Remove the record (after response delivered).
  void Erase(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    table_.erase(name);
  }

  // Ranks that have reported `name` so far.
  std::vector<int> ReportedRanks(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    std::vector<int> out;
    auto it = table_.find(name);
    if (it != table_.end())
      out.assign(it->second.ranks.begin(), it->second.ranks.end());
    return out;
  }

  // Pending tensors in arrival order (for stall inspection / fusion scan).
  std::vector<std::string> Pending() {
    std::lock_guard<std::mutex> lk(mu_);
    std::vector<std::pair<uint64_t, std::string>> items;
    for (auto& [name, rec] : table_)
      items.push_back({rec.first_ts, name});
    std::sort(items.begin(), items.end());
    std::vector<std::string> out;
    for (auto& [ts, name] : items) out.push_back(name);
    return out;
  }

 private:
  struct Record {
    std::set<int> ranks;
    std::vector<std::pair<int, TensorSig>> sigs;
    uint64_t first_ts = 0;
  };
  int size_;
  std::mutex mu_;
  uint64_t clock_ = 0;
  std::unordered_map<std::string, Record> table_;
};

// ---------------------------------------------------------------------------
// Fusion planner (controller.cc:901 FuseResponses)
// ---------------------------------------------------------------------------

// Given an ordered list of ready entries, produce fusion buckets: greedy fill
// up to threshold bytes, only fusing entries with identical
// (dtype, op, process_set); the look-ahead continues scanning past a
// non-matching entry to fill the current bucket (reference look-ahead for
// mixed dtypes), preserving relative order within buckets.
struct FusionEntry {
  TensorSig sig;
  int64_t bytes;
};

static std::vector<std::vector<int>> PlanFusion(
    const std::vector<FusionEntry>& entries, int64_t threshold) {
  std::vector<std::vector<int>> buckets;
  std::vector<bool> used(entries.size(), false);
  for (size_t i = 0; i < entries.size(); ++i) {
    if (used[i]) continue;
    std::vector<int> bucket{(int)i};
    used[i] = true;
    int64_t total = entries[i].bytes;
    const TensorSig& key = entries[i].sig;
    for (size_t j = i + 1; j < entries.size(); ++j) {
      if (used[j]) continue;
      const auto& e = entries[j];
      if (e.sig.dtype != key.dtype || e.sig.op != key.op ||
          e.sig.process_set_id != key.process_set_id)
        continue;  // look-ahead: skip, keep scanning
      if (total + e.bytes > threshold) continue;
      bucket.push_back((int)j);
      used[j] = true;
      total += e.bytes;
    }
    buckets.push_back(std::move(bucket));
  }
  return buckets;
}

// ---------------------------------------------------------------------------
// TensorQueue (tensor_queue.h:28)
// ---------------------------------------------------------------------------

class TensorQueue {
 public:
  // Returns false on duplicate in-flight name (DUPLICATE_NAME_ERROR).
  bool Add(const TensorSig& sig) {
    std::lock_guard<std::mutex> lk(mu_);
    if (inflight_.count(sig.name)) return false;
    inflight_.insert(sig.name);
    queue_.push_back(sig);
    return true;
  }

  // Pop up to max entries (one negotiation cycle's worth,
  // PopMessagesFromQueue).
  std::vector<TensorSig> Pop(size_t max) {
    std::lock_guard<std::mutex> lk(mu_);
    std::vector<TensorSig> out;
    while (!queue_.empty() && out.size() < max) {
      out.push_back(queue_.front());
      queue_.pop_front();
    }
    return out;
  }

  void Finish(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    inflight_.erase(name);
    // Drop any unpopped queue entry too — callers that use the queue purely
    // for duplicate detection (claim/finish) must not leak deque entries.
    for (auto it = queue_.begin(); it != queue_.end(); ++it) {
      if (it->name == name) {
        queue_.erase(it);
        break;
      }
    }
  }

  size_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return queue_.size();
  }

 private:
  std::mutex mu_;
  std::deque<TensorSig> queue_;
  std::set<std::string> inflight_;
};

// ---------------------------------------------------------------------------
// StallInspector (stall_inspector.h:30)
// ---------------------------------------------------------------------------

class StallInspector {
 public:
  StallInspector(double warn_s, double shutdown_s, int world_size)
      : warn_s_(warn_s), shutdown_s_(shutdown_s), size_(world_size) {}

  void RecordRequest(const std::string& name, int rank, double now) {
    std::lock_guard<std::mutex> lk(mu_);
    auto& rec = pending_[name];
    if (rec.ranks.empty()) rec.first_seen = now;
    rec.ranks.insert(rank);
  }

  void RecordDone(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    pending_.erase(name);
  }

  // Build a warning report: tensors whose request set is a strict subset of
  // ranks for longer than warn_s.  Format (one line per tensor):
  //   name;waiting_secs;ready_ranks_csv;missing_ranks_csv
  // Returns 2 if any tensor exceeded shutdown_s (caller should abort,
  // HOROVOD_STALL_SHUTDOWN_TIME_SECONDS), 1 if warnings exist, else 0.
  int Check(double now, std::string* report) {
    std::lock_guard<std::mutex> lk(mu_);
    int status = 0;
    report->clear();
    for (auto& [name, rec] : pending_) {
      double waited = now - rec.first_seen;
      if ((int)rec.ranks.size() < size_ && waited > warn_s_) {
        status = std::max(status, 1);
        if (shutdown_s_ > 0 && waited > shutdown_s_) status = 2;
        std::string ready, missing;
        for (int r = 0; r < size_; ++r) {
          if (rec.ranks.count(r)) {
            if (!ready.empty()) ready += ",";
            ready += std::to_string(r);
          } else {
            if (!missing.empty()) missing += ",";
            missing += std::to_string(r);
          }
        }
        *report += name + ";" + std::to_string(waited) + ";" + ready + ";" +
                   missing + "\n";
      }
    }
    return status;
  }

 private:
  struct Rec {
    std::set<int> ranks;
    double first_seen = 0;
  };
  double warn_s_, shutdown_s_;
  int size_;
  std::mutex mu_;
  std::unordered_map<std::string, Rec> pending_;
};

}  // namespace hvd

// ---------------------------------------------------------------------------
// C ABI (ctypes surface — the operations.cc extern "C" analog)
// ---------------------------------------------------------------------------

using hvd::CacheResult;
using hvd::FusionEntry;
using hvd::MessageTable;
using hvd::ResponseCache;
using hvd::StallInspector;
using hvd::TensorQueue;
using hvd::TensorSig;

static TensorSig MakeSig(const char* name, const char* dtype,
                         const int64_t* shape, int ndim, int op,
                         double prescale, double postscale, int ps_id) {
  TensorSig s;
  s.name = name;
  s.dtype = dtype;
  s.shape.assign(shape, shape + ndim);
  s.op = op;
  s.prescale = prescale;
  s.postscale = postscale;
  s.process_set_id = ps_id;
  return s;
}

// Thread-local error/report buffer for string returns.
static thread_local std::string g_strbuf;

extern "C" {

// --- version ---------------------------------------------------------------
int hvd_core_abi_version() { return 2; }

// --- ResponseCache ----------------------------------------------------------
void* hvd_cache_create(int64_t capacity) {
  return new ResponseCache((size_t)capacity);
}
void hvd_cache_destroy(void* c) { delete (ResponseCache*)c; }
int hvd_cache_lookup(void* c, const char* name, const char* dtype,
                     const int64_t* shape, int ndim, int op, double prescale,
                     double postscale, int ps_id) {
  return ((ResponseCache*)c)
      ->Lookup(MakeSig(name, dtype, shape, ndim, op, prescale, postscale,
                       ps_id));
}
int64_t hvd_cache_put(void* c, const char* name, const char* dtype,
                      const int64_t* shape, int ndim, int op, double prescale,
                      double postscale, int ps_id) {
  return ((ResponseCache*)c)
      ->Put(MakeSig(name, dtype, shape, ndim, op, prescale, postscale,
                    ps_id));
}
int hvd_cache_invalidate(void* c, const char* name) {
  return ((ResponseCache*)c)->Invalidate(name) ? 1 : 0;
}
void hvd_cache_clear(void* c) { ((ResponseCache*)c)->Clear(); }
int64_t hvd_cache_size(void* c) { return (int64_t)((ResponseCache*)c)->Size(); }

// --- MessageTable ------------------------------------------------------------
void* hvd_msgtable_create(int world_size) {
  return new MessageTable(world_size);
}
void hvd_msgtable_destroy(void* t) { delete (MessageTable*)t; }
void hvd_msgtable_set_size(void* t, int size) {
  ((MessageTable*)t)->SetSize(size);
}
int hvd_msgtable_increment(void* t, const char* name, const char* dtype,
                           const int64_t* shape, int ndim, int op,
                           double prescale, double postscale, int ps_id,
                           int rank) {
  return ((MessageTable*)t)
      ->Increment(MakeSig(name, dtype, shape, ndim, op, prescale, postscale,
                          ps_id),
                  rank);
}
const char* hvd_msgtable_validate(void* t, const char* name) {
  g_strbuf = ((MessageTable*)t)->Validate(name);
  return g_strbuf.c_str();
}
void hvd_msgtable_erase(void* t, const char* name) {
  ((MessageTable*)t)->Erase(name);
}
const char* hvd_msgtable_pending(void* t) {
  auto pending = ((MessageTable*)t)->Pending();
  g_strbuf.clear();
  for (auto& p : pending) {
    if (!g_strbuf.empty()) g_strbuf += "\n";
    g_strbuf += p;
  }
  return g_strbuf.c_str();
}
const char* hvd_msgtable_reported_ranks(void* t, const char* name) {
  auto ranks = ((MessageTable*)t)->ReportedRanks(name);
  g_strbuf.clear();
  for (auto r : ranks) {
    if (!g_strbuf.empty()) g_strbuf += ",";
    g_strbuf += std::to_string(r);
  }
  return g_strbuf.c_str();
}

// --- Fusion planner -----------------------------------------------------------
// entries flattened: for i in [0, n): names[i], dtypes[i], bytes[i], ops[i],
// ps_ids[i].  Output: bucket index per entry written to out_bucket (len n).
// Returns the number of buckets.
int hvd_fusion_plan(const char** names, const char** dtypes,
                    const int64_t* bytes, const int* ops, const int* ps_ids,
                    int n, int64_t threshold, int* out_bucket) {
  std::vector<FusionEntry> entries(n);
  for (int i = 0; i < n; ++i) {
    entries[i].sig.name = names[i];
    entries[i].sig.dtype = dtypes[i];
    entries[i].sig.op = ops[i];
    entries[i].sig.process_set_id = ps_ids[i];
    entries[i].sig.prescale = 1.0;
    entries[i].sig.postscale = 1.0;
    entries[i].bytes = bytes[i];
  }
  auto buckets = hvd::PlanFusion(entries, threshold);
  for (size_t b = 0; b < buckets.size(); ++b)
    for (int idx : buckets[b]) out_bucket[idx] = (int)b;
  return (int)buckets.size();
}

// --- TensorQueue ----------------------------------------------------------------
void* hvd_queue_create() { return new TensorQueue(); }
void hvd_queue_destroy(void* q) { delete (TensorQueue*)q; }
int hvd_queue_add(void* q, const char* name, const char* dtype,
                  const int64_t* shape, int ndim, int op, double prescale,
                  double postscale, int ps_id) {
  return ((TensorQueue*)q)
                 ->Add(MakeSig(name, dtype, shape, ndim, op, prescale,
                               postscale, ps_id))
             ? 1
             : 0;
}
void hvd_queue_finish(void* q, const char* name) {
  ((TensorQueue*)q)->Finish(name);
}
int64_t hvd_queue_size(void* q) { return (int64_t)((TensorQueue*)q)->Size(); }
// Pop up to max names (newline-joined).
const char* hvd_queue_pop(void* q, int64_t max) {
  auto sigs = ((TensorQueue*)q)->Pop((size_t)max);
  g_strbuf.clear();
  for (auto& s : sigs) {
    if (!g_strbuf.empty()) g_strbuf += "\n";
    g_strbuf += s.name;
  }
  return g_strbuf.c_str();
}

// --- StallInspector ----------------------------------------------------------------
void* hvd_stall_create(double warn_s, double shutdown_s, int world_size) {
  return new StallInspector(warn_s, shutdown_s, world_size);
}
void hvd_stall_destroy(void* s) { delete (StallInspector*)s; }
void hvd_stall_record(void* s, const char* name, int rank, double now) {
  ((StallInspector*)s)->RecordRequest(name, rank, now);
}
void hvd_stall_done(void* s, const char* name) {
  ((StallInspector*)s)->RecordDone(name);
}
int hvd_stall_check(void* s, double now, const char** report) {
  int status = ((StallInspector*)s)->Check(now, &g_strbuf);
  *report = g_strbuf.c_str();
  return status;
}

}  // extern "C"
