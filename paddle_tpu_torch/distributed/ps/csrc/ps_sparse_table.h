// Sharded host-RAM sparse embedding table (shared by the in-process facade
// and the networked PsService).
//
// Reference analogue: paddle/fluid/distributed/ps/table/memory_sparse_table.cc
// (sharded unordered_map embedding store with per-shard task parallelism) and
// ps/table/sparse_sgd_rule.cc (per-feature optimizer applied inside the table
// on push — SGD / AdaGrad).
//
// Thread-safety: each shard carries its own mutex, so concurrent pull/push
// calls from different caller threads (multiple trainer connections in the
// PsService) are safe; within one call, run_sharded additionally partitions
// shards across worker threads so a shard's mutex is uncontended in the
// single-caller case.
#pragma once

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace ps {

// pluggable per-feature SGD rules (reference: ps/table/sparse_sgd_rule.h —
// SparseNaiveSGDRule / SparseAdaGradSGDRule / SparseAdamSGDRule)
enum OptType : int32_t { OPT_SGD = 0, OPT_ADAGRAD = 1, OPT_ADAM = 2 };

struct Entry {
  // ONE contiguous block per feature: [emb dim | g2sum dim? | m2 dim?]
  // (g2sum = adagrad accumulator / adam moment1; m2 = adam moment2).
  // A single allocation and a linear touch pattern per row — the split
  // per-state vectors cost an extra heap block and a cache miss each on
  // every push (measured ~20% of the in-process push path)
  std::vector<float> data;
  float b1p = 1.f, b2p = 1.f;  // adam bias-correction powers
  // CTR accessor state (reference: ctr_accessor.h CtrCommonFeatureValue —
  // show/click/unseen_days drive time decay + score-based eviction)
  float show = 0.f, click = 0.f, unseen_days = 0.f;
  // LRU clock for the SSD spill policy (unused without enable_ssd)
  uint64_t tick = 0;
};

// disk-overflow state (reference: ps/table/ssd_sparse_table.h — RAM cache
// in front of a rocksdb store; here: one fixed-record slot file + an
// in-RAM key→slot index per shard, LRU batch spill past a RAM budget)
struct SsdShard {
  std::unordered_map<int64_t, int64_t> index;  // key -> slot
};

struct SsdState {
  int fd = -1;
  std::string path;
  int64_t rec_size = 0;       // bytes per slot (fixed at enable time)
  int64_t ram_budget = 0;     // max RAM entries per TABLE
  std::vector<SsdShard> shards;
  std::vector<int64_t> free_slots;
  int64_t next_slot = 0;
  std::mutex alloc_mu;  // free_slots/next_slot
  std::atomic<uint64_t> clock{1};

  ~SsdState() {
    if (fd >= 0) ::close(fd);
    if (!path.empty()) ::unlink(path.c_str());
  }
};

// reference: CtrCommonAccessor config (table_accessor proto fields
// show_click_decay_rate, delete_threshold, delete_after_unseen_days and
// ShowClickScore's nonclk/click coefficients)
struct CtrParams {
  bool enabled = false;
  float show_coeff = 0.25f;    // reference nonclk_coeff
  float click_coeff = 1.0f;
  float decay_rate = 0.98f;    // per-shrink show/click decay
  float delete_threshold = 0.8f;
  float delete_after_unseen_days = 30.f;
};

struct Shard {
  std::unordered_map<int64_t, Entry> map;
  std::mutex mu;
};

struct SparseTable {
  int emb_dim;
  int shard_num;
  int32_t opt_type;
  float lr;
  float init_range;  // uniform(-init_range, init_range); 0 => zeros
  float adagrad_eps;
  float beta1, beta2;  // adam
  CtrParams ctr;
  std::vector<Shard> shards;
  uint64_t seed;
  std::unique_ptr<SsdState> ssd;  // null = pure-RAM table

  SparseTable(int dim, int nshard, int32_t opt, float lr_, float range,
              uint64_t seed_)
      : emb_dim(dim),
        shard_num(nshard),
        opt_type(opt),
        lr(lr_),
        init_range(range),
        adagrad_eps(1e-6f),
        beta1(0.9f),
        beta2(0.999f),
        shards(nshard),
        seed(seed_) {}

  int shard_of(int64_t key) const {
    uint64_t h = (static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ULL) >> 32;
    return static_cast<int>(h % static_cast<uint64_t>(shard_num));
  }

  // flat-block accessors (layout depends on the table's optimizer)
  int state_floats() const {
    return emb_dim *
           (1 + (opt_type != OPT_SGD ? 1 : 0) + (opt_type == OPT_ADAM ? 1 : 0));
  }
  float* emb_of(Entry& e) const { return e.data.data(); }
  const float* emb_of(const Entry& e) const { return e.data.data(); }
  float* g2_of(Entry& e) const { return e.data.data() + emb_dim; }
  const float* g2_of(const Entry& e) const { return e.data.data() + emb_dim; }
  float* m2_of(Entry& e) const { return e.data.data() + 2 * emb_dim; }
  const float* m2_of(const Entry& e) const {
    return e.data.data() + 2 * emb_dim;
  }

  void init_entry(int64_t key, Entry* e) const {
    e->data.assign(state_floats(), 0.f);
    if (init_range > 0.f) {
      // per-key deterministic init: same key always gets the same row,
      // independent of insertion order, shard count, or which server/host
      // materializes it (load-bearing for geo replicas)
      std::mt19937_64 gen(seed ^ static_cast<uint64_t>(key));
      std::uniform_real_distribution<float> dist(-init_range, init_range);
      float* emb = e->data.data();
      for (int i = 0; i < emb_dim; ++i) emb[i] = dist(gen);
    }
  }

  // one SGD-rule application on an entry (reference: sparse_sgd_rule.cc
  // UpdateValueWork per rule)
  void apply_rule(Entry& e, const float* g) {
    float* emb = e.data.data();
    if (opt_type == OPT_ADAGRAD) {
      float* g2 = emb + emb_dim;
      for (int i = 0; i < emb_dim; ++i) {
        g2[i] += g[i] * g[i];
        emb[i] -= lr * g[i] / (std::sqrt(g2[i]) + adagrad_eps);
      }
    } else if (opt_type == OPT_ADAM) {
      float* m1 = emb + emb_dim;
      float* m2 = m1 + emb_dim;
      e.b1p *= beta1;
      e.b2p *= beta2;
      for (int i = 0; i < emb_dim; ++i) {
        m1[i] = beta1 * m1[i] + (1.f - beta1) * g[i];
        m2[i] = beta2 * m2[i] + (1.f - beta2) * g[i] * g[i];
        float mh = m1[i] / (1.f - e.b1p);
        float vh = m2[i] / (1.f - e.b2p);
        emb[i] -= lr * mh / (std::sqrt(vh) + adagrad_eps);
      }
    } else {
      for (int i = 0; i < emb_dim; ++i) emb[i] -= lr * g[i];
    }
  }

  float show_click_score(const Entry& e) const {
    return ctr.show_coeff * (e.show - e.click) + ctr.click_coeff * e.click;
  }

  // -- SSD overflow (reference: ps/table/ssd_sparse_table.h) ---------------
  // Entries past `ram_budget` spill to a fixed-record slot file; pull/push
  // transparently promote disk-resident keys back into RAM (LRU batch
  // eviction picks the victims). Call AFTER the optimizer type and CTR
  // accessor are configured — the record layout freezes here.
  bool enable_ssd(const char* path, int64_t ram_budget) {
    auto st = std::make_unique<SsdState>();
    st->fd = ::open(path, O_RDWR | O_CREAT | O_TRUNC, 0600);
    if (st->fd < 0) return false;
    st->path = path;
    st->ram_budget = ram_budget > shard_num ? ram_budget : shard_num;
    st->rec_size = ssd_rec_bytes();
    st->shards.resize(shard_num);
    ssd = std::move(st);
    return true;
  }

  int64_t ssd_rec_bytes() const {
    // key | flat state block [emb|g2|m2] | adam powers | ctr — the state
    // block is byte-identical to the old per-vector layout
    int64_t b = 8 + 4LL * state_floats();
    if (opt_type == OPT_ADAM) b += 8;
    if (ctr.enabled) b += 12;
    return b;
  }

  void ssd_encode(int64_t key, const Entry& e, char* p) const {
    std::memcpy(p, &key, 8);
    p += 8;
    std::memcpy(p, e.data.data(), 4LL * state_floats());
    p += 4LL * state_floats();
    if (opt_type == OPT_ADAM) {
      std::memcpy(p, &e.b1p, 4);
      std::memcpy(p + 4, &e.b2p, 4);
      p += 8;
    }
    if (ctr.enabled) {
      std::memcpy(p, &e.show, 4);
      std::memcpy(p + 4, &e.click, 4);
      std::memcpy(p + 8, &e.unseen_days, 4);
    }
  }

  int64_t ssd_decode(const char* p, Entry* e) const {
    int64_t key;
    std::memcpy(&key, p, 8);
    p += 8;
    e->data.resize(state_floats());
    std::memcpy(e->data.data(), p, 4LL * state_floats());
    p += 4LL * state_floats();
    if (opt_type == OPT_ADAM) {
      std::memcpy(&e->b1p, p, 4);
      std::memcpy(&e->b2p, p + 4, 4);
      p += 8;
    }
    if (ctr.enabled) {
      std::memcpy(&e->show, p, 4);
      std::memcpy(&e->click, p + 4, 4);
      std::memcpy(&e->unseen_days, p + 8, 4);
    }
    return key;
  }

  int64_t ssd_alloc_slot() {
    std::lock_guard<std::mutex> lk(ssd->alloc_mu);
    if (!ssd->free_slots.empty()) {
      int64_t s = ssd->free_slots.back();
      ssd->free_slots.pop_back();
      return s;
    }
    return ssd->next_slot++;
  }

  void ssd_free_slot(int64_t slot) {
    std::lock_guard<std::mutex> lk(ssd->alloc_mu);
    ssd->free_slots.push_back(slot);
  }

  // caller holds the shard lock
  bool ssd_fetch(int shard_id, int64_t key, Entry* e) {
    SsdShard& ss = ssd->shards[shard_id];
    auto it = ss.index.find(key);
    if (it == ss.index.end()) return false;
    std::vector<char> buf(ssd->rec_size);
    if (::pread(ssd->fd, buf.data(), ssd->rec_size,
                it->second * ssd->rec_size) != ssd->rec_size)
      return false;
    ssd_decode(buf.data(), e);
    ssd_free_slot(it->second);
    ss.index.erase(it);
    return true;
  }

  // caller holds the shard lock; spills the coldest ~quarter once the
  // shard's RAM share is exceeded (batching amortizes the tick scan)
  void ssd_spill(int shard_id, Shard& sh) {
    int64_t per_shard = ssd->ram_budget / shard_num;
    if (per_shard < 1) per_shard = 1;
    if (static_cast<int64_t>(sh.map.size()) <= per_shard) return;
    int64_t excess = static_cast<int64_t>(sh.map.size()) - per_shard;
    int64_t batch = excess > per_shard / 4 ? excess : per_shard / 4;
    if (batch < 1) batch = 1;
    if (batch > static_cast<int64_t>(sh.map.size()))
      batch = static_cast<int64_t>(sh.map.size());
    std::vector<std::pair<uint64_t, int64_t>> ages;
    ages.reserve(sh.map.size());
    for (auto& kv : sh.map) ages.push_back({kv.second.tick, kv.first});
    std::nth_element(ages.begin(), ages.begin() + (batch - 1), ages.end());
    std::vector<char> buf(ssd->rec_size);
    SsdShard& ss = ssd->shards[shard_id];
    for (int64_t i = 0; i < batch; ++i) {
      int64_t key = ages[i].second;
      auto it = sh.map.find(key);
      if (it == sh.map.end()) continue;
      int64_t slot = ssd_alloc_slot();
      ssd_encode(key, it->second, buf.data());
      if (::pwrite(ssd->fd, buf.data(), ssd->rec_size,
                   slot * ssd->rec_size) != ssd->rec_size) {
        ssd_free_slot(slot);  // disk full/error: keep the entry in RAM
        continue;
      }
      ss.index[key] = slot;
      sh.map.erase(it);
    }
  }

  // find-or-create with disk promotion; caller holds the shard lock.
  // Returns nullptr when absent and !create.
  Entry* find_entry(Shard& sh, int64_t key, bool create) {
    auto it = sh.map.find(key);
    if (it == sh.map.end() && ssd) {
      Entry e;
      if (ssd_fetch(shard_of(key), key, &e))
        it = sh.map.emplace(key, std::move(e)).first;
    }
    if (it == sh.map.end()) {
      if (!create) return nullptr;
      Entry e;
      init_entry(key, &e);
      it = sh.map.emplace(key, std::move(e)).first;
    }
    Entry& e = it->second;
    if (ssd) {
      e.tick = ssd->clock.fetch_add(1);
      ssd_spill(shard_of(key), sh);
      // the looked-up entry may itself have been spilled when it is the
      // coldest — re-promote so the caller's pointer stays valid. A
      // failed re-read (transient I/O error) falls back to a fresh init:
      // callers write emb_dim floats through the pointer, so an empty
      // data block would be heap corruption, not a recoverable state
      auto again = sh.map.find(key);
      if (again == sh.map.end()) {
        Entry back;
        if (!ssd_fetch(shard_of(key), key, &back)) init_entry(key, &back);
        back.tick = ssd->clock.fetch_add(1);
        again = sh.map.emplace(key, std::move(back)).first;
      }
      return &again->second;
    }
    return &e;
  }

  int64_t ram_size() {
    int64_t s = 0;
    for (auto& sh : shards) {
      std::lock_guard<std::mutex> lk(sh.mu);
      s += static_cast<int64_t>(sh.map.size());
    }
    return s;
  }

  int64_t disk_size() {
    if (!ssd) return 0;
    int64_t s = 0;
    for (int i = 0; i < shard_num; ++i) {
      std::lock_guard<std::mutex> lk(shards[i].mu);
      s += static_cast<int64_t>(ssd->shards[i].index.size());
    }
    return s;
  }

  // gather rows for keys; missing keys are created (reference PullSparse
  // create-on-miss semantics for training; create=false skips creation for
  // inference lookups and returns zeros)
  void pull(const int64_t* keys, int64_t n, float* out, bool create) {
    run_sharded(keys, n, [&](Shard& sh, int64_t idx) {
      int64_t key = keys[idx];
      Entry* e = find_entry(sh, key, create);
      if (e == nullptr) {
        std::memset(out + idx * emb_dim, 0, sizeof(float) * emb_dim);
        return;
      }
      std::memcpy(out + idx * emb_dim, e->data.data(),
                  sizeof(float) * emb_dim);
    });
  }

  // apply optimizer update for grads; raw=true adds the payload directly to
  // the embedding instead (the geo-async delta merge — reference
  // MemorySparseGeoTable's push without an accessor rule)
  void push(const int64_t* keys, int64_t n, const float* grads,
            bool raw = false) {
    run_sharded(keys, n, [&](Shard& sh, int64_t idx) {
      int64_t key = keys[idx];
      Entry& e = *find_entry(sh, key, /*create=*/true);
      const float* g = grads + idx * emb_dim;
      if (raw) {
        float* emb = e.data.data();
        for (int i = 0; i < emb_dim; ++i) emb[i] += g[i];
      } else {
        apply_rule(e, g);
      }
    });
  }

  // CTR push (reference: ctr_accessor.cc Update — fold per-impression
  // show/click counts into the feature value, reset its unseen clock, then
  // apply the SGD rule on the gradient)
  void push_ctr(const int64_t* keys, int64_t n, const float* shows,
                const float* clicks, const float* grads) {
    run_sharded(keys, n, [&](Shard& sh, int64_t idx) {
      int64_t key = keys[idx];
      Entry& e = *find_entry(sh, key, /*create=*/true);
      e.show += shows[idx];
      e.click += clicks[idx];
      e.unseen_days = 0.f;
      apply_rule(e, grads + idx * emb_dim);
    });
  }

  // one decay+eviction pass = one "day" (reference: ctr_accessor.cc
  // UpdateTimeDecay + Shrink): show/click decay, unseen clocks advance,
  // and features whose score fell under delete_threshold — or that were
  // unseen too long — are evicted. Returns the evicted count.
  int64_t shrink() {
    // without the CTR accessor every entry scores 0 — a stray shrink()
    // must not wipe a plain embedding table
    if (!ctr.enabled) return 0;
    int64_t evicted = 0;
    for (int si = 0; si < shard_num; ++si) {
      Shard& sh = shards[si];
      std::lock_guard<std::mutex> lk(sh.mu);
      for (auto it = sh.map.begin(); it != sh.map.end();) {
        Entry& e = it->second;
        e.show *= ctr.decay_rate;
        e.click *= ctr.decay_rate;
        e.unseen_days += 1.f;
        if (e.unseen_days > ctr.delete_after_unseen_days ||
            show_click_score(e) < ctr.delete_threshold) {
          it = sh.map.erase(it);
          ++evicted;
        } else {
          ++it;
        }
      }
      if (!ssd) continue;
      // disk-resident entries age too: read-decay-rewrite (or evict)
      SsdShard& ss = ssd->shards[si];
      std::vector<char> buf(ssd->rec_size);
      for (auto it = ss.index.begin(); it != ss.index.end();) {
        if (::pread(ssd->fd, buf.data(), ssd->rec_size,
                    it->second * ssd->rec_size) != ssd->rec_size) {
          ++it;
          continue;
        }
        Entry e;
        int64_t key = ssd_decode(buf.data(), &e);
        e.show *= ctr.decay_rate;
        e.click *= ctr.decay_rate;
        e.unseen_days += 1.f;
        if (e.unseen_days > ctr.delete_after_unseen_days ||
            show_click_score(e) < ctr.delete_threshold) {
          ssd_free_slot(it->second);
          it = ss.index.erase(it);
          ++evicted;
        } else {
          ssd_encode(key, e, buf.data());
          ::pwrite(ssd->fd, buf.data(), ssd->rec_size,
                   it->second * ssd->rec_size);
          ++it;
        }
      }
    }
    return evicted;
  }

  // out[4] = show, click, unseen_days, score; false when key absent
  bool ctr_stats(int64_t key, float* out) {
    Shard& sh = shards[shard_of(key)];
    std::lock_guard<std::mutex> lk(sh.mu);
    Entry* ep = find_entry(sh, key, /*create=*/false);
    if (ep == nullptr) return false;
    const Entry& e = *ep;
    out[0] = e.show;
    out[1] = e.click;
    out[2] = e.unseen_days;
    out[3] = show_click_score(e);
    return true;
  }

  // shard-parallel execution: keys are bucketed by shard in one pass, each
  // worker thread owns a subset of shards, and the shard mutex is taken
  // ONCE per (shard, call) — amortized locking plus cache-friendly grouped
  // access (reference: shards_task_pool_). fn runs with the lock held.
  template <typename F>
  void run_sharded(const int64_t* keys, int64_t n, F fn) {
    // worker fan-out is capped by the machine: on a single-core host the
    // serial path wins outright (thread spawn is pure overhead), and the
    // pipelined client's per-chunk calls would otherwise each pay it
    static const int hw = [] {
      unsigned c = std::thread::hardware_concurrency();
      return c > 0 ? static_cast<int>(c) : 8;
    }();
    if (n < 1024) {
      for (int64_t i = 0; i < n; ++i) {
        Shard& sh = shards[shard_of(keys[i])];
        std::lock_guard<std::mutex> lk(sh.mu);
        fn(sh, i);
      }
      return;
    }
    std::vector<std::vector<int64_t>> buckets(shard_num);
    for (auto& b : buckets) b.reserve(n / shard_num + 8);
    for (int64_t i = 0; i < n; ++i) buckets[shard_of(keys[i])].push_back(i);
    if (hw <= 1) {
      // single-core host: same amortized one-lock-per-shard pattern,
      // no worker threads
      for (int s = 0; s < shard_num; ++s) {
        if (buckets[s].empty()) continue;
        Shard& sh = shards[s];
        std::lock_guard<std::mutex> lk(sh.mu);
        for (int64_t idx : buckets[s]) fn(sh, idx);
      }
      return;
    }
    int nthreads = std::min<int64_t>(std::min<int64_t>(shard_num, 8), hw);
    std::vector<std::thread> ts;
    ts.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) {
      ts.emplace_back([&, t] {
        for (int s = t; s < shard_num; s += nthreads) {
          if (buckets[s].empty()) continue;
          Shard& sh = shards[s];
          std::lock_guard<std::mutex> lk(sh.mu);
          for (int64_t idx : buckets[s]) fn(sh, idx);
        }
      });
    }
    for (auto& th : ts) th.join();
  }

  int64_t size() { return ram_size() + disk_size(); }

  bool save(const char* path) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return false;
    int64_t n = size();
    // state code: low bits = opt rule (0 sgd / 1 adagrad / 2 adam),
    // +4 = ctr fields present. Codes 0/1 match the pre-ctr format.
    int32_t code = opt_type | (ctr.enabled ? 4 : 0);
    bool ok = std::fwrite(&emb_dim, sizeof(emb_dim), 1, f) == 1 &&
              std::fwrite(&code, sizeof(code), 1, f) == 1 &&
              std::fwrite(&n, sizeof(n), 1, f) == 1;

    auto write_entry = [&](int64_t key, const Entry& e) {
      // the flat [emb|g2|m2] block writes in one call — byte-identical to
      // the historical per-vector format
      const size_t sf = static_cast<size_t>(state_floats());
      ok = ok && std::fwrite(&key, sizeof(int64_t), 1, f) == 1 &&
           std::fwrite(e.data.data(), sizeof(float), sf, f) == sf;
      if (opt_type == OPT_ADAM) {
        ok = ok && std::fwrite(&e.b1p, sizeof(float), 1, f) == 1 &&
             std::fwrite(&e.b2p, sizeof(float), 1, f) == 1;
      }
      if (ctr.enabled) {
        ok = ok && std::fwrite(&e.show, sizeof(float), 1, f) == 1 &&
             std::fwrite(&e.click, sizeof(float), 1, f) == 1 &&
             std::fwrite(&e.unseen_days, sizeof(float), 1, f) == 1;
      }
    };

    for (int si = 0; si < shard_num && ok; ++si) {
      Shard& sh = shards[si];
      std::lock_guard<std::mutex> lk(sh.mu);
      for (const auto& kv : sh.map) {
        write_entry(kv.first, kv.second);
        if (!ok) break;
      }
      if (!ssd || !ok) continue;
      // spilled entries checkpoint in the SAME format: a save/load
      // round-trip is budget-independent
      std::vector<char> buf(ssd->rec_size);
      for (const auto& kv : ssd->shards[si].index) {
        if (::pread(ssd->fd, buf.data(), ssd->rec_size,
                    kv.second * ssd->rec_size) != ssd->rec_size) {
          ok = false;
          break;
        }
        Entry e;
        ssd_decode(buf.data(), &e);
        write_entry(kv.first, e);
        if (!ok) break;
      }
    }
    ok = (std::fclose(f) == 0) && ok;  // disk-full surfaces at flush
    return ok;
  }

  bool load(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    int dim = 0;
    int32_t has_g2 = 0;
    int64_t n = 0;
    if (std::fread(&dim, sizeof(dim), 1, f) != 1 || dim != emb_dim ||
        std::fread(&has_g2, sizeof(has_g2), 1, f) != 1 ||
        std::fread(&n, sizeof(n), 1, f) != 1) {
      std::fclose(f);
      return false;
    }
    // restore replaces the whole table (the reference's load contract):
    // stale post-checkpoint rows must not survive a rewind
    clear_all();
    const int32_t file_opt = has_g2 & 3;  // state code: rule bits + ctr bit
    const bool file_ctr = (has_g2 & 4) != 0;
    bool ok = true;
    for (int64_t i = 0; i < n; ++i) {
      int64_t key;
      if (std::fread(&key, sizeof(key), 1, f) != 1) {
        ok = false;  // truncated checkpoint — fail loudly, not partially
        break;
      }
      Entry e;
      e.data.assign(state_floats(), 0.f);
      // file sections read into the table's flat slots when the table's
      // rule has them, else into scratch (rule-mismatch restores keep the
      // embeddings and drop/zero optimizer state, as before)
      std::vector<float> scratch;
      auto read_block = [&](float* dst) {
        float* p = dst;
        if (p == nullptr) {
          scratch.resize(emb_dim);
          p = scratch.data();
        }
        return std::fread(p, sizeof(float), emb_dim, f) ==
               static_cast<size_t>(emb_dim);
      };
      if (!read_block(emb_of(e))) {
        ok = false;
        break;
      }
      if (file_opt != OPT_SGD &&
          !read_block(opt_type != OPT_SGD ? g2_of(e) : nullptr)) {
        ok = false;
        break;
      }
      if (file_opt == OPT_ADAM) {
        if (!read_block(opt_type == OPT_ADAM ? m2_of(e) : nullptr) ||
            std::fread(&e.b1p, sizeof(float), 1, f) != 1 ||
            std::fread(&e.b2p, sizeof(float), 1, f) != 1) {
          ok = false;
          break;
        }
      }
      if (file_ctr) {
        if (std::fread(&e.show, sizeof(float), 1, f) != 1 ||
            std::fread(&e.click, sizeof(float), 1, f) != 1 ||
            std::fread(&e.unseen_days, sizeof(float), 1, f) != 1) {
          ok = false;
          break;
        }
      }
      int si = shard_of(key);
      Shard& sh = shards[si];
      std::lock_guard<std::mutex> lk(sh.mu);
      if (ssd) e.tick = ssd->clock.fetch_add(1);
      sh.map[key] = std::move(e);
      if (ssd) ssd_spill(si, sh);  // budget holds during restore too
    }
    std::fclose(f);
    if (!ok) clear_all();
    return ok;
  }

  void clear_all() {
    for (int si = 0; si < shard_num; ++si) {
      std::lock_guard<std::mutex> lk(shards[si].mu);
      shards[si].map.clear();
      if (ssd) ssd->shards[si].index.clear();
    }
    if (ssd) {
      std::lock_guard<std::mutex> lk(ssd->alloc_mu);
      ssd->free_slots.clear();
      ssd->next_slot = 0;
      if (::ftruncate(ssd->fd, 0) != 0) {
        // truncate failure leaves dead bytes in the slot file; slots are
        // reallocated from 0 so correctness is unaffected
      }
    }
  }
};

}  // namespace ps
