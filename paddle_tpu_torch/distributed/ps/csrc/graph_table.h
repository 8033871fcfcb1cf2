// Sharded host graph table: adjacency + node features + neighbor sampling.
//
// Reference analogue: paddle/fluid/distributed/ps/table/common_graph_table.h
// (GraphShard/GraphTable: bucketed nodes, weighted neighbor sampling,
// feature nodes) — the storage side of the GNN pipeline whose compute side
// is paddle.incubate.graph_sample_neighbors / graph_send_recv. Single-host
// in-process here; the multi-host extension shards node ids by the same
// hash over the PS wire, exactly like the sparse tables.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace ps {

struct GraphNodeEntry {
  // neighbors with LAZY cumulative weights: cumw stays empty for
  // unweighted graphs (the common GNN case — 8 bytes/edge, and weighted
  // sampling degenerates to uniform-with-replacement); the first
  // weighted edge materializes 1.0-prefix sums for what came before.
  // Weighted sampling is one binary search per draw (the reference
  // builds alias tables; cumulative sums are simpler and equally
  // O(log d)).
  std::vector<int64_t> nbrs;
  std::vector<float> cumw;  // inclusive prefix sums; empty = all-1.0
  std::vector<float> feat;  // optional per-node feature vector
};

struct GraphShardT {
  std::unordered_map<int64_t, GraphNodeEntry> map;
  std::vector<int64_t> ids;  // insertion order, for random_sample_nodes
  std::mutex mu;
};

struct GraphTable {
  int shard_num;
  int feat_dim;
  uint64_t seed;
  std::vector<GraphShardT> shards;

  GraphTable(int nshard, int fdim, uint64_t seed_)
      : shard_num(nshard < 1 ? 1 : nshard),
        feat_dim(fdim < 0 ? 0 : fdim),
        seed(seed_),
        shards(static_cast<size_t>(shard_num)) {}

  int shard_of(int64_t id) const {
    uint64_t h = (static_cast<uint64_t>(id) * 0x9E3779B97F4A7C15ULL) >> 32;
    return static_cast<int>(h % static_cast<uint64_t>(shard_num));
  }

  GraphNodeEntry& ensure(GraphShardT& sh, int64_t id) {
    auto it = sh.map.find(id);
    if (it == sh.map.end()) {
      it = sh.map.emplace(id, GraphNodeEntry{}).first;
      sh.ids.push_back(id);
    }
    return it->second;
  }

  // append directed edges src->dst with weights (nullptr = all 1.0,
  // stored weight-free)
  void add_edges(const int64_t* src, const int64_t* dst, const float* w,
                 int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      GraphShardT& sh = shards[shard_of(src[i])];
      std::lock_guard<std::mutex> lk(sh.mu);
      GraphNodeEntry& e = ensure(sh, src[i]);
      if (w != nullptr && e.cumw.empty() && !e.nbrs.empty()) {
        // first weighted edge after unweighted ones: materialize the
        // implicit all-1.0 prefix for the existing neighbors
        e.cumw.resize(e.nbrs.size());
        for (size_t j = 0; j < e.nbrs.size(); ++j)
          e.cumw[j] = static_cast<float>(j + 1);
      }
      e.nbrs.push_back(dst[i]);
      if (w != nullptr || !e.cumw.empty()) {
        float wi = w ? w[i] : 1.0f;
        float base = e.cumw.empty() ? 0.f : e.cumw.back();
        e.cumw.push_back(base + (wi > 0.f ? wi : 0.f));
      }
    }
  }

  void set_node_feat(const int64_t* ids, int64_t n, const float* feats) {
    for (int64_t i = 0; i < n; ++i) {
      GraphShardT& sh = shards[shard_of(ids[i])];
      std::lock_guard<std::mutex> lk(sh.mu);
      GraphNodeEntry& e = ensure(sh, ids[i]);
      e.feat.assign(feats + i * feat_dim, feats + (i + 1) * feat_dim);
    }
  }

  // out[n * feat_dim]; missing nodes/features read zeros; returns found
  int64_t get_node_feat(const int64_t* ids, int64_t n, float* out) {
    int64_t found = 0;
    for (int64_t i = 0; i < n; ++i) {
      GraphShardT& sh = shards[shard_of(ids[i])];
      std::lock_guard<std::mutex> lk(sh.mu);
      auto it = sh.map.find(ids[i]);
      if (it == sh.map.end() ||
          static_cast<int>(it->second.feat.size()) != feat_dim) {
        std::memset(out + i * feat_dim, 0, sizeof(float) * feat_dim);
      } else {
        std::memcpy(out + i * feat_dim, it->second.feat.data(),
                    sizeof(float) * feat_dim);
        ++found;
      }
    }
    return found;
  }

  int64_t degree(int64_t id) {
    GraphShardT& sh = shards[shard_of(id)];
    std::lock_guard<std::mutex> lk(sh.mu);
    auto it = sh.map.find(id);
    return it == sh.map.end()
               ? 0
               : static_cast<int64_t>(it->second.nbrs.size());
  }

  // sample up to k neighbors per node (reference: graph_neighbor_sample).
  // weighted=true draws by edge weight WITH replacement (cumulative-sum
  // binary search); weighted=false draws uniformly WITHOUT replacement
  // (partial Fisher-Yates over an index scratch). k >= degree returns the
  // whole neighborhood. out_nbrs[n*k] padded with -1; out_cnt[n] real
  // counts.
  void sample_neighbors(const int64_t* ids, int64_t n, int k, bool weighted,
                        uint64_t call_seed, int64_t* out_nbrs,
                        int32_t* out_cnt) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t* row = out_nbrs + i * k;
      std::fill(row, row + k, int64_t(-1));
      GraphShardT& sh = shards[shard_of(ids[i])];
      std::lock_guard<std::mutex> lk(sh.mu);
      auto it = sh.map.find(ids[i]);
      if (it == sh.map.end() || it->second.nbrs.empty()) {
        out_cnt[i] = 0;
        continue;
      }
      const GraphNodeEntry& e = it->second;
      const int d = static_cast<int>(e.nbrs.size());
      std::mt19937_64 gen(seed ^ call_seed ^
                          (static_cast<uint64_t>(ids[i]) * 0x9E3779B9ULL));
      if (d <= k && !weighted) {
        std::memcpy(row, e.nbrs.data(), sizeof(int64_t) * d);
        out_cnt[i] = d;
        continue;
      }
      if (weighted) {
        if (e.cumw.empty()) {
          // unweighted node: weighted semantics = uniform WITH
          // replacement, no prefix array needed
          std::uniform_int_distribution<int> pick(0, d - 1);
          for (int j = 0; j < k; ++j) row[j] = e.nbrs[pick(gen)];
          out_cnt[i] = k;
          continue;
        }
        const float total = e.cumw.back();
        if (total <= 0.f) {
          // every edge weight was <= 0: nothing is samplable (a clamped
          // zero-weight edge must have probability 0, not fallback 1)
          out_cnt[i] = 0;
          continue;
        }
        std::uniform_real_distribution<float> dist(0.f, total);
        for (int j = 0; j < k; ++j) {
          float r = dist(gen);
          auto pos = std::upper_bound(e.cumw.begin(), e.cumw.end(), r);
          int idx = static_cast<int>(pos - e.cumw.begin());
          if (idx >= d) idx = d - 1;
          row[j] = e.nbrs[idx];
        }
        out_cnt[i] = k;
      } else if (k * 4 < d) {
        // hub nodes, k << d: Floyd's distinct-sample — O(k) memory and
        // draws, no O(degree) scratch per call
        std::unordered_set<int> sel;
        sel.reserve(static_cast<size_t>(k) * 2);
        int j2 = 0;
        for (int j = d - k; j < d; ++j) {
          std::uniform_int_distribution<int> pick(0, j);
          int t = pick(gen);
          int chosen = sel.count(t) ? j : t;
          sel.insert(chosen);
          row[j2++] = e.nbrs[chosen];
        }
        out_cnt[i] = k;
      } else {
        // partial Fisher-Yates: k distinct indices of d
        std::vector<int> scratch(d);
        for (int j = 0; j < d; ++j) scratch[j] = j;
        for (int j = 0; j < k; ++j) {
          std::uniform_int_distribution<int> pick(j, d - 1);
          std::swap(scratch[j], scratch[pick(gen)]);
          row[j] = e.nbrs[scratch[j]];
        }
        out_cnt[i] = k;
      }
    }
  }

  // `count` node ids drawn (approximately uniformly) across shards —
  // traversal starts (reference: graph_table random_sample_nodes).
  // Size-weighted shard draws + per-shard indexing: O(count·log) with a
  // small dedup set, never an O(total_nodes) copy per call (10M-node
  // graphs sample seeds every minibatch).
  int64_t random_sample_nodes(int64_t count, uint64_t call_seed,
                              int64_t* out) {
    std::vector<int64_t> prefix(shards.size());
    int64_t total = 0;
    for (size_t s = 0; s < shards.size(); ++s) {
      std::lock_guard<std::mutex> lk(shards[s].mu);
      total += static_cast<int64_t>(shards[s].ids.size());
      prefix[s] = total;
    }
    if (total == 0) return 0;
    std::mt19937_64 gen(seed ^ call_seed);
    const int64_t m = std::min(count, total);
    std::unordered_set<int64_t> taken;  // drawn global indices
    int64_t written = 0;
    // rejection on duplicates: cheap while m << total, and bounded by
    // the classic coupon argument otherwise (m == total degenerates to
    // a full sweep below)
    int64_t attempts = 0;
    const int64_t max_attempts = m * 20 + 64;
    std::uniform_int_distribution<int64_t> pick(0, total - 1);
    while (written < m && attempts < max_attempts) {
      ++attempts;
      int64_t g = pick(gen);
      if (!taken.insert(g).second) continue;
      size_t s = static_cast<size_t>(
          std::upper_bound(prefix.begin(), prefix.end(), g) -
          prefix.begin());
      int64_t local = g - (s == 0 ? 0 : prefix[s - 1]);
      std::lock_guard<std::mutex> lk(shards[s].mu);
      if (local >= static_cast<int64_t>(shards[s].ids.size())) continue;
      out[written++] = shards[s].ids[static_cast<size_t>(local)];
    }
    if (written < m) {
      // duplicate-rejection stalled (m close to total): finish with a
      // deterministic sweep over indices not yet taken
      for (int64_t g = 0; g < total && written < m; ++g) {
        if (taken.count(g)) continue;
        size_t s = static_cast<size_t>(
            std::upper_bound(prefix.begin(), prefix.end(), g) -
            prefix.begin());
        int64_t local = g - (s == 0 ? 0 : prefix[s - 1]);
        std::lock_guard<std::mutex> lk(shards[s].mu);
        if (local >= static_cast<int64_t>(shards[s].ids.size())) continue;
        out[written++] = shards[s].ids[static_cast<size_t>(local)];
      }
    }
    return written;
  }

  // checkpoint format: magic, feat_dim, node count, then per node:
  // id, n_nbrs, nbrs[], has_cumw, [cumw[]], n_feat, [feat[]]
  // (reference: common_graph_table's load/save over edge/feature files)
  bool save(const char* path) {
    // write-to-temp + rename: a failed/interrupted save must never
    // destroy the previous good checkpoint
    std::string tmp = std::string(path) + ".tmp";
    FILE* f = std::fopen(tmp.c_str(), "wb");
    if (!f) return false;
    const uint32_t magic = 0x47545631;  // "GTV1"
    int64_t n = node_count();
    bool ok = std::fwrite(&magic, 4, 1, f) == 1 &&
              std::fwrite(&feat_dim, 4, 1, f) == 1 &&
              std::fwrite(&n, 8, 1, f) == 1;
    for (auto& sh : shards) {
      if (!ok) break;
      std::lock_guard<std::mutex> lk(sh.mu);
      for (int64_t id : sh.ids) {
        const GraphNodeEntry& e = sh.map.at(id);
        int64_t nn = static_cast<int64_t>(e.nbrs.size());
        uint8_t has_w = e.cumw.empty() ? 0 : 1;
        int32_t nf = static_cast<int32_t>(e.feat.size());
        ok = ok && std::fwrite(&id, 8, 1, f) == 1 &&
             std::fwrite(&nn, 8, 1, f) == 1 &&
             (nn == 0 || std::fwrite(e.nbrs.data(), 8, nn, f) ==
                             static_cast<size_t>(nn)) &&
             std::fwrite(&has_w, 1, 1, f) == 1 &&
             (!has_w || std::fwrite(e.cumw.data(), 4, nn, f) ==
                            static_cast<size_t>(nn)) &&
             std::fwrite(&nf, 4, 1, f) == 1 &&
             (nf == 0 || std::fwrite(e.feat.data(), 4, nf, f) ==
                             static_cast<size_t>(nf));
        if (!ok) break;
      }
    }
    ok = (std::fclose(f) == 0) && ok;
    if (ok) ok = std::rename(tmp.c_str(), path) == 0;
    if (!ok) std::remove(tmp.c_str());
    return ok;
  }

  bool load(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    // file size bounds every on-disk count: a corrupt header must fail
    // with `false`, never with a bad_alloc escaping the C ABI
    std::fseek(f, 0, SEEK_END);
    const long fsize = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    uint32_t magic = 0;
    int fdim = 0;
    int64_t n = 0;
    if (fsize < 16 || std::fread(&magic, 4, 1, f) != 1 ||
        magic != 0x47545631 || std::fread(&fdim, 4, 1, f) != 1 ||
        fdim != feat_dim || std::fread(&n, 8, 1, f) != 1 || n < 0 ||
        n > fsize) {
      std::fclose(f);
      return false;
    }
    for (auto& sh : shards) {
      std::lock_guard<std::mutex> lk(sh.mu);
      sh.map.clear();
      sh.ids.clear();
    }
    bool ok = true;
    for (int64_t i = 0; i < n && ok; ++i) {
      int64_t id = 0, nn = 0;
      uint8_t has_w = 0;
      int32_t nf = 0;
      GraphNodeEntry e;
      ok = std::fread(&id, 8, 1, f) == 1 && std::fread(&nn, 8, 1, f) == 1 &&
           nn >= 0 && nn <= fsize / 8;
      if (ok && nn > 0) {
        e.nbrs.resize(static_cast<size_t>(nn));
        ok = std::fread(e.nbrs.data(), 8, nn, f) ==
             static_cast<size_t>(nn);
      }
      ok = ok && std::fread(&has_w, 1, 1, f) == 1;
      if (ok && has_w) {
        e.cumw.resize(static_cast<size_t>(nn));
        ok = std::fread(e.cumw.data(), 4, nn, f) ==
             static_cast<size_t>(nn);
      }
      ok = ok && std::fread(&nf, 4, 1, f) == 1 && nf >= 0 &&
           nf <= fsize / 4;
      if (ok && nf > 0) {
        e.feat.resize(static_cast<size_t>(nf));
        ok = std::fread(e.feat.data(), 4, nf, f) ==
             static_cast<size_t>(nf);
      }
      if (ok) {
        GraphShardT& sh = shards[shard_of(id)];
        std::lock_guard<std::mutex> lk(sh.mu);
        sh.map[id] = std::move(e);
        sh.ids.push_back(id);
      }
    }
    std::fclose(f);
    if (!ok)  // truncated checkpoint: fail loudly with an empty table
      for (auto& sh : shards) {
        std::lock_guard<std::mutex> lk(sh.mu);
        sh.map.clear();
        sh.ids.clear();
      }
    return ok;
  }

  int64_t node_count() {
    int64_t s = 0;
    for (auto& sh : shards) {
      std::lock_guard<std::mutex> lk(sh.mu);
      s += static_cast<int64_t>(sh.map.size());
    }
    return s;
  }

  int64_t edge_count() {
    int64_t s = 0;
    for (auto& sh : shards) {
      std::lock_guard<std::mutex> lk(sh.mu);
      for (auto& kv : sh.map)
        s += static_cast<int64_t>(kv.second.nbrs.size());
    }
    return s;
  }
};

}  // namespace ps
