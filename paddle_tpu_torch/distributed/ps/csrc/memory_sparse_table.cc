// MemorySparseTable C ABI — in-process facade over the sharded sparse table
// (table logic lives in ps_sparse_table.h, shared with the networked
// PsService in ps_server.cc / ps_client.cc).
//
// Reference analogue: paddle/fluid/distributed/ps/table/memory_sparse_table.cc
// and ps/table/sparse_sgd_rule.cc. Exposed as a C ABI for ctypes (the
// framework's pybind replacement).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC memory_sparse_table.cc -o libps_table.so -lpthread

#include "graph_table.h"
#include "ps_sparse_table.h"

using ps::GraphTable;
using ps::SparseTable;

extern "C" {

void* ps_table_create(int emb_dim, int shard_num, int opt_type, float lr,
                      float init_range, uint64_t seed) {
  return new SparseTable(emb_dim, shard_num, opt_type, lr, init_range, seed);
}

void ps_table_destroy(void* h) { delete static_cast<SparseTable*>(h); }

void ps_table_pull(void* h, const int64_t* keys, int64_t n, float* out,
                   int create) {
  static_cast<SparseTable*>(h)->pull(keys, n, out, create != 0);
}

void ps_table_push(void* h, const int64_t* keys, int64_t n,
                   const float* grads) {
  static_cast<SparseTable*>(h)->push(keys, n, grads);
}

void ps_table_push_raw(void* h, const int64_t* keys, int64_t n,
                       const float* deltas) {
  static_cast<SparseTable*>(h)->push(keys, n, deltas, /*raw=*/true);
}

int64_t ps_table_size(void* h) { return static_cast<SparseTable*>(h)->size(); }

int ps_table_save(void* h, const char* path) {
  return static_cast<SparseTable*>(h)->save(path) ? 0 : -1;
}

int ps_table_load(void* h, const char* path) {
  return static_cast<SparseTable*>(h)->load(path) ? 0 : -1;
}

void ps_table_set_lr(void* h, float lr) {
  static_cast<SparseTable*>(h)->lr = lr;
}

// -- CTR accessor surface (reference: ctr_accessor.h CtrCommonAccessor) ----
void ps_table_set_ctr(void* h, float show_coeff, float click_coeff,
                      float decay_rate, float delete_threshold,
                      float delete_after_unseen_days) {
  auto* t = static_cast<SparseTable*>(h);
  t->ctr.enabled = true;
  t->ctr.show_coeff = show_coeff;
  t->ctr.click_coeff = click_coeff;
  t->ctr.decay_rate = decay_rate;
  t->ctr.delete_threshold = delete_threshold;
  t->ctr.delete_after_unseen_days = delete_after_unseen_days;
}

void ps_table_push_ctr(void* h, const int64_t* keys, int64_t n,
                       const float* shows, const float* clicks,
                       const float* grads) {
  static_cast<SparseTable*>(h)->push_ctr(keys, n, shows, clicks, grads);
}

int64_t ps_table_shrink(void* h) {
  return static_cast<SparseTable*>(h)->shrink();
}

int ps_table_ctr_stats(void* h, int64_t key, float* out4) {
  return static_cast<SparseTable*>(h)->ctr_stats(key, out4) ? 0 : -1;
}

// -- SSD overflow (reference: ps/table/ssd_sparse_table.h) ------------------
// Entries past ram_budget spill to a fixed-record slot file; all other
// ps_table_* calls work unchanged (pull/push promote from disk). Call after
// ps_table_set_ctr — the record layout freezes here.
int ps_table_enable_ssd(void* h, const char* path, int64_t ram_budget) {
  return static_cast<SparseTable*>(h)->enable_ssd(path, ram_budget) ? 0 : -1;
}

int64_t ps_table_ram_size(void* h) {
  return static_cast<SparseTable*>(h)->ram_size();
}

int64_t ps_table_disk_size(void* h) {
  return static_cast<SparseTable*>(h)->disk_size();
}

// -- graph table (reference: ps/table/common_graph_table.h) -----------------
void* ps_graph_create(int shard_num, int feat_dim, uint64_t seed) {
  return new GraphTable(shard_num, feat_dim, seed);
}

void ps_graph_destroy(void* h) { delete static_cast<GraphTable*>(h); }

void ps_graph_add_edges(void* h, const int64_t* src, const int64_t* dst,
                        const float* w, int64_t n) {
  static_cast<GraphTable*>(h)->add_edges(src, dst, w, n);
}

void ps_graph_set_node_feat(void* h, const int64_t* ids, int64_t n,
                            const float* feats) {
  static_cast<GraphTable*>(h)->set_node_feat(ids, n, feats);
}

int64_t ps_graph_get_node_feat(void* h, const int64_t* ids, int64_t n,
                               float* out) {
  return static_cast<GraphTable*>(h)->get_node_feat(ids, n, out);
}

int64_t ps_graph_degree(void* h, int64_t id) {
  return static_cast<GraphTable*>(h)->degree(id);
}

void ps_graph_sample_neighbors(void* h, const int64_t* ids, int64_t n,
                               int k, int weighted, uint64_t call_seed,
                               int64_t* out_nbrs, int32_t* out_cnt) {
  static_cast<GraphTable*>(h)->sample_neighbors(ids, n, k, weighted != 0,
                                                call_seed, out_nbrs,
                                                out_cnt);
}

int64_t ps_graph_random_sample_nodes(void* h, int64_t count,
                                     uint64_t call_seed, int64_t* out) {
  return static_cast<GraphTable*>(h)->random_sample_nodes(count, call_seed,
                                                          out);
}

int64_t ps_graph_node_count(void* h) {
  return static_cast<GraphTable*>(h)->node_count();
}

int64_t ps_graph_edge_count(void* h) {
  return static_cast<GraphTable*>(h)->edge_count();
}

int ps_graph_save(void* h, const char* path) {
  return static_cast<GraphTable*>(h)->save(path) ? 0 : -1;
}

int ps_graph_load(void* h, const char* path) {
  return static_cast<GraphTable*>(h)->load(path) ? 0 : -1;
}

}  // extern "C"
