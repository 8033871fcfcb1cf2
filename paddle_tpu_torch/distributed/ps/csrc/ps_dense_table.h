// Dense parameter table chunk — the server-resident dense weights of the
// parameter-server training mode.
//
// Reference analogue: paddle/fluid/distributed/ps/table/memory_dense_table.h
// (fixed-size dense param block with an optimizer rule applied on
// push_dense_grad: sgd / adam / summary). Each PsService process owns one
// contiguous chunk of every dense table; the client shards by even ranges.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace ps {

enum DenseOptType : int32_t {
  DENSE_OPT_SGD = 0,
  DENSE_OPT_ADAM = 1,
  DENSE_OPT_SUM = 2,  // "summary" rule: value += grad (counters/stats)
};

struct DenseTable {
  int32_t opt_type;
  float lr;
  // adam hypers (reference memory_dense_table defaults)
  float beta1 = 0.9f, beta2 = 0.999f, eps = 1e-8f;
  std::vector<float> data;
  std::vector<float> m1, m2;  // adam moments
  double beta1_pow = 1.0, beta2_pow = 1.0;
  std::mutex mu;

  DenseTable(int32_t opt, float lr_, int64_t len, const float* init)
      : opt_type(opt), lr(lr_), data(len, 0.f) {
    if (init) std::memcpy(data.data(), init, sizeof(float) * len);
    if (opt_type == DENSE_OPT_ADAM) {
      m1.assign(len, 0.f);
      m2.assign(len, 0.f);
    }
  }

  void pull(float* out) {
    std::lock_guard<std::mutex> lk(mu);
    std::memcpy(out, data.data(), sizeof(float) * data.size());
  }

  void set(const float* vals) {
    std::lock_guard<std::mutex> lk(mu);
    std::memcpy(data.data(), vals, sizeof(float) * data.size());
  }

  void push(const float* grad) {
    std::lock_guard<std::mutex> lk(mu);
    const int64_t n = static_cast<int64_t>(data.size());
    if (opt_type == DENSE_OPT_ADAM) {
      beta1_pow *= beta1;
      beta2_pow *= beta2;
      const float lr_t =
          lr * std::sqrt(1.0 - beta2_pow) / (1.0 - beta1_pow);
      for (int64_t i = 0; i < n; ++i) {
        m1[i] = beta1 * m1[i] + (1.f - beta1) * grad[i];
        m2[i] = beta2 * m2[i] + (1.f - beta2) * grad[i] * grad[i];
        data[i] -= lr_t * m1[i] / (std::sqrt(m2[i]) + eps);
      }
    } else if (opt_type == DENSE_OPT_SUM) {
      for (int64_t i = 0; i < n; ++i) data[i] += grad[i];
    } else {
      for (int64_t i = 0; i < n; ++i) data[i] -= lr * grad[i];
    }
  }
};

}  // namespace ps
