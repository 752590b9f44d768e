// Host-side neighbor engine: kd-tree radius/kNN queries and
// locality orderings.
//
// The reference depends on out-of-tree trees for these (sklearn BallTree
// radius queries feeding sparse covariance assembly, kernels.py:131-144;
// scipy cKDTree 1-NN ordering, utils.py:36-56). Here they are an in-tree
// C++ component with a C ABI consumed through ctypes
// (george_tpu/native/kdtree.py). Everything is preprocessing: only index
// arrays (CSR neighbor lists, permutations) cross to the device.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <vector>

namespace {

struct KDTree {
  const double* x;       // (n, d) row-major, borrowed
  int64_t n, d;
  std::vector<int64_t> idx;     // point indices in tree order
  std::vector<int64_t> left;    // node -> left child (-1 leaf)
  std::vector<int64_t> right;
  std::vector<int64_t> start, end;  // node -> range in idx
  std::vector<int64_t> axis;
  std::vector<double> split;
  static const int64_t LEAF = 16;

  double coord(int64_t i, int64_t ax) const { return x[i * d + ax]; }

  int64_t build(int64_t s, int64_t e) {
    int64_t node = (int64_t)left.size();
    left.push_back(-1);
    right.push_back(-1);
    start.push_back(s);
    end.push_back(e);
    axis.push_back(-1);
    split.push_back(0.0);
    if (e - s <= LEAF) return node;

    // split on the axis with the largest spread
    int64_t best_ax = 0;
    double best_spread = -1.0;
    for (int64_t ax = 0; ax < d; ++ax) {
      double lo = coord(idx[s], ax), hi = lo;
      for (int64_t i = s + 1; i < e; ++i) {
        double v = coord(idx[i], ax);
        lo = std::min(lo, v);
        hi = std::max(hi, v);
      }
      if (hi - lo > best_spread) {
        best_spread = hi - lo;
        best_ax = ax;
      }
    }
    int64_t mid = s + (e - s) / 2;
    std::nth_element(
        idx.begin() + s, idx.begin() + mid, idx.begin() + e,
        [&](int64_t a, int64_t b) {
          return coord(a, best_ax) < coord(b, best_ax);
        });
    axis[node] = best_ax;
    split[node] = coord(idx[mid], best_ax);
    int64_t l = build(s, mid);
    int64_t r = build(mid, e);
    left[node] = l;
    right[node] = r;
    return node;
  }

  double dist2(const double* q, int64_t i) const {
    double s2 = 0.0;
    for (int64_t ax = 0; ax < d; ++ax) {
      double diff = q[ax] - coord(i, ax);
      s2 += diff * diff;
    }
    return s2;
  }

  void radius(const double* q, double r2, int64_t node,
              std::vector<int64_t>& out) const {
    if (left[node] < 0) {
      for (int64_t i = start[node]; i < end[node]; ++i)
        if (dist2(q, idx[i]) <= r2) out.push_back(idx[i]);
      return;
    }
    double diff = q[axis[node]] - split[node];
    if (diff <= 0) {
      radius(q, r2, left[node], out);
      if (diff * diff <= r2) radius(q, r2, right[node], out);
    } else {
      radius(q, r2, right[node], out);
      if (diff * diff <= r2) radius(q, r2, left[node], out);
    }
  }

  void knn(const double* q, int64_t k, int64_t node,
           std::priority_queue<std::pair<double, int64_t>>& heap) const {
    if (left[node] < 0) {
      for (int64_t i = start[node]; i < end[node]; ++i) {
        double d2 = dist2(q, idx[i]);
        if ((int64_t)heap.size() < k) {
          heap.emplace(d2, idx[i]);
        } else if (d2 < heap.top().first) {
          heap.pop();
          heap.emplace(d2, idx[i]);
        }
      }
      return;
    }
    double diff = q[axis[node]] - split[node];
    int64_t near = diff <= 0 ? left[node] : right[node];
    int64_t far = diff <= 0 ? right[node] : left[node];
    knn(q, k, near, heap);
    if ((int64_t)heap.size() < k || diff * diff < heap.top().first)
      knn(q, k, far, heap);
  }
};

}  // namespace

extern "C" {

void* kd_build(const double* x, int64_t n, int64_t d) {
  KDTree* t = new KDTree();
  t->x = x;
  t->n = n;
  t->d = d;
  t->idx.resize(n);
  std::iota(t->idx.begin(), t->idx.end(), 0);
  if (n > 0) t->build(0, n);
  return t;
}

void kd_free(void* tree) { delete static_cast<KDTree*>(tree); }

// Pass 1: per-query neighbor counts within radius r.
void kd_radius_count(void* tree, const double* q, int64_t nq, double r,
                     int64_t* counts) {
  KDTree* t = static_cast<KDTree*>(tree);
  std::vector<int64_t> buf;
  for (int64_t i = 0; i < nq; ++i) {
    buf.clear();
    t->radius(q + i * t->d, r * r, 0, buf);
    counts[i] = (int64_t)buf.size();
  }
}

// Pass 2: fill sorted neighbor indices into the CSR layout.
void kd_radius_fill(void* tree, const double* q, int64_t nq, double r,
                    const int64_t* row_ptr, int64_t* nbr_idx) {
  KDTree* t = static_cast<KDTree*>(tree);
  std::vector<int64_t> buf;
  for (int64_t i = 0; i < nq; ++i) {
    buf.clear();
    t->radius(q + i * t->d, r * r, 0, buf);
    std::sort(buf.begin(), buf.end());
    std::memcpy(nbr_idx + row_ptr[i], buf.data(),
                buf.size() * sizeof(int64_t));
  }
}

// k nearest neighbors (self included), ascending by distance.
void kd_knn(void* tree, const double* q, int64_t nq, int64_t k,
            int64_t* out_idx) {
  KDTree* t = static_cast<KDTree*>(tree);
  for (int64_t i = 0; i < nq; ++i) {
    std::priority_queue<std::pair<double, int64_t>> heap;
    t->knn(q + i * t->d, k, 0, heap);
    int64_t m = (int64_t)heap.size();
    for (int64_t j = m - 1; j >= 0; --j) {
      out_idx[i * k + j] = heap.top().second;
      heap.pop();
    }
    // fewer points than k: pad with the nearest (index 0 of the row)
    for (int64_t j = m; j < k; ++j) out_idx[i * k + j] = out_idx[i * k];
  }
}

// Distance-from-first-sample ordering (reference utils.py:36-56 semantics).
void kd_nd_sort(const double* x, int64_t n, int64_t d, int64_t* perm) {
  std::vector<std::pair<double, int64_t>> key(n);
  for (int64_t i = 0; i < n; ++i) {
    double s2 = 0.0;
    for (int64_t ax = 0; ax < d; ++ax) {
      double diff = x[i * d + ax] - x[ax];
      s2 += diff * diff;
    }
    key[i] = {s2, i};
  }
  std::stable_sort(key.begin(), key.end());
  for (int64_t i = 0; i < n; ++i) perm[i] = key[i].second;
}

// Morton (Z-order) ordering for hierarchical-solver locality; quantizes
// each axis to `bits` bits and interleaves (neighbors.py fallback parity).
void kd_morton_sort(const double* x, int64_t n, int64_t d, int64_t bits,
                    int64_t* perm) {
  std::vector<double> lo(d, 1e300), hi(d, -1e300);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t ax = 0; ax < d; ++ax) {
      lo[ax] = std::min(lo[ax], x[i * d + ax]);
      hi[ax] = std::max(hi[ax], x[i * d + ax]);
    }
  std::vector<std::pair<uint64_t, int64_t>> key(n);
  uint64_t maxq = (1ull << bits) - 1;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t code = 0;
    for (int64_t b = 0; b < bits && (int64_t)(b * d) < 63; ++b)
      for (int64_t ax = 0; ax < d; ++ax) {
        double span = hi[ax] > lo[ax] ? hi[ax] - lo[ax] : 1.0;
        uint64_t q = (uint64_t)((x[i * d + ax] - lo[ax]) / span * maxq);
        if (q > maxq) q = maxq;
        code |= ((q >> b) & 1ull) << (b * d + ax);
      }
    key[i] = {code, i};
  }
  std::stable_sort(key.begin(), key.end());
  for (int64_t i = 0; i < n; ++i) perm[i] = key[i].second;
}

}  // extern "C"
