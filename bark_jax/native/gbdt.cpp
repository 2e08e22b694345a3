// Native gradient-boosted-tree booster for the LeafGP import path.
//
// The reference delegates booster fitting to LightGBM's C++ core
// (src/bark/fitting/lgbm_fitting.py:15-47); this is the framework's own
// native equivalent: an exact greedy least-squares GBDT with
// LightGBM-style categorical handling (categories sorted by mean residual,
// optimal prefix-subset split -> arbitrary-subset bitmask), emitting trees
// directly in the flat free-list node encoding used by bark_jax.forest
// (fields mirror src/bark/forest.py:8-19).
//
// Single translation unit, no dependencies; built with
//   g++ -O3 -march=native -shared -fPIC gbdt.cpp -o libbarkgbdt.so
// and loaded via ctypes (bark_jax/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

constexpr int FEAT_CAT = 0;

struct TreeOut {
  uint8_t* is_leaf;
  int32_t* feature;
  float* threshold;
  int32_t* left;
  int32_t* right;
  int32_t* parent;
  int32_t* depth;
  uint8_t* active;
  float* leaf_value;
};

struct SplitResult {
  bool found = false;
  int feat = -1;
  float threshold = 0.0f;  // bitmask (as float) for categorical features
  double gain = 0.0;
};

struct FitCtx {
  const float* X;  // (n, d) row-major
  int n, d;
  const int32_t* feat_types;
  const int32_t* cat_sizes;
  int max_depth;
  int min_samples_leaf;
  int node_limit;
  std::vector<double> resid;    // current residuals (gradients for L2 loss)
  std::vector<int> idx;         // per-tree working index buffer
  std::vector<int> scratch;     // partition scratch
};

// Best split of node rows [lo, hi) in ctx.idx; variance-reduction gain.
SplitResult best_split(FitCtx& ctx, int lo, int hi) {
  SplitResult best;
  const int cnt = hi - lo;
  if (cnt < 2 * ctx.min_samples_leaf) return best;

  double sum = 0.0;
  for (int i = lo; i < hi; ++i) sum += ctx.resid[ctx.idx[i]];
  const double parent_score = sum * sum / cnt;

  std::vector<int> order(ctx.idx.begin() + lo, ctx.idx.begin() + hi);

  for (int f = 0; f < ctx.d; ++f) {
    if (ctx.feat_types[f] == FEAT_CAT) {
      const int k = ctx.cat_sizes[f];
      if (k < 2 || k > 24) continue;  // bitmask must be float32-exact
      std::vector<double> csum(k, 0.0);
      std::vector<int> ccnt(k, 0);
      for (int i = lo; i < hi; ++i) {
        const int row = ctx.idx[i];
        const int c = (int)ctx.X[(size_t)row * ctx.d + f];
        if (c < 0 || c >= k) continue;
        csum[c] += ctx.resid[row];
        ccnt[c] += 1;
      }
      // LightGBM trick: for L2 loss the optimal subset split is a prefix of
      // categories sorted by mean residual.
      std::vector<int> cats;
      for (int c = 0; c < k; ++c)
        if (ccnt[c] > 0) cats.push_back(c);
      if (cats.size() < 2) continue;
      std::sort(cats.begin(), cats.end(), [&](int a, int b) {
        return csum[a] / ccnt[a] < csum[b] / ccnt[b];
      });
      double lsum = 0.0;
      int lcnt = 0;
      uint32_t mask = 0;
      for (size_t j = 0; j + 1 < cats.size(); ++j) {
        const int c = cats[j];
        lsum += csum[c];
        lcnt += ccnt[c];
        mask |= (1u << c);
        const int rcnt = cnt - lcnt;
        if (lcnt < ctx.min_samples_leaf || rcnt < ctx.min_samples_leaf)
          continue;
        const double rsum = sum - lsum;
        const double gain =
            lsum * lsum / lcnt + rsum * rsum / rcnt - parent_score;
        if (gain > best.gain + 1e-12) {
          best.found = true;
          best.gain = gain;
          best.feat = f;
          best.threshold = (float)mask;
        }
      }
    } else {
      // numeric (cont/int): sort node rows by feature value, scan prefixes
      std::sort(order.begin(), order.end(), [&](int a, int b) {
        return ctx.X[(size_t)a * ctx.d + f] < ctx.X[(size_t)b * ctx.d + f];
      });
      double lsum = 0.0;
      for (int j = 0; j + 1 < cnt; ++j) {
        const int row = order[j];
        lsum += ctx.resid[row];
        const float v = ctx.X[(size_t)row * ctx.d + f];
        const float vnext = ctx.X[(size_t)order[j + 1] * ctx.d + f];
        if (!(v < vnext)) continue;  // tied values cannot separate
        const int lcnt = j + 1, rcnt = cnt - lcnt;
        if (lcnt < ctx.min_samples_leaf || rcnt < ctx.min_samples_leaf)
          continue;
        const double rsum = sum - lsum;
        const double gain =
            lsum * lsum / lcnt + rsum * rsum / rcnt - parent_score;
        if (gain > best.gain + 1e-12) {
          best.found = true;
          best.gain = gain;
          best.feat = f;
          // split rule is x <= t (src/bark/forest.py:42); the left value is
          // an exact representative (int features stay integral)
          best.threshold =
              ctx.feat_types[f] == 1 ? v : 0.5f * (v + vnext);
        }
      }
    }
  }
  return best;
}

bool goes_left(const FitCtx& ctx, int row, int f, float thr) {
  const float x = ctx.X[(size_t)row * ctx.d + f];
  if (ctx.feat_types[f] == FEAT_CAT)
    return ((1u << (uint32_t)x) & (uint32_t)thr) != 0;
  return x <= thr;
}

// Recursively grow one tree into the flat output arrays; returns false on
// node-limit overflow.
bool grow(FitCtx& ctx, TreeOut& out, int node, int lo, int hi, int dep,
          int& next_slot, float learning_rate) {
  out.active[node] = 1;
  out.depth[node] = dep;
  const int cnt = hi - lo;

  SplitResult split;
  if (dep < ctx.max_depth && cnt >= 2 * ctx.min_samples_leaf)
    split = best_split(ctx, lo, hi);

  if (!split.found) {
    double sum = 0.0;
    for (int i = lo; i < hi; ++i) sum += ctx.resid[ctx.idx[i]];
    out.is_leaf[node] = 1;
    out.leaf_value[node] = (float)(learning_rate * sum / std::max(cnt, 1));
    return true;
  }

  // stable partition into scratch, preserving order within sides
  int nl = 0;
  for (int i = lo; i < hi; ++i)
    if (goes_left(ctx, ctx.idx[i], split.feat, split.threshold))
      ctx.scratch[nl++] = ctx.idx[i];
  int nr = nl;
  for (int i = lo; i < hi; ++i)
    if (!goes_left(ctx, ctx.idx[i], split.feat, split.threshold))
      ctx.scratch[nr++] = ctx.idx[i];
  std::copy(ctx.scratch.begin(), ctx.scratch.begin() + cnt,
            ctx.idx.begin() + lo);

  const int li = next_slot++, ri = next_slot++;
  if (ri >= ctx.node_limit) return false;
  out.feature[node] = split.feat;
  out.threshold[node] = split.threshold;
  out.left[node] = li;
  out.right[node] = ri;
  out.parent[li] = node;
  out.parent[ri] = node;
  if (!grow(ctx, out, li, lo, lo + nl, dep + 1, next_slot, learning_rate))
    return false;
  return grow(ctx, out, ri, lo + nl, hi, dep + 1, next_slot, learning_rate);
}

int route(const FitCtx& ctx, const TreeOut& out, int row) {
  int node = 0;
  while (!out.is_leaf[node])
    node = goes_left(ctx, row, out.feature[node], out.threshold[node])
               ? out.left[node]
               : out.right[node];
  return node;
}

}  // namespace

extern "C" {

// Fits num_rounds depth-limited least-squares trees to (X, y). Output arrays
// are caller-allocated with shape (num_rounds, node_limit) in C order and
// zero-initialized by the callee. Returns 0 on success, -1 on node overflow.
int bark_gbdt_fit(const float* X, const float* y, int n, int d,
                  const int32_t* feat_types, const int32_t* cat_sizes,
                  int num_rounds, int max_depth, float learning_rate,
                  int node_limit, int min_samples_leaf, uint8_t* is_leaf,
                  int32_t* feature, float* threshold, int32_t* left,
                  int32_t* right, int32_t* parent, int32_t* depth,
                  uint8_t* active, float* leaf_value) {
  FitCtx ctx;
  ctx.X = X;
  ctx.n = n;
  ctx.d = d;
  ctx.feat_types = feat_types;
  ctx.cat_sizes = cat_sizes;
  ctx.max_depth = max_depth;
  ctx.min_samples_leaf = std::max(min_samples_leaf, 1);
  ctx.node_limit = node_limit;
  ctx.resid.assign(y, y + n);
  ctx.idx.resize(n);
  ctx.scratch.resize(n);

  const size_t per = (size_t)node_limit;
  std::memset(is_leaf, 0, per * num_rounds);
  std::memset(active, 0, per * num_rounds);
  std::memset(feature, 0, per * num_rounds * sizeof(int32_t));
  std::memset(threshold, 0, per * num_rounds * sizeof(float));
  std::memset(left, 0, per * num_rounds * sizeof(int32_t));
  std::memset(right, 0, per * num_rounds * sizeof(int32_t));
  std::memset(parent, 0, per * num_rounds * sizeof(int32_t));
  std::memset(depth, 0, per * num_rounds * sizeof(int32_t));
  std::memset(leaf_value, 0, per * num_rounds * sizeof(float));

  for (int t = 0; t < num_rounds; ++t) {
    TreeOut out{is_leaf + t * per,   feature + t * per, threshold + t * per,
                left + t * per,      right + t * per,   parent + t * per,
                depth + t * per,     active + t * per,  leaf_value + t * per};
    std::iota(ctx.idx.begin(), ctx.idx.end(), 0);
    int next_slot = 1;
    if (!grow(ctx, out, 0, 0, n, 0, next_slot, learning_rate)) return -1;
    for (int i = 0; i < n; ++i)
      ctx.resid[i] -= out.leaf_value[route(ctx, out, i)];
  }
  return 0;
}

// Routes rows through a fitted forest: fills (n, num_trees) leaf indices and
// the summed prediction per row.
void bark_gbdt_predict(const float* X, int n, int d,
                       const int32_t* feat_types, int num_trees,
                       int node_limit, const uint8_t* is_leaf,
                       const int32_t* feature, const float* threshold,
                       const int32_t* left, const int32_t* right,
                       const float* leaf_value, int32_t* leaves_out,
                       float* pred_out) {
  FitCtx ctx;
  ctx.X = X;
  ctx.n = n;
  ctx.d = d;
  ctx.feat_types = feat_types;
  const size_t per = (size_t)node_limit;
  for (int i = 0; i < n; ++i) {
    double acc = 0.0;
    for (int t = 0; t < num_trees; ++t) {
      TreeOut out{const_cast<uint8_t*>(is_leaf + t * per),
                  const_cast<int32_t*>(feature + t * per),
                  const_cast<float*>(threshold + t * per),
                  const_cast<int32_t*>(left + t * per),
                  const_cast<int32_t*>(right + t * per),
                  nullptr,
                  nullptr,
                  nullptr,
                  const_cast<float*>(leaf_value + t * per)};
      const int leaf = route(ctx, out, i);
      leaves_out[(size_t)i * num_trees + t] = leaf;
      acc += out.leaf_value[leaf];
    }
    pred_out[i] = (float)acc;
  }
}

}  // extern "C"
