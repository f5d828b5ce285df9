// Single-core C++ baseline: reference-equivalent LOAM pipeline.
//
// The upstream reference (tier4/lidar_feature_extraction) publishes no
// benchmark numbers (BASELINE.md), so the engine's speedup divisor
// is MEASURED here: a faithful re-implementation of the reference's
// computational structure — per-ring sequential extraction
// (curvature convolution + argsort/suppress labeling + masking sweeps)
// and per-point Gauss-Newton registration with k-NN over a KD-tree,
// Huber-IRLS weights from a MAD scale, 7->6 manifold lift and LLT
// solve — on the same workload sizes as bench.py (64x2048 scan,
// ~200k-point map, k=15, max 40 GN iterations).
//
// This is written from the surveyed behavior (SURVEY.md §2.1-2.2), not
// copied: self-contained small linear algebra, a from-scratch KD-tree.
//
// Build & run:  make -C native baseline && ./native/baseline_bench
// Output: one JSON line {"cpp_single_core_scans_per_sec": X, ...}

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <string_view>
#include <numeric>
#include <queue>
#include <random>
#include <vector>

// ----------------------------------------------------------------- math

struct V3 {
  double x = 0, y = 0, z = 0;
};
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator*(double s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
static inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline double norm(V3 a) { return std::sqrt(dot(a, a)); }

struct Quat {
  double w = 1, x = 0, y = 0, z = 0;
};
static inline Quat qmul(Quat a, Quat b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
static inline V3 qrot(Quat q, V3 p) {
  V3 v{q.x, q.y, q.z};
  V3 uv = cross(v, p);
  V3 uuv = cross(v, uv);
  return p + 2.0 * (q.w * uv + uuv);
}
static inline Quat qexp(V3 th) {
  double k = norm(th);
  if (k < 1e-12) return {1, 0, 0, 0};
  double s = std::sin(k / 2) / k;
  return {std::cos(k / 2), th.x * s, th.y * s, th.z * s};
}

struct Pose {
  Quat q;
  V3 t;
  V3 apply(V3 p) const { return qrot(q, p) + t; }
};

// d(R(q)p)/dq, 3x4 (Sola eq. 174 structure).
static void drpdq(const Quat& q, V3 p, double J[3][4]) {
  V3 v{q.x, q.y, q.z};
  V3 c0 = q.w * p + cross(v, p);
  double vp = dot(v, p);
  double vv[3] = {v.x, v.y, v.z};
  double pp[3] = {p.x, p.y, p.z};
  double hat[3][3] = {{0, -p.z, p.y}, {p.z, 0, -p.x}, {-p.y, p.x, 0}};
  double c0a[3] = {c0.x, c0.y, c0.z};
  for (int i = 0; i < 3; i++) {
    J[i][0] = 2.0 * c0a[i];
    for (int j = 0; j < 3; j++) {
      double eye = (i == j) ? 1.0 : 0.0;
      J[i][j + 1] =
          2.0 * (vp * eye + vv[i] * pp[j] - pp[i] * vv[j] - q.w * hat[i][j]);
    }
  }
}

// Symmetric 3x3 eigendecomposition (closed form); returns eigenvector of
// the largest eigenvalue.
static V3 principal_axis(const double C[3][3]) {
  double q = (C[0][0] + C[1][1] + C[2][2]) / 3.0;
  double a00 = C[0][0] - q, a11 = C[1][1] - q, a22 = C[2][2] - q;
  double a01 = C[0][1], a02 = C[0][2], a12 = C[1][2];
  double p2 = a00 * a00 + a11 * a11 + a22 * a22 +
              2 * (a01 * a01 + a02 * a02 + a12 * a12);
  double p = std::sqrt(std::max(p2 / 6.0, 1e-30));
  double b00 = a00 / p, b11 = a11 / p, b22 = a22 / p;
  double b01 = a01 / p, b02 = a02 / p, b12 = a12 / p;
  double detb = b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02) +
                b02 * (b01 * b12 - b11 * b02);
  double r = std::clamp(detb / 2.0, -1.0, 1.0);
  double phi = std::acos(r) / 3.0;
  double lam = q + 2 * p * std::cos(phi);  // largest
  // Eigenvector via cross products of rows of (C - lam I).
  V3 r0{C[0][0] - lam, C[0][1], C[0][2]};
  V3 r1{C[0][1], C[1][1] - lam, C[1][2]};
  V3 r2{C[0][2], C[1][2], C[2][2] - lam};
  V3 c01 = cross(r0, r1), c02 = cross(r0, r2), c12 = cross(r1, r2);
  double n01 = dot(c01, c01), n02 = dot(c02, c02), n12 = dot(c12, c12);
  V3 best = c01;
  double nb = n01;
  if (n02 > nb) { best = c02; nb = n02; }
  if (n12 > nb) { best = c12; nb = n12; }
  double n = std::sqrt(std::max(nb, 1e-30));
  return {best.x / n, best.y / n, best.z / n};
}

// Dense symmetric solve (LLT) for small n.
template <int N>
static bool llt_solve(double A[N][N], double b[N], double x[N]) {
  double L[N][N] = {};
  for (int i = 0; i < N; i++) {
    for (int j = 0; j <= i; j++) {
      double s = A[i][j];
      for (int k = 0; k < j; k++) s -= L[i][k] * L[j][k];
      if (i == j) {
        if (s <= 0) return false;
        L[i][i] = std::sqrt(s);
      } else {
        L[i][j] = s / L[j][j];
      }
    }
  }
  double y[N];
  for (int i = 0; i < N; i++) {
    double s = b[i];
    for (int k = 0; k < i; k++) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = N - 1; i >= 0; i--) {
    double s = y[i];
    for (int k = i + 1; k < N; k++) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  return true;
}

// Jacobi eigenvalues of a symmetric NxN (for the degeneracy guard).
template <int N>
static void jacobi_eigenvalues(double Ain[N][N], double evals[N]) {
  double A[N][N];
  std::copy(&Ain[0][0], &Ain[0][0] + N * N, &A[0][0]);
  for (int sweep = 0; sweep < 30; sweep++) {
    double off = 0;
    for (int i = 0; i < N; i++)
      for (int j = i + 1; j < N; j++) off += A[i][j] * A[i][j];
    if (off < 1e-20) break;
    for (int p = 0; p < N; p++)
      for (int q = p + 1; q < N; q++) {
        if (std::fabs(A[p][q]) < 1e-30) continue;
        double theta = (A[q][q] - A[p][p]) / (2 * A[p][q]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::fabs(theta) + std::sqrt(theta * theta + 1));
        double c = 1 / std::sqrt(t * t + 1), s = t * c;
        for (int k = 0; k < N; k++) {
          double akp = A[k][p], akq = A[k][q];
          A[k][p] = c * akp - s * akq;
          A[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < N; k++) {
          double apk = A[p][k], aqk = A[q][k];
          A[p][k] = c * apk - s * aqk;
          A[q][k] = s * apk + c * aqk;
        }
      }
  }
  for (int i = 0; i < N; i++) evals[i] = A[i][i];
}

// -------------------------------------------------------------- KD-tree

struct KDTree {
  struct Node {
    int axis = -1;
    double split = 0;
    int left = -1, right = -1;
    int begin = 0, end = 0;  // leaf range
  };
  std::vector<V3> pts;
  std::vector<int> idx;
  std::vector<Node> nodes;
  static constexpr int kLeaf = 10;  // nanoflann default leaf size

  void build(const std::vector<V3>& points) {
    pts = points;
    idx.resize(pts.size());
    std::iota(idx.begin(), idx.end(), 0);
    nodes.clear();
    nodes.reserve(2 * pts.size() / kLeaf + 4);
    build_range(0, (int)pts.size());
  }

  int build_range(int begin, int end) {
    int id = (int)nodes.size();
    nodes.push_back({});
    if (end - begin <= kLeaf) {
      nodes[id].begin = begin;
      nodes[id].end = end;
      return id;
    }
    // Split on the widest axis at the median.
    V3 lo{1e30, 1e30, 1e30}, hi{-1e30, -1e30, -1e30};
    for (int i = begin; i < end; i++) {
      V3 p = pts[idx[i]];
      lo = {std::min(lo.x, p.x), std::min(lo.y, p.y), std::min(lo.z, p.z)};
      hi = {std::max(hi.x, p.x), std::max(hi.y, p.y), std::max(hi.z, p.z)};
    }
    V3 ext = hi - lo;
    int axis = 0;
    if (ext.y > ext.x) axis = 1;
    if (ext.z > (axis == 0 ? ext.x : ext.y)) axis = 2;
    int mid = (begin + end) / 2;
    auto get = [&](int i) {
      V3 p = pts[i];
      return axis == 0 ? p.x : (axis == 1 ? p.y : p.z);
    };
    std::nth_element(idx.begin() + begin, idx.begin() + mid,
                     idx.begin() + end,
                     [&](int a, int b) { return get(a) < get(b); });
    nodes[id].axis = axis;
    nodes[id].split = get(idx[mid]);
    int l = build_range(begin, mid);
    int r = build_range(mid, end);
    nodes[id].left = l;
    nodes[id].right = r;
    return id;
  }

  // k-NN search: max-heap of candidates.
  void knn(V3 q, int k, std::vector<V3>& out) const {
    std::priority_queue<std::pair<double, int>> heap;
    search(0, q, k, heap);
    out.resize(heap.size());
    for (int i = (int)heap.size() - 1; i >= 0; i--) {
      out[i] = pts[heap.top().second];
      heap.pop();
    }
  }

  void search(int nid, V3 q, int k,
              std::priority_queue<std::pair<double, int>>& heap) const {
    const Node& n = nodes[nid];
    if (n.axis < 0) {
      for (int i = n.begin; i < n.end; i++) {
        V3 d = pts[idx[i]] - q;
        double sq = dot(d, d);
        if ((int)heap.size() < k) {
          heap.emplace(sq, idx[i]);
        } else if (sq < heap.top().first) {
          heap.pop();
          heap.emplace(sq, idx[i]);
        }
      }
      return;
    }
    double qa = n.axis == 0 ? q.x : (n.axis == 1 ? q.y : q.z);
    int near = qa < n.split ? n.left : n.right;
    int far = qa < n.split ? n.right : n.left;
    search(near, q, k, heap);
    double dd = (qa - n.split) * (qa - n.split);
    if ((int)heap.size() < k || dd < heap.top().first) search(far, q, k, heap);
  }
};

// --------------------------------------------------- extraction (per ring)

enum Label : uint8_t {
  kDefault = 0, kEdge, kEdgeNeighbor, kSurface, kSurfaceNeighbor,
  kOutOfRange, kOccluded, kParallelBeam
};

// Production extraction parameters from the reference's launch config
// (lidar_feature_launch/config/lidar_feature_extraction.param.yaml):
// padding=2, neighbor 3 deg, edge_threshold=50, max_range=1000;
// surface_threshold keeps the code default 0.05.
struct ExtractParams {
  int padding = 2;
  double neighbor_deg = 3.0;
  double dist_diff = 0.3;
  double par_ratio = 0.02;
  double edge_thr = 50.0;
  double surf_thr = 0.05;
  double min_range = 0.1, max_range = 1000.0;
  int n_blocks = 6;
};

static bool is_neighbor(const std::vector<V3>& p, int i, int j, double thr) {
  double dotv = p[i].x * p[j].x + p[i].y * p[j].y;
  double n1 = std::hypot(p[i].x, p[i].y), n2 = std::hypot(p[j].x, p[j].y);
  double c = std::clamp(dotv / std::max(n1 * n2, 1e-30), -1.0, 1.0);
  return std::acos(c) < thr;
}

static void fill_from_left(std::vector<uint8_t>& lab,
                           const std::vector<char>& nb, int begin, int end,
                           uint8_t label) {
  for (int i = begin; i < end - 1; i++) {
    lab[i] = label;
    if (!nb[i]) return;
  }
  lab[end - 1] = label;
}

static void fill_from_right(std::vector<uint8_t>& lab,
                            const std::vector<char>& nb, int begin, int end,
                            uint8_t label) {
  for (int i = end; i > begin + 1; i--) {
    lab[i] = label;
    if (!nb[i - 1]) return;
  }
  lab[begin + 1] = label;
}

static void fill_neighbors(std::vector<uint8_t>& lab,
                           const std::vector<char>& nb, int index,
                           int padding, uint8_t label, int lo_clamp,
                           int hi_clamp) {
  int lo = std::max(lo_clamp - 1, index - padding - 1);
  int hi = std::min(index + 1 + padding, hi_clamp);
  fill_from_right(lab, nb, lo, index, label);
  fill_from_left(lab, nb, index, hi, label);
}

// Label one azimuth-sorted ring; returns (#edges, #surfaces).
// labels_out / curv_out (optional) receive the per-point label vector
// and squared-convolution curvature for golden dumps.
static std::pair<int, int> extract_ring(const std::vector<V3>& ring,
                                        const ExtractParams& P,
                                        std::vector<V3>* edges,
                                        std::vector<V3>* surfaces,
                                        std::vector<uint8_t>* labels_out =
                                            nullptr,
                                        std::vector<double>* curv_out =
                                            nullptr) {
  int n = (int)ring.size();
  int p = P.padding;
  if (n - 2 * p < P.n_blocks) return {0, 0};
  double thr = P.neighbor_deg * M_PI / 180.0;

  std::vector<double> range(n), curv(n, 0.0);
  for (int i = 0; i < n; i++) range[i] = std::hypot(ring[i].x, ring[i].y);
  for (int i = p; i < n - p; i++) {
    double s = -2.0 * p * range[i];
    for (int k = 1; k <= p; k++) s += range[i - k] + range[i + k];
    curv[i] = s * s;
  }
  std::vector<char> nb(n, 0);
  for (int i = 0; i + 1 < n; i++) nb[i] = is_neighbor(ring, i, i + 1, thr);

  std::vector<uint8_t> lab(n, kDefault);
  // Block partition (integer-exact boundaries).
  for (int j = 0; j < P.n_blocks; j++) {
    int b = (p * (P.n_blocks - j) + (n - p) * j) / P.n_blocks;
    int e = (p * (P.n_blocks - j - 1) + (n - p) * (j + 1)) / P.n_blocks;
    std::vector<int> order(e - b);
    std::iota(order.begin(), order.end(), b);
    std::sort(order.begin(), order.end(),
              [&](int a, int c) { return curv[a] < curv[c]; });
    for (auto it = order.rbegin(); it != order.rend(); ++it) {
      int i = *it;
      if (lab[i] == kDefault && curv[i] >= P.edge_thr) {
        fill_neighbors(lab, nb, i, p, kEdgeNeighbor, b, e);
        lab[i] = kEdge;
      }
    }
    for (int i : order) {
      if (lab[i] == kDefault && curv[i] <= P.surf_thr) {
        fill_neighbors(lab, nb, i, p, kSurfaceNeighbor, b, e);
        lab[i] = kSurface;
      }
    }
  }
  // Occlusion sweeps.
  for (int i = 0; i < n - p - 1; i++) {
    if (!nb[i]) continue;
    if (range[i + 1] > range[i] + P.dist_diff)
      fill_from_left(lab, nb, i + 1, i + p + 2, kOccluded);
  }
  for (int i = n - 1; i >= p + 1; i--) {
    if (!nb[i - 1]) continue;
    if (range[i - 1] > range[i] + P.dist_diff)
      fill_from_right(lab, nb, i - p - 2, i - 1, kOccluded);
  }
  for (int i = 0; i < n; i++)
    if (range[i] < P.min_range || range[i] > P.max_range) lab[i] = kOutOfRange;
  for (int i = 1; i + 1 < n; i++) {
    double r1 = std::fabs(range[i - 1] - range[i]) / range[i];
    double r2 = std::fabs(range[i + 1] - range[i]) / range[i];
    if (r1 > P.par_ratio && r2 > P.par_ratio) lab[i] = kParallelBeam;
  }
  int ne = 0, ns = 0;
  for (int i = 0; i < n; i++) {
    if (lab[i] == kEdge) { edges->push_back(ring[i]); ne++; }
    if (lab[i] == kSurface) { surfaces->push_back(ring[i]); ns++; }
  }
  if (labels_out) *labels_out = lab;
  if (curv_out) *curv_out = curv;
  return {ne, ns};
}

// ----------------------------------------------------------- registration

static double median_inplace(std::vector<double>& v) {
  size_t n = v.size();
  if (n == 0) return 0;
  if (n % 2 == 1) {
    std::nth_element(v.begin(), v.begin() + n / 2, v.end());
    return v[n / 2];
  }
  std::nth_element(v.begin(), v.begin() + n / 2, v.end());
  double e0 = v[n / 2];
  std::nth_element(v.begin(), v.begin() + n / 2 - 1, v.end());
  double e1 = v[n / 2 - 1];
  return (e0 + e1) / 2;
}

struct Registrar {
  KDTree edge_tree, surf_tree;
  int k = 15;
  int max_iter = 40;
  double huber_k = 1.345;

  // One scan-to-map registration; returns iterations used. ``traj``
  // (optional) records the pose after every iteration (golden dumps).
  int run(const std::vector<V3>& edge_scan, const std::vector<V3>& surf_scan,
          Pose& pose, std::vector<Pose>* traj = nullptr) const {
    std::vector<V3> nbrs;
    int iters = 0;
    double prev_err = 1e300, prev_scale = 1e300;
    for (int it = 0; it < max_iter; it++) {
      iters++;
      size_t m = edge_scan.size() + surf_scan.size();
      std::vector<double> J;  // m rows of up-to-3x7 blocks flattened
      std::vector<double> errs;
      errs.reserve(m);
      // Stored per correspondence: jac rows (3 or 1) and residual rows.
      struct Corr { double jac[3][7]; double res[3]; int rows; };
      std::vector<Corr> corr;
      corr.reserve(m);

      for (const V3& p0 : edge_scan) {
        V3 q = pose.apply(p0);
        edge_tree.knn(q, k, nbrs);
        V3 mean{};
        for (V3 v : nbrs) mean = mean + v;
        mean = (1.0 / nbrs.size()) * mean;
        double C[3][3] = {};
        for (V3 v : nbrs) {
          V3 d = v - mean;
          double dd[3] = {d.x, d.y, d.z};
          for (int i = 0; i < 3; i++)
            for (int jj = 0; jj < 3; jj++) C[i][jj] += dd[i] * dd[jj];
        }
        for (int i = 0; i < 3; i++)
          for (int jj = 0; jj < 3; jj++) C[i][jj] /= nbrs.size();
        V3 pr = principal_axis(C);
        V3 p1 = mean - pr, p2 = mean + pr;
        V3 d21 = p2 - p1;
        double hat[3][3] = {{0, -d21.z, d21.y},
                            {d21.z, 0, -d21.x},
                            {-d21.y, d21.x, 0}};
        double dq[3][4];
        drpdq(pose.q, p0, dq);
        Corr c{};
        c.rows = 3;
        for (int i = 0; i < 3; i++) {
          for (int jj = 0; jj < 4; jj++) {
            double s = 0;
            for (int kk = 0; kk < 3; kk++) s += hat[i][kk] * dq[kk][jj];
            c.jac[i][jj] = s;
          }
          for (int jj = 0; jj < 3; jj++) c.jac[i][4 + jj] = hat[i][jj];
        }
        V3 r = cross(q - p1, q - p2);
        c.res[0] = r.x; c.res[1] = r.y; c.res[2] = r.z;
        corr.push_back(c);
        errs.push_back(dot(r, r));
      }
      for (const V3& p0 : surf_scan) {
        V3 q = pose.apply(p0);
        surf_tree.knn(q, k, nbrs);
        // Plane fit: (X^T X) w = -X^T 1.
        double A[3][3] = {}, b[3] = {};
        for (V3 v : nbrs) {
          double vv[3] = {v.x, v.y, v.z};
          for (int i = 0; i < 3; i++) {
            for (int jj = 0; jj < 3; jj++) A[i][jj] += vv[i] * vv[jj];
            b[i] -= vv[i];
          }
        }
        for (int i = 0; i < 3; i++) A[i][i] += 1e-9;
        double w[3];
        if (!llt_solve<3>(A, b, w)) continue;
        double wn = std::sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
        if (wn < 1e-12) continue;
        double u[3] = {w[0] / wn, w[1] / wn, w[2] / wn};
        double dq[3][4];
        drpdq(pose.q, p0, dq);
        Corr c{};
        c.rows = 1;
        for (int jj = 0; jj < 4; jj++)
          c.jac[0][jj] = u[0] * dq[0][jj] + u[1] * dq[1][jj] + u[2] * dq[2][jj];
        for (int jj = 0; jj < 3; jj++) c.jac[0][4 + jj] = u[jj];
        double res = (w[0] * q.x + w[1] * q.y + w[2] * q.z + 1.0) / wn;
        c.res[0] = res;
        corr.push_back(c);
        errs.push_back(res * res);
      }
      if (corr.empty()) break;

      double err = 0;
      for (double e : errs) err += e;
      std::vector<double> tmp = errs;
      double med = median_inplace(tmp);
      for (size_t i = 0; i < tmp.size(); i++) tmp[i] = std::fabs(errs[i] - med);
      double scale = 1.482602218505602 * median_inplace(tmp);
      if (err > prev_err || scale > prev_scale) break;
      prev_err = err; prev_scale = scale;

      // Weighted normal equations over the 7-dim ambient.
      double D7[7][7] = {}, A7[7][7] = {}, b7[7] = {};
      for (size_t ci = 0; ci < corr.size(); ci++) {
        const Corr& c = corr[ci];
        double e = errs[ci] / (scale + 1e-16);
        double wgt = e < huber_k * huber_k ? 1.0 : huber_k / std::sqrt(e);
        for (int r = 0; r < c.rows; r++)
          for (int i = 0; i < 7; i++) {
            for (int jj = 0; jj < 7; jj++) {
              double v = c.jac[r][i] * c.jac[r][jj];
              D7[i][jj] += v;
              A7[i][jj] += wgt * v;
            }
            b7[i] += wgt * c.jac[r][i] * c.res[r];
          }
      }
      double evals[7];
      jacobi_eigenvalues<7>(D7, evals);
      bool degen = false;
      for (double e : evals) degen |= std::fabs(e) < 0.1;

      V3 dt{}, dth{};
      if (!degen) {
        // M lift: dq = 0.5 L(q)[:,1:] dtheta.
        double M[7][6] = {};
        double L[4][3] = {{-pose.q.x, -pose.q.y, -pose.q.z},
                          {pose.q.w, -pose.q.z, pose.q.y},
                          {pose.q.z, pose.q.w, -pose.q.x},
                          {-pose.q.y, pose.q.x, pose.q.w}};
        for (int i = 0; i < 4; i++)
          for (int jj = 0; jj < 3; jj++) M[i][jj] = 0.5 * L[i][jj];
        for (int i = 0; i < 3; i++) M[4 + i][3 + i] = 1.0;
        double H[6][6] = {}, g[6] = {};
        for (int i = 0; i < 6; i++) {
          for (int jj = 0; jj < 6; jj++) {
            double s = 0;
            for (int a = 0; a < 7; a++)
              for (int bidx = 0; bidx < 7; bidx++)
                s += M[a][i] * A7[a][bidx] * M[bidx][jj];
            H[i][jj] = s;
          }
          double s = 0;
          for (int a = 0; a < 7; a++) s += M[a][i] * b7[a];
          g[i] = s;
        }
        double dx[6];
        if (llt_solve<6>(H, g, dx)) {
          dth = {-dx[0], -dx[1], -dx[2]};
          dt = {-dx[3], -dx[4], -dx[5]};
        }
      }
      Quat dqq = qexp(dth);
      pose.q = qmul(pose.q, dqq);
      double qn = std::sqrt(pose.q.w * pose.q.w + pose.q.x * pose.q.x +
                            pose.q.y * pose.q.y + pose.q.z * pose.q.z);
      pose.q = {pose.q.w / qn, pose.q.x / qn, pose.q.y / qn, pose.q.z / qn};
      pose.t = pose.t + dt;
      if (traj) traj->push_back(pose);
      double dqv = std::sqrt(dqq.x * dqq.x + dqq.y * dqq.y + dqq.z * dqq.z);
      if (dqv < 1e-3 && norm(dt) < 1e-3) break;
    }
    return iters;
  }
};

// ------------------------------------------------------------ golden mode
//
// Second, independent implementation used as a numeric cross-check of
// the JAX pipeline (tests/test_native_golden.py): load a shared scene
// from a flat binary file, dump per-ring labels + curvature, the
// extracted feature points, and the Gauss-Newton pose trajectory.
//
// scene file (little-endian):
//   int32 magic 0x4C475331, int32 R
//   per ring: int32 n, n*3 float64 xyz (azimuth-sorted, sensor frame)
//   int32 n_edge_map, n*3 float64 | int32 n_surf_map, n*3 float64
//   float64[7] prior pose (q wxyz, t xyz)
// golden file:
//   int32 R; per ring: int32 n, n uint8 labels, n float64 curvature
//   int32 n_edges, n*3 float64 | int32 n_surf_ds, n*3 float64
//   int32 n_traj, n_traj*7 float64 poses (after each GN iteration)

static bool read_i32(FILE* f, int32_t* v) { return fread(v, 4, 1, f) == 1; }
static bool read_pts(FILE* f, std::vector<V3>* out) {
  int32_t n;
  if (!read_i32(f, &n) || n < 0 || n > (1 << 26)) return false;
  out->resize(n);
  for (int i = 0; i < n; i++) {
    double b[3];
    if (fread(b, 8, 3, f) != 3) return false;
    (*out)[i] = {b[0], b[1], b[2]};
  }
  return true;
}
static void write_i32(FILE* f, int32_t v) { fwrite(&v, 4, 1, f); }
static void write_pts(FILE* f, const std::vector<V3>& pts) {
  write_i32(f, (int32_t)pts.size());
  for (const V3& p : pts) {
    double b[3] = {p.x, p.y, p.z};
    fwrite(b, 8, 3, f);
  }
}

static int golden_main(const char* scene_path, const char* out_path) {
  FILE* f = std::fopen(scene_path, "rb");
  if (!f) { std::fprintf(stderr, "cannot open %s\n", scene_path); return 2; }
  int32_t magic = 0, R = 0;
  if (!read_i32(f, &magic) || magic != 0x4C475331 || !read_i32(f, &R) ||
      R <= 0 || R > 4096) {
    std::fprintf(stderr, "bad scene header\n");
    return 2;
  }
  std::vector<std::vector<V3>> rings(R);
  for (int r = 0; r < R; r++)
    if (!read_pts(f, &rings[r])) { std::fprintf(stderr, "bad ring\n"); return 2; }
  std::vector<V3> edge_map, surf_map;
  if (!read_pts(f, &edge_map) || !read_pts(f, &surf_map)) {
    std::fprintf(stderr, "bad maps\n");
    return 2;
  }
  double pb[7];
  if (fread(pb, 8, 7, f) != 7) { std::fprintf(stderr, "bad prior\n"); return 2; }
  std::fclose(f);

  ExtractParams P;
  std::vector<V3> edges, surfaces;
  std::vector<std::vector<uint8_t>> labels(R);
  std::vector<std::vector<double>> curvs(R);
  for (int r = 0; r < R; r++) {
    labels[r].assign(rings[r].size(), kDefault);
    curvs[r].assign(rings[r].size(), 0.0);
    extract_ring(rings[r], P, &edges, &surfaces, &labels[r], &curvs[r]);
  }

  // Surface downsample (1 m voxel centroid), identical to the bench path.
  std::vector<V3> surf_ds;
  {
    std::vector<std::pair<int64_t, int>> keys(surfaces.size());
    for (size_t i = 0; i < surfaces.size(); i++) {
      V3 v = surfaces[i];
      int64_t kx = (int64_t)std::floor(v.x), ky = (int64_t)std::floor(v.y),
              kz = (int64_t)std::floor(v.z);
      keys[i] = {((kx + (1 << 20)) << 42) | ((ky + (1 << 20)) << 21) |
                     (kz + (1 << 20)),
                 (int)i};
    }
    std::sort(keys.begin(), keys.end());
    size_t i = 0;
    while (i < keys.size()) {
      size_t j = i;
      V3 acc{};
      while (j < keys.size() && keys[j].first == keys[i].first) {
        acc = acc + surfaces[keys[j].second];
        j++;
      }
      surf_ds.push_back((1.0 / (j - i)) * acc);
      i = j;
    }
  }

  Registrar reg;
  reg.edge_tree.build(edge_map);
  reg.surf_tree.build(surf_map);
  Pose pose;
  pose.q = {pb[0], pb[1], pb[2], pb[3]};
  pose.t = {pb[4], pb[5], pb[6]};
  std::vector<Pose> traj;
  reg.run(edges, surf_ds, pose, &traj);

  FILE* g = std::fopen(out_path, "wb");
  if (!g) { std::fprintf(stderr, "cannot open %s\n", out_path); return 2; }
  write_i32(g, R);
  for (int r = 0; r < R; r++) {
    write_i32(g, (int32_t)labels[r].size());
    fwrite(labels[r].data(), 1, labels[r].size(), g);
    fwrite(curvs[r].data(), 8, curvs[r].size(), g);
  }
  write_pts(g, edges);
  write_pts(g, surf_ds);
  write_i32(g, (int32_t)traj.size());
  for (const Pose& p : traj) {
    double b[7] = {p.q.w, p.q.x, p.q.y, p.q.z, p.t.x, p.t.y, p.t.z};
    fwrite(b, 8, 7, g);
  }
  std::fclose(g);
  std::fprintf(stderr, "golden: %d rings, %zu edges, %zu surf_ds, %zu iters\n",
               R, edges.size(), surf_ds.size(), traj.size());
  return 0;
}

// ------------------------------------------------------------------ main

int main(int argc, char** argv) {
  if (argc == 4 && std::string_view(argv[1]) == "--golden")
    return golden_main(argv[2], argv[3]);
  std::mt19937_64 rng(0);
  std::uniform_real_distribution<double> uni(0, 1);
  auto U = [&](double lo, double hi) { return lo + (hi - lo) * uni(rng); };
  std::normal_distribution<double> gauss(0, 1);

  // Map (mirrors bench.py sizes): pole lines + ground + wall.
  std::vector<V3> edge_map, surf_map;
  for (int l = 0; l < 60; l++) {
    double x = U(-60, 60), y = U(-60, 60);
    for (int zi = 0; zi < 40; zi++) {
      double z = -2 + 8.0 * zi / 39.0;
      edge_map.push_back({x + 0.02 * gauss(rng), y + 0.02 * gauss(rng), z});
    }
  }
  for (int i = 0; i < 150000; i++)
    surf_map.push_back({U(-80, 80), U(-80, 80), 0.03 * gauss(rng)});
  for (int i = 0; i < 30000; i++)
    surf_map.push_back({25.0 + 0.03 * gauss(rng), U(-80, 80), U(0, 8)});

  // Scan: 64 rings x 2048 points; piecewise range bands with
  // discontinuities (foreground objects in front of walls) so the
  // extractor finds KITTI-realistic edge counts (same structure as
  // bench.py).
  const int R = 64, Pn = 2048, n_seg = 48;
  std::vector<std::vector<V3>> rings(R);
  for (int r = 0; r < R; r++) {
    std::vector<double> az(Pn);
    for (int i = 0; i < Pn; i++) az[i] = U(-M_PI, M_PI);
    std::sort(az.begin(), az.end());
    double seg_base[n_seg];
    for (int s = 0; s < n_seg; s++) seg_base[s] = U(8.0, 20.0);
    double elev = (2.0 - 26.8 * r / (R - 1)) * M_PI / 180.0;
    rings[r].resize(Pn);
    for (int i = 0; i < Pn; i++) {
      int seg = std::min((int)((az[i] + M_PI) / (2 * M_PI) * n_seg),
                         n_seg - 1);
      double rr = seg_base[seg] + 0.5 * std::sin(7 * az[i]) +
                  0.01 * gauss(rng);
      double xy = rr * std::cos(elev);
      rings[r][i] = {xy * std::cos(az[i]), xy * std::sin(az[i]),
                     rr * std::sin(elev)};
    }
  }

  ExtractParams P;
  Registrar reg;

  auto t0 = std::chrono::steady_clock::now();
  reg.edge_tree.build(edge_map);
  reg.surf_tree.build(surf_map);
  auto t1 = std::chrono::steady_clock::now();
  double build_s = std::chrono::duration<double>(t1 - t0).count();

  const int n_scans = 10;
  double extract_s = 0, register_s = 0;
  long total_edges = 0, total_surfs = 0, total_iters = 0;
  for (int s = 0; s < n_scans; s++) {
    auto e0 = std::chrono::steady_clock::now();
    std::vector<V3> edges, surfaces;
    for (int r = 0; r < R; r++) extract_ring(rings[r], P, &edges, &surfaces);
    auto e1 = std::chrono::steady_clock::now();
    extract_s += std::chrono::duration<double>(e1 - e0).count();
    total_edges += edges.size();
    total_surfs += surfaces.size();

    // Surface downsample (1 m voxel grid) like Surface::Make.
    std::vector<V3> surf_ds;
    {
      std::vector<std::pair<int64_t, int>> keys(surfaces.size());
      for (size_t i = 0; i < surfaces.size(); i++) {
        V3 v = surfaces[i];
        int64_t kx = (int64_t)std::floor(v.x), ky = (int64_t)std::floor(v.y),
                kz = (int64_t)std::floor(v.z);
        keys[i] = {((kx + (1 << 20)) << 42) | ((ky + (1 << 20)) << 21) |
                       (kz + (1 << 20)),
                   (int)i};
      }
      std::sort(keys.begin(), keys.end());
      size_t i = 0;
      while (i < keys.size()) {
        size_t j = i;
        V3 acc{};
        while (j < keys.size() && keys[j].first == keys[i].first) {
          acc = acc + surfaces[keys[j].second];
          j++;
        }
        surf_ds.push_back((1.0 / (j - i)) * acc);
        i = j;
      }
    }

    Pose pose;
    pose.t = {0.3, -0.2, 0.05};
    auto r0 = std::chrono::steady_clock::now();
    total_iters += reg.run(edges, surf_ds, pose);
    auto r1 = std::chrono::steady_clock::now();
    register_s += std::chrono::duration<double>(r1 - r0).count();
  }

  double per_scan = (extract_s + register_s) / n_scans;
  std::printf(
      "{\"cpp_single_core_scans_per_sec\": %.4f, "
      "\"extract_ms\": %.2f, \"register_ms\": %.2f, "
      "\"kdtree_build_s\": %.2f, \"edges_per_scan\": %ld, "
      "\"surfaces_per_scan\": %ld, \"gn_iters_per_scan\": %.1f}\n",
      1.0 / per_scan, 1000 * extract_s / n_scans,
      1000 * register_s / n_scans, build_s, total_edges / n_scans,
      total_surfs / n_scans, (double)total_iters / n_scans);
  return 0;
}
