// Batched dense LP kernel for polytope support functions.
//
// Computes h_j = max{ c_j^T y : A y <= b } for a batch of directions c_j
// sharing one H-representation (A, b) — the workhorse query of the
// set-computation layer (mRPI iterations, Pontryagin differences,
// Gilbert–Tan fixed points; reference: utils_polytope.py:12-23, which
// issues one scipy.linprog/HiGHS call per direction from Python).
//
// Each LP is solved via its dual
//     min { b^T lam : A^T lam = c_j, lam >= 0 }
// with a two-phase dense revised simplex (explicit basis inverse, Bland's
// anti-cycling rule).  The basis is n x n where n = dim (<= ~12 for every
// system in this domain), so refactorization is trivially cheap and
// numerical drift is controlled by refactoring every iteration.
//
// Status per direction:
//   0  optimal          (h = optimum)
//   1  primal unbounded (support is +inf; dual phase-1 stays > 0)
//   2  primal infeasible / numerical failure (h = NaN)
//
// Built as a shared library; called from Python via ctypes
// (rtmpc_tpu/utils/_native.py).  C++17 and std::thread, no external
// dependencies (no OpenMP: not every toolchain ships its runtime).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr double kTol = 1e-9;       // feasibility / reduced-cost tolerance
constexpr double kPivTol = 1e-11;   // minimum acceptable pivot magnitude

// Solve the standard-form LP  min f^T x  s.t.  E x = g, x >= 0  where E is
// n x (nv) column-major-free (we store row-major), using artificials for
// phase 1.  Returns 0 on optimal, 1 on infeasible (phase-1 optimum > 0),
// 2 on unbounded, 3 on numerical failure.  On success *obj holds the
// optimum.
class DenseSimplex {
 public:
  DenseSimplex(int n, int nv) : n_(n), nv_(nv), ncols_(nv + n),
      Binv_(n * n), price_(n), col_(n),
      basis_(n), in_basis_(ncols_) {}

  // E: n x nv row-major, g: n, f: nv.
  int solve(const double* E, const double* g, const double* f,
            double* obj) {
    E_ = E;
    // make RHS nonnegative by flipping row signs (recorded in sign_)
    sign_.assign(n_, 1.0);
    g_.assign(g, g + n_);
    for (int i = 0; i < n_; ++i)
      if (g_[i] < 0) { sign_[i] = -1.0; g_[i] = -g_[i]; }

    // phase 1: basis = artificials, cost = sum of artificials
    std::fill(in_basis_.begin(), in_basis_.end(), 0);
    for (int i = 0; i < n_; ++i) basis_[i] = nv_ + i;
    std::fill(Binv_.begin(), Binv_.end(), 0.0);
    for (int i = 0; i < n_; ++i) Binv_[i * n_ + i] = 1.0;
    xB_ = g_;

    phase1_ = true;
    int rc = iterate(nullptr);
    if (rc != 0) return 3;
    if (!refactor()) return 3;
    double p1 = 0.0;
    for (int i = 0; i < n_; ++i)
      if (basis_[i] >= nv_) p1 += xB_[i];
    if (p1 > 1e-7) return 1;  // infeasible

    // drive any degenerate artificials out of the basis if possible
    for (int i = 0; i < n_; ++i) {
      if (basis_[i] < nv_) continue;
      int enter = -1;
      for (int j = 0; j < nv_; ++j) {
        if (in_basis_[j]) continue;
        double aij = row_dot(i, j);
        if (std::fabs(aij) > 1e-7) { enter = j; break; }
      }
      if (enter >= 0) pivot(enter, i);
      // else: row is redundant; the artificial stays at value 0 and its
      // row never binds — harmless for phase 2 (it prices to 0)
    }

    phase1_ = false;
    if (!refactor()) return 3;
    rc = iterate(f);
    if (rc == 2) return 2;    // unbounded dual = infeasible primal caller
    if (rc != 0) return 3;
    double v = 0.0;
    for (int i = 0; i < n_; ++i)
      if (basis_[i] < nv_) v += f[basis_[i]] * xB_[i];
    *obj = v;
    return 0;
  }

 private:
  double colval(int row, int col) const {
    // entry E[row][col] with row-sign flip; artificial columns = identity
    if (col >= nv_) return (col - nv_ == row) ? 1.0 : 0.0;
    return sign_[row] * E_[static_cast<size_t>(row) * nv_ + col];
  }

  // Rebuild Binv from the basis columns by Gauss-Jordan with partial
  // pivoting, then recompute xB.  The per-pivot eta updates drift after
  // a few hundred iterations; refactoring restores full accuracy.
  // Returns false on a (numerically) singular basis.
  bool refactor() {
    std::vector<double> M(static_cast<size_t>(n_) * 2 * n_, 0.0);
    const int w = 2 * n_;
    for (int i = 0; i < n_; ++i) {
      for (int c = 0; c < n_; ++c)
        M[static_cast<size_t>(i) * w + c] = colval(i, basis_[c]);
      M[static_cast<size_t>(i) * w + n_ + i] = 1.0;
    }
    for (int c = 0; c < n_; ++c) {
      int p = c;
      for (int r = c + 1; r < n_; ++r)
        if (std::fabs(M[static_cast<size_t>(r) * w + c]) >
            std::fabs(M[static_cast<size_t>(p) * w + c])) p = r;
      if (std::fabs(M[static_cast<size_t>(p) * w + c]) < 1e-12) return false;
      if (p != c)
        for (int q = 0; q < w; ++q)
          std::swap(M[static_cast<size_t>(p) * w + q],
                    M[static_cast<size_t>(c) * w + q]);
      double inv = 1.0 / M[static_cast<size_t>(c) * w + c];
      for (int q = 0; q < w; ++q) M[static_cast<size_t>(c) * w + q] *= inv;
      for (int r = 0; r < n_; ++r) {
        if (r == c) continue;
        double fct = M[static_cast<size_t>(r) * w + c];
        if (fct == 0.0) continue;
        for (int q = 0; q < w; ++q)
          M[static_cast<size_t>(r) * w + q] -=
              fct * M[static_cast<size_t>(c) * w + q];
      }
    }
    for (int i = 0; i < n_; ++i)
      for (int r = 0; r < n_; ++r)
        Binv_[static_cast<size_t>(i) * n_ + r] =
            M[static_cast<size_t>(i) * w + n_ + r];
    for (int i = 0; i < n_; ++i) {
      double s = 0.0;
      for (int r = 0; r < n_; ++r) s += Binv_[i * n_ + r] * g_[r];
      xB_[i] = s;           // keep raw: negatives = basis infeasibility
    }
    return true;
  }

  // (B^{-1} a_j)[i] for structural columns — computed per use
  double row_dot(int i, int j) {
    double s = 0.0;
    for (int r = 0; r < n_; ++r)
      s += Binv_[i * n_ + r] * colval(r, j);
    return s;
  }

  void compute_col(int j) {
    for (int i = 0; i < n_; ++i) {
      double s = 0.0;
      for (int r = 0; r < n_; ++r) s += Binv_[i * n_ + r] * colval(r, j);
      col_[i] = s;
    }
  }

  void pivot(int enter, int leave_row) {
    compute_col(enter);
    double piv = col_[leave_row];
    if (std::fabs(piv) < kPivTol) return;  // guarded by callers
    // eta update of Binv: row ops eliminating col_ except leave_row
    double inv = 1.0 / piv;
    for (int r = 0; r < n_; ++r) Binv_[leave_row * n_ + r] *= inv;
    for (int i = 0; i < n_; ++i) {
      if (i == leave_row) continue;
      double factor = col_[i];
      if (factor == 0.0) continue;
      for (int r = 0; r < n_; ++r)
        Binv_[i * n_ + r] -= factor * Binv_[leave_row * n_ + r];
    }
    // update xB
    for (int i = 0; i < n_; ++i) {
      double s = 0.0;
      for (int r = 0; r < n_; ++r) s += Binv_[i * n_ + r] * g_[r];
      xB_[i] = s;
    }
    in_basis_[basis_[leave_row]] = 0;
    basis_[leave_row] = enter;
    in_basis_[enter] = 1;
  }

  double cost_of(int j, const double* f) const {
    if (phase1_) return (j >= nv_) ? 1.0 : 0.0;
    return (j >= nv_) ? 0.0 : f[j];
  }

  // Bland's-rule simplex loop; returns 0 optimal, 2 unbounded, 3 failure.
  int iterate(const double* f) {
    const long max_iter = 200L * (nv_ + n_) + 2000;
    int since_refactor = 0;
    for (long it = 0; it < max_iter; ++it) {
      if (since_refactor >= 1 && !refactor()) return 3;
      since_refactor = 0;
      // price: y = Binv^T c_B
      for (int r = 0; r < n_; ++r) {
        double s = 0.0;
        for (int i = 0; i < n_; ++i)
          s += cost_of(basis_[i], f) * Binv_[i * n_ + r];
        price_[r] = s;
      }
      // entering: smallest index with negative reduced cost (Bland)
      int enter = -1;
      for (int j = 0; j < nv_; ++j) {  // artificials never re-enter
        if (in_basis_[j]) continue;
        double d = cost_of(j, f);
        for (int r = 0; r < n_; ++r) d -= price_[r] * colval(r, j);
        if (d < -kTol) { enter = j; break; }
      }
      if (enter < 0) {
        // claimed optimum: refactor to kill accumulated drift, then
        // re-verify the reduced costs once before accepting
        if (since_refactor != 0) {
          if (!refactor()) return 3;
          since_refactor = 0;
          continue;
        }
        for (int i = 0; i < n_; ++i)
          if (xB_[i] < -1e-7) return 3;   // infeasible basis: reject
        return 0;
      }
      compute_col(enter);
      ++since_refactor;
      // ratio test; among near-ties pick the largest pivot (stability —
      // tiny degenerate pivots are what poisoned the basis before).
      // Cycling is theoretically possible without full Bland leaving;
      // the iteration cap + scipy fallback covers that corner.
      int leave = -1;
      double best = std::numeric_limits<double>::infinity();
      for (int i = 0; i < n_; ++i) {
        if (col_[i] > kPivTol) {
          double ratio = std::max(xB_[i], 0.0) / col_[i];
          if (ratio < best - kTol) {
            best = ratio;
            leave = i;
          } else if (ratio < best + kTol &&
                     (leave < 0 || col_[i] > col_[leave])) {
            best = std::min(best, ratio);
            leave = i;
          }
        }
      }
      if (leave < 0) return 2;  // unbounded
      pivot(enter, leave);
    }
    return 3;  // iteration limit
  }

  int n_, nv_, ncols_;
  bool phase1_ = true;
  const double* E_ = nullptr;
  std::vector<double> Binv_, g_, sign_, price_, col_, xB_;
  std::vector<int> basis_, in_basis_;
};

}  // namespace

extern "C" {

// Build stamp: the Makefile passes -DRTMPC_SRC_HASH="<sha256 of this
// file>"; the Python loader compares it against the source on disk and
// rebuilds on mismatch, so a stale or foreign-platform binary can never be
// used silently (git does not preserve mtimes, so mtime checks are moot
// after a fresh clone).
#ifndef RTMPC_SRC_HASH
#define RTMPC_SRC_HASH "unknown"
#endif
const char* rtmpc_src_hash(void) { return RTMPC_SRC_HASH; }

// h_j = max{ c_j^T y : A y <= b };  A: m x n row-major, C: k x n row-major.
// Returns 0; per-direction status in `status` (see file header).
int rtmpc_support_batch(const double* A, const double* b, int m, int n,
                        const double* C, int k,
                        double* h, int* status) {
  // dual constraint matrix E = A^T (n x m), shared across the batch
  std::vector<double> E(static_cast<size_t>(n) * m);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j)
      E[static_cast<size_t>(j) * m + i] = A[static_cast<size_t>(i) * n + j];

  auto solve_one = [&](int t) {
    DenseSimplex sx(n, m);
    double obj = 0.0;
    int rc = sx.solve(E.data(), C + static_cast<size_t>(t) * n, b, &obj);
    if (rc == 0) {
      h[t] = obj;
      status[t] = 0;
    } else if (rc == 1) {           // dual infeasible -> primal unbounded
      h[t] = std::numeric_limits<double>::infinity();
      status[t] = 1;
    } else {                        // dual unbounded / numerical failure
      h[t] = std::numeric_limits<double>::quiet_NaN();
      status[t] = 2;
    }
  };

  // directions are handed out in chunks of 8 to one thread per core
  constexpr int kChunk = 8;
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (int s; (s = next.fetch_add(kChunk)) < k;)
      for (int t = s; t < std::min(s + kChunk, k); ++t) solve_one(t);
  };
  const int n_threads = std::max(1, std::min(
      static_cast<int>(std::thread::hardware_concurrency()),
      (k + kChunk - 1) / kChunk));
  std::vector<std::thread> pool;
  for (int i = 1; i < n_threads; ++i) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
