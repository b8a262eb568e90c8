// Gaussian-process + expected-improvement core for the autotuner.
//
// Reference equivalents (reimplemented natively, not copied):
//   - gaussian_process.cc (RBF-kernel GP regression; the reference uses
//     Eigen — here a self-contained Cholesky solve, no dependency)
//   - bayesian_optimization.cc (expected-improvement acquisition; the
//     reference maximizes EI with LBFGS over a continuous space — our
//     tunables are a small discrete grid, so EI is evaluated per
//     candidate and argmax'd, same as the Python fallback in
//     common/autotune.py)
//
// One stateless call: fit on (x, y), score EI on candidates. The
// matrices involved are tiny (tens of samples, 1-2 dims), so the O(n^3)
// Cholesky is microseconds — the win over the Python path is removing
// numpy-allocation jitter from the per-cycle tuning step.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// Dense Cholesky A = L L^T (in place, lower). Returns false if not PD.
bool cholesky(std::vector<double>& a, int n) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = a[i * n + j];
      for (int k = 0; k < j; ++k) s -= a[i * n + k] * a[j * n + k];
      if (i == j) {
        if (s <= 0.0) return false;
        a[i * n + i] = std::sqrt(s);
      } else {
        a[i * n + j] = s / a[j * n + j];
      }
    }
    for (int j = i + 1; j < n; ++j) a[i * n + j] = 0.0;
  }
  return true;
}

// Solve L L^T x = b given the Cholesky factor.
void chol_solve(const std::vector<double>& l, int n, std::vector<double>& b) {
  for (int i = 0; i < n; ++i) {  // forward: L y = b
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= l[i * n + k] * b[k];
    b[i] = s / l[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {  // backward: L^T x = y
    double s = b[i];
    for (int k = i + 1; k < n; ++k) s -= l[k * n + i] * b[k];
    b[i] = s / l[i * n + i];
  }
}

double rbf(const double* a, const double* b, int d, double ls) {
  double s = 0.0;
  for (int k = 0; k < d; ++k) {
    double diff = a[k] - b[k];
    s += diff * diff;
  }
  return std::exp(-0.5 * s / (ls * ls));
}

double norm_cdf(double z) { return 0.5 * (1.0 + std::erf(z / M_SQRT2)); }

double norm_pdf(double z) {
  return std::exp(-0.5 * z * z) / std::sqrt(2.0 * M_PI);
}

}  // namespace

extern "C" {

// GP fit on (x[n*d], y[n]) with RBF(length_scale) + noise, then compute
// expected improvement for cand[m*d] into ei_out[m] (and optionally the
// posterior mean into mu_out[m] if non-null). Returns the argmax index
// of EI, or -1 on numerical failure (caller falls back).
int64_t hvd_gp_ei(const double* x, const double* y, int64_t n, int64_t d,
                  const double* cand, int64_t m, double length_scale,
                  double noise, double xi, double* ei_out, double* mu_out) {
  if (n <= 0 || m <= 0 || d <= 0) return -1;
  const int ni = static_cast<int>(n);
  std::vector<double> k(ni * ni);
  for (int i = 0; i < ni; ++i) {
    for (int j = 0; j < ni; ++j)
      k[i * ni + j] = rbf(x + i * d, x + j * d, d, length_scale);
    k[i * ni + i] += noise;
  }
  if (!cholesky(k, ni)) return -1;

  std::vector<double> alpha(y, y + ni);  // K^-1 y
  chol_solve(k, ni, alpha);

  double best = y[0];
  for (int i = 1; i < ni; ++i)
    if (y[i] > best) best = y[i];

  int64_t argmax = 0;
  double ei_max = -1.0;
  std::vector<double> ks(ni), v(ni);
  for (int64_t c = 0; c < m; ++c) {
    for (int i = 0; i < ni; ++i)
      ks[i] = rbf(cand + c * d, x + i * d, d, length_scale);
    double mu = 0.0;
    for (int i = 0; i < ni; ++i) mu += ks[i] * alpha[i];
    v = ks;
    chol_solve(k, ni, v);  // K^-1 ks
    double var = 1.0;      // k(c,c) = 1 for RBF
    for (int i = 0; i < ni; ++i) var -= ks[i] * v[i];
    if (var < 1e-12) var = 1e-12;
    double sigma = std::sqrt(var);
    double imp = mu - best - xi;
    double z = imp / sigma;
    double ei = imp * norm_cdf(z) + sigma * norm_pdf(z);
    if (ei_out) ei_out[c] = ei;
    if (mu_out) mu_out[c] = mu;
    if (ei > ei_max) {
      ei_max = ei;
      argmax = c;
    }
  }
  return argmax;
}

}  // extern "C"
