// Native (C++/OpenMP) windowed-variogram estimator.
//
// The empirical initializer (reference Utility/empirical_estimation.py:71-133)
// is the only CPU-bound host-side compute in the pipeline: for every input
// point it forms the all-pairs semivariogram of a +/-window segment and fits a
// Gaussian variogram per task.  The Python/numpy path materializes O(window^2)
// pair arrays per (point, task, grid) triple; this kernel streams the pairs
// once per grid candidate with no intermediate allocation, parallelized over
// input points with OpenMP.  Loaded via ctypes (see native/__init__.py); the
// numpy implementation remains as the portable fallback.
//
// Model: gamma(s) = sigma^2 * (1 - exp(-0.5 s^2 / l^2)); for fixed l the
// optimal sigma^2 is closed-form, so the fit is a profile sweep over a
// log-spaced l grid (same estimator as inference/empirical._profile_fit).

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// x: (n,), y: (n, m) row-major.  Outputs est_sigmas (n,), est_ls (n,):
// per-point variogram (sill, lengthscale) estimates averaged over tasks.
void local_variogram_fit(const double* x, const double* y, int64_t n, int64_t m,
                         int64_t window, int64_t n_grid, double* est_sigmas,
                         double* est_ls) {
#pragma omp parallel for schedule(dynamic)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t start = i - window > 0 ? i - window : 0;
    const int64_t end = (i + window < n - 1) ? i + window : n - 1;  // [start, end)
    const int64_t len = end - start;

    double sig_acc = 0.0, l_acc = 0.0;
    for (int64_t task = 0; task < m; ++task) {
      // lag range for the grid
      double lag_min = 1e300, lag_max = 1e-8;
      for (int64_t a = start; a < end; ++a) {
        for (int64_t b = a + 1; b < end; ++b) {
          const double lag = x[b] - x[a];
          if (lag > 0 && lag < lag_min) lag_min = lag;
          if (lag > lag_max) lag_max = lag;
        }
      }
      if (lag_min > 1e299) lag_min = 1e-4;
      if (lag_min < 1e-8) lag_min = 1e-8;

      const double g_lo = std::log(lag_min / 4.0);
      const double g_hi = std::log(lag_max * 4.0);
      double best_resid = 1e300, best_sig = 1e-6, best_l = lag_max;

      for (int64_t g = 0; g < n_grid; ++g) {
        const double ell =
            std::exp(g_lo + (g_hi - g_lo) * (double)g / (double)(n_grid - 1));
        const double inv2l2 = 0.5 / (ell * ell);
        double gg = 0.0, gy = 0.0, yy = 0.0;
        for (int64_t a = start; a < end; ++a) {
          const double xa = x[a], ya = y[a * m + task];
          for (int64_t b = a + 1; b < end; ++b) {
            const double lag = x[b] - xa;
            const double sv = 0.5 * (y[b * m + task] - ya) * (y[b * m + task] - ya);
            const double gv = 1.0 - std::exp(-lag * lag * inv2l2);
            gg += gv * gv;
            gy += gv * sv;
            yy += sv * sv;
          }
        }
        const double s2 = gg > 0 ? gy / (gg > 1e-30 ? gg : 1e-30) : 0.0;
        const double resid = yy - 2.0 * s2 * gy + s2 * s2 * gg;
        if (resid < best_resid) {
          best_resid = resid;
          best_sig = std::sqrt(s2 > 1e-12 ? s2 : 1e-12);
          best_l = ell;
        }
      }
      sig_acc += best_sig;
      l_acc += best_l;
    }
    est_sigmas[i] = sig_acc / (double)m;
    est_ls[i] = l_acc / (double)m;
  }
}

// Windowed second-moment matrices: out (n, m, m) with
// out[i] = Y_seg^T Y_seg / (len - 1) over the +/-window segment of point i.
void windowed_cov(const double* y, int64_t n, int64_t m, int64_t window,
                  double* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t start = i - window > 0 ? i - window : 0;
    const int64_t end = (i + window < n - 1) ? i + window : n - 1;
    const int64_t len = end - start;
    double* s = out + i * m * m;
    for (int64_t a = 0; a < m * m; ++a) s[a] = 0.0;
    for (int64_t r = start; r < end; ++r) {
      const double* row = y + r * m;
      for (int64_t a = 0; a < m; ++a)
        for (int64_t b = 0; b < m; ++b) s[a * m + b] += row[a] * row[b];
    }
    const double denom = len > 1 ? (double)(len - 1) : 1.0;
    for (int64_t a = 0; a < m * m; ++a) s[a] /= denom;
  }
}

}  // extern "C"
