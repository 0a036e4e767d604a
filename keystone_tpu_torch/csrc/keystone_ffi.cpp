// Host float64 Fisher-vector encode and diagonal-GMM EM (the port's copy
// of the arithmetic in native/keystone_ffi.cpp, with a plain C interface
// in place of the XLA FFI handlers).
//
// The reference's production encode is EncEval, a C++ library computing
// in double precision on the host; this is its counterpart, the
// precision reference for the card's f32 paths (ops/fisher_kernels.py's
// plain chain, csrc/fisher.cu's kernels) and for the EM of
// models/gmm.py.  Every sum is a double, whatever the I/O type:
//
//   γ_tk  = softmax_k( log w_k + log N(x_t; μ_k, σ²_k) ) · mask_t
//   Φ¹_k  = (Σγx − s0·μ)/σ / (T·√w_k)
//   Φ²_k  = ((Σγx² − 2μΣγx + s0μ²)/σ² − s0) / (T·√(2w_k))
//   out   = [Φ¹ flattened ; Φ² flattened]           (per image: 2·K·D)
//
// Built with g++ at first use (kernels/build.py) and called through
// ctypes (ops/fisher_ffi.py).  Each entry returns 0, or 1 for a shape it
// refuses.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kLog2Pi = 1.8378770664093453;

// One image's encode with double accumulators.  xs: (T, D) row-major,
// mask: (T,), gmm arrays (K,)/(K, D); out: (2*K*D,).
template <typename T>
void EncodeOne(const T* xs, const T* mask, const T* w, const T* mu, const T* var, int64_t t_len, int64_t k,
               int64_t d, T* out, std::vector<double>& s0, std::vector<double>& s1, std::vector<double>& s2,
               std::vector<double>& logp, const std::vector<double>& log_norm) {
  std::fill(s0.begin(), s0.end(), 0.0);
  std::fill(s1.begin(), s1.end(), 0.0);
  std::fill(s2.begin(), s2.end(), 0.0);
  double count = 0.0;

  for (int64_t t = 0; t < t_len; ++t) {
    const double m = static_cast<double>(mask[t]);
    if (m == 0.0) continue;
    count += m;
    const T* x = xs + t * d;
    double mx = -INFINITY;
    for (int64_t kk = 0; kk < k; ++kk) {
      double quad = 0.0;
      const T* muk = mu + kk * d;
      const T* vk = var + kk * d;
      for (int64_t dd = 0; dd < d; ++dd) {
        const double diff = static_cast<double>(x[dd]) - static_cast<double>(muk[dd]);
        quad += diff * diff / static_cast<double>(vk[dd]);
      }
      logp[kk] = log_norm[kk] - 0.5 * quad;
      if (logp[kk] > mx) mx = logp[kk];
    }
    double z = 0.0;
    for (int64_t kk = 0; kk < k; ++kk) {
      logp[kk] = std::exp(logp[kk] - mx);
      z += logp[kk];
    }
    for (int64_t kk = 0; kk < k; ++kk) {
      const double gamma = m * logp[kk] / z;
      if (gamma == 0.0) continue;
      s0[kk] += gamma;
      double* s1k = s1.data() + kk * d;
      double* s2k = s2.data() + kk * d;
      for (int64_t dd = 0; dd < d; ++dd) {
        const double xv = static_cast<double>(x[dd]);
        s1k[dd] += gamma * xv;
        s2k[dd] += gamma * xv * xv;
      }
    }
  }

  const double tn = std::max(count, 1.0);
  for (int64_t kk = 0; kk < k; ++kk) {
    const double wk = static_cast<double>(w[kk]);
    const double n1 = tn * std::sqrt(wk);
    const double n2 = tn * std::sqrt(2.0 * wk);
    const T* muk = mu + kk * d;
    const T* vk = var + kk * d;
    T* phi1 = out + kk * d;
    T* phi2 = out + (k + kk) * d;
    for (int64_t dd = 0; dd < d; ++dd) {
      const double mukd = static_cast<double>(muk[dd]);
      const double vkd = static_cast<double>(vk[dd]);
      const double sigma = std::sqrt(vkd);
      const double a = (s1[kk * d + dd] - s0[kk] * mukd) / sigma / n1;
      const double b =
          ((s2[kk * d + dd] - 2.0 * mukd * s1[kk * d + dd] + s0[kk] * mukd * mukd) / vkd - s0[kk]) / n2;
      phi1[dd] = static_cast<T>(a);
      phi2[dd] = static_cast<T>(b);
    }
  }
}

template <typename T>
int FisherEncode(const T* xs, const T* mask, const T* w, const T* mu, const T* var, int64_t n, int64_t t_len,
                 int64_t k, int64_t d, T* out) {
  if (n < 0 || t_len < 0 || k < 1 || d < 1) return 1;
  // per-component log normalizer: log w_k − ½(Σ_d log σ²_kd + D·log 2π)
  std::vector<double> log_norm(k);
  for (int64_t kk = 0; kk < k; ++kk) {
    double sum_log_var = 0.0;
    for (int64_t dd = 0; dd < d; ++dd) sum_log_var += std::log(static_cast<double>(var[kk * d + dd]));
    log_norm[kk] = std::log(static_cast<double>(w[kk])) - 0.5 * (sum_log_var + static_cast<double>(d) * kLog2Pi);
  }
  std::vector<double> s0(k), s1(k * d), s2(k * d), logp(k);
  for (int64_t i = 0; i < n; ++i) {
    EncodeOne<T>(xs + i * t_len * d, mask + i * t_len, w, mu, var, t_len, k, d, out + i * 2 * k * d, s0, s1, s2,
                 logp, log_norm);
  }
  return 0;
}

// Diagonal-covariance GMM EM from given initial parameters (the seeded
// k-means++ start stays in Python).  The E and M steps of models/gmm.py:
// responsibilities from the log-density, nk floored at 1e-10, variances
// floored at min_var, weights nk / Σmask.
template <typename T>
int GmmEm(const T* x, const T* mask, const T* w0, const T* mu0, const T* var0, int64_t n, int64_t k, int64_t d,
          int64_t iters, double min_var, T* w_out, T* mu_out, T* var_out) {
  if (n < 0 || k < 1 || d < 1 || iters < 0) return 1;
  std::vector<double> w(k), mu(k * d), var(k * d);
  for (int64_t i = 0; i < k; ++i) w[i] = static_cast<double>(w0[i]);
  for (int64_t i = 0; i < k * d; ++i) {
    mu[i] = static_cast<double>(mu0[i]);
    var[i] = static_cast<double>(var0[i]);
  }
  double count = 0.0;
  for (int64_t t = 0; t < n; ++t) count += static_cast<double>(mask[t]);
  if (count <= 0.0) count = 1.0;

  std::vector<double> log_norm(k), logp(k), nk(k), s1(k * d), s2(k * d);
  for (int64_t it = 0; it < iters; ++it) {
    for (int64_t kk = 0; kk < k; ++kk) {
      double sum_log_var = 0.0;
      for (int64_t dd = 0; dd < d; ++dd) sum_log_var += std::log(var[kk * d + dd]);
      log_norm[kk] = std::log(w[kk]) - 0.5 * (sum_log_var + static_cast<double>(d) * kLog2Pi);
    }
    std::fill(nk.begin(), nk.end(), 0.0);
    std::fill(s1.begin(), s1.end(), 0.0);
    std::fill(s2.begin(), s2.end(), 0.0);
    for (int64_t t = 0; t < n; ++t) {
      const double m = static_cast<double>(mask[t]);
      if (m == 0.0) continue;
      const T* xt = x + t * d;
      double mx = -INFINITY;
      for (int64_t kk = 0; kk < k; ++kk) {
        double quad = 0.0;
        for (int64_t dd = 0; dd < d; ++dd) {
          const double diff = static_cast<double>(xt[dd]) - mu[kk * d + dd];
          quad += diff * diff / var[kk * d + dd];
        }
        logp[kk] = log_norm[kk] - 0.5 * quad;
        if (logp[kk] > mx) mx = logp[kk];
      }
      double z = 0.0;
      for (int64_t kk = 0; kk < k; ++kk) {
        logp[kk] = std::exp(logp[kk] - mx);
        z += logp[kk];
      }
      for (int64_t kk = 0; kk < k; ++kk) {
        const double r = m * logp[kk] / z;
        if (r == 0.0) continue;
        nk[kk] += r;
        for (int64_t dd = 0; dd < d; ++dd) {
          const double xv = static_cast<double>(xt[dd]);
          s1[kk * d + dd] += r * xv;
          s2[kk * d + dd] += r * xv * xv;
        }
      }
    }
    for (int64_t kk = 0; kk < k; ++kk) {
      const double nkk = std::max(nk[kk], 1e-10);
      for (int64_t dd = 0; dd < d; ++dd) {
        const double m1 = s1[kk * d + dd] / nkk;
        mu[kk * d + dd] = m1;
        var[kk * d + dd] = std::max(s2[kk * d + dd] / nkk - m1 * m1, min_var);
      }
      w[kk] = nkk / count;
    }
  }
  for (int64_t i = 0; i < k; ++i) w_out[i] = static_cast<T>(w[i]);
  for (int64_t i = 0; i < k * d; ++i) {
    mu_out[i] = static_cast<T>(mu[i]);
    var_out[i] = static_cast<T>(var[i]);
  }
  return 0;
}

}  // namespace

extern "C" {

int ks_fisher_encode_f32(const float* xs, const float* mask, const float* w, const float* mu, const float* var,
                         int64_t n, int64_t t_len, int64_t k, int64_t d, float* out) {
  return FisherEncode<float>(xs, mask, w, mu, var, n, t_len, k, d, out);
}

int ks_fisher_encode_f64(const double* xs, const double* mask, const double* w, const double* mu,
                         const double* var, int64_t n, int64_t t_len, int64_t k, int64_t d, double* out) {
  return FisherEncode<double>(xs, mask, w, mu, var, n, t_len, k, d, out);
}

int ks_gmm_em_f32(const float* x, const float* mask, const float* w0, const float* mu0, const float* var0, int64_t n,
                  int64_t k, int64_t d, int64_t iters, double min_var, float* w_out, float* mu_out, float* var_out) {
  return GmmEm<float>(x, mask, w0, mu0, var0, n, k, d, iters, min_var, w_out, mu_out, var_out);
}

int ks_gmm_em_f64(const double* x, const double* mask, const double* w0, const double* mu0, const double* var0,
                  int64_t n, int64_t k, int64_t d, int64_t iters, double min_var, double* w_out, double* mu_out,
                  double* var_out) {
  return GmmEm<double>(x, mask, w0, mu0, var0, n, k, d, iters, min_var, w_out, mu_out, var_out);
}

}  // extern "C"
