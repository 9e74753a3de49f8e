// Native parity oracle: independent C++ implementations of the sampler /
// table-lookup / Metropolis-Hastings math, used by the test suite as an
// oracle against the device kernels.
//
// This mirrors the role of the reference's native (Rust) layer — the
// algorithmic content of src/distribution.rs (samplers, table lookups),
// src/shader_gen.rs (the MH step math) and src/lib.rs:129-140 (the host
// mean-reduction) — reimplemented from the written behaviour, not
// translated.  On the device the hot path belongs to XLA/Pallas; this library is
// the independent cross-check that keeps the native-component parity
// honest (SURVEY.md §2.1, §7.1).
//
// C ABI only; loaded from Python with ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr float kLogPdfFloor = -100.0f;
constexpr double kTwoPi = 6.283185307179586476925286766559;

// splitmix64: a well-known, public, tiny counter-based generator.  The
// oracle needs *a* reproducible stateless stream per (seed, index), not
// the device's exact one — estimates are compared statistically.
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// Uniform in [0, 1) from a (seed, index, stream) counter triple.
inline double u01(uint64_t seed, uint64_t idx, uint64_t stream) {
  uint64_t h = splitmix64(seed ^ splitmix64(idx ^ splitmix64(stream)));
  return static_cast<double>(h >> 11) * (1.0 / 9007199254740992.0);
}

inline double u01_open(uint64_t seed, uint64_t idx, uint64_t stream) {
  double u = u01(seed, idx, stream);
  return u > 0.0 ? u : 5e-324;
}

enum DistKind : int32_t {
  kUniform = 0,
  kNormal = 1,
  kExponential = 2,
  kCustom = 3,
};

// Inverse-CDF lookup: binary search over the CDF table + linear
// interpolation into the x table (behavioural parity with the 12-iteration
// device search, reference src/distribution.rs:128-158).
inline float sample_from_cdf_table(double u, const float* x_table,
                                   const float* cdf_table, int64_t n) {
  if (n < 2) return n == 1 ? x_table[0] : 0.0f;
  int64_t lo = 0, hi = n - 1;
  while (hi - lo > 1) {
    int64_t mid = (lo + hi) / 2;
    if (static_cast<double>(cdf_table[mid]) < u) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  double c0 = cdf_table[lo], c1 = cdf_table[hi];
  double t = (c1 > c0) ? (u - c0) / (c1 - c0) : 0.0;
  if (t < 0.0) t = 0.0;
  if (t > 1.0) t = 1.0;
  return static_cast<float>(x_table[lo] + t * (x_table[hi] - x_table[lo]));
}

inline float sample_one(int32_t kind, const float* params, uint64_t seed,
                        uint64_t idx, uint64_t stream, const float* x_table,
                        const float* cdf_table, int64_t table_n) {
  switch (kind) {
    case kUniform: {
      double u = u01(seed, idx, stream);
      return static_cast<float>(params[0] + u * (params[1] - params[0]));
    }
    case kNormal: {
      // Box-Muller (the reference's transform, src/distribution.rs:87-114).
      // The device kernels use inverse-CDF erf_inv instead; the oracle
      // matches the DISTRIBUTION, not the stream or tail cutoff.
      double u1 = u01_open(seed, idx, stream * 2 + 1);
      double u2 = u01(seed, idx, stream * 2 + 2);
      double z = std::sqrt(-2.0 * std::log(u1)) * std::cos(kTwoPi * u2);
      return static_cast<float>(params[0] + params[1] * z);
    }
    case kExponential: {
      double u = u01(seed, idx, stream);
      if (u < 1e-7) u = 1e-7;  // reference clamp, distribution.rs:122
      return static_cast<float>(-std::log(u) / params[0]);
    }
    case kCustom: {
      double u = u01(seed, idx, stream);
      return sample_from_cdf_table(u, x_table, cdf_table, table_n);
    }
  }
  return 0.0f;
}

inline float log_pdf_closed(int32_t kind, const float* params, float x) {
  // Closed-form log densities (reference src/shader_gen.rs:543-571).
  switch (kind) {
    case kUniform:
      return (params[0] <= x && x < params[1])
                 ? -std::log(params[1] - params[0])
                 : kLogPdfFloor;
    case kNormal: {
      float z = (x - params[0]) / params[1];
      return -0.5f * z * z - std::log(params[1] * 2.50662827463f);
    }
    case kExponential:
      return (x >= 0.0f) ? std::log(params[0]) - params[0] * x
                         : kLogPdfFloor;
  }
  return kLogPdfFloor;
}

// Interpolated table lookup with out-of-support conventions: 0 for PDF,
// -100 for log-PDF (reference src/distribution.rs:173-281, 367-475).
inline float table_interp(float x, const float* x_table, const float* vals,
                          int64_t n, float outside) {
  if (n < 1) return outside;
  if (x < x_table[0] || x > x_table[n - 1]) return outside;
  int64_t lo = 0, hi = n - 1;
  while (hi - lo > 1) {
    int64_t mid = (lo + hi) / 2;
    if (x_table[mid] <= x) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  float x0 = x_table[lo], x1 = x_table[hi];
  float t = (x1 > x0) ? (x - x0) / (x1 - x0) : 0.0f;
  return vals[lo] + t * (vals[hi] - vals[lo]);
}

}  // namespace

extern "C" {

// Draw n samples from the distribution into out[n].
void mc_sample(int32_t kind, const float* params, uint64_t seed, int64_t n,
               const float* x_table, const float* cdf_table, int64_t table_n,
               float* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = sample_one(kind, params, seed, static_cast<uint64_t>(i), 0,
                        x_table, cdf_table, table_n);
  }
}

// PDF table lookup for each x[i]; 0 outside the table range.
void mc_pdf_from_table(const float* x, int64_t n, const float* x_table,
                       const float* pdf_table, int64_t table_n, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = table_interp(x[i], x_table, pdf_table, table_n, 0.0f);
  }
}

// Log-PDF table lookup for each x[i]; -100 outside the table range.
void mc_log_pdf_from_table(const float* x, int64_t n, const float* x_table,
                           const float* log_pdf_table, int64_t table_n,
                           float* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] =
        table_interp(x[i], x_table, log_pdf_table, table_n, kLogPdfFloor);
  }
}

// Closed-form log-PDF for each x[i].
void mc_log_pdf(int32_t kind, const float* params, const float* x, int64_t n,
                float* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = log_pdf_closed(kind, params, x[i]);
  }
}

// Monte Carlo mean of the k monomial moments x^(1..k) over n samples —
// the oracle's version of the fused-K integrate (per-thread partial means
// + host reduction, reference src/lib.rs:129-140), with double
// accumulation standing in for the device's Kahan/pairwise tree.
void mc_integrate_moments(int32_t kind, const float* params, uint64_t seed,
                          int64_t n, const float* x_table,
                          const float* cdf_table, int64_t table_n, int32_t k,
                          double* out) {
  for (int32_t j = 0; j < k; ++j) out[j] = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    float x = sample_one(kind, params, seed, static_cast<uint64_t>(i), 0,
                         x_table, cdf_table, table_n);
    double p = 1.0;
    for (int32_t j = 0; j < k; ++j) {
      p *= static_cast<double>(x);
      out[j] += p;
    }
  }
  for (int32_t j = 0; j < k; ++j) out[j] /= static_cast<double>(n);
}

// Independence-sampler Metropolis-Hastings over n_chains chains.
// Estimates E[x^(1..k)] under the target; returns the sampling-phase
// acceptance rate.  Math parity with the device kernel: acceptance
// log u < log_p(x') + log_q(x) - log_p(x) - log_q(x'); burn-in advances
// but does not accumulate; f(current_x) accumulates every sampling step;
// per-chain mean / n_steps then unweighted chain average
// (reference src/shader_gen.rs:312-442, 512-536).
double mc_mcmc_moments(int32_t prop_kind, const float* prop_params,
                       int32_t targ_kind, const float* targ_params,
                       uint64_t seed, int64_t n_chains, int64_t n_steps,
                       int64_t n_burnin, const float* prop_x_table,
                       const float* prop_cdf_table, int64_t prop_table_n,
                       const float* targ_lx, const float* targ_lp,
                       int64_t targ_table_n, const float* prop_lx,
                       const float* prop_lp, int64_t prop_log_table_n,
                       int32_t k, double* out) {
  for (int32_t j = 0; j < k; ++j) out[j] = 0.0;
  double n_accept = 0.0;

  for (int64_t c = 0; c < n_chains; ++c) {
    uint64_t chain_seed = splitmix64(seed ^ splitmix64(c + 1));
    float x = sample_one(prop_kind, prop_params, chain_seed, 0, 1,
                         prop_x_table, prop_cdf_table, prop_table_n);
    auto targ_logp = [&](float v) {
      return targ_kind == kCustom
                 ? table_interp(v, targ_lx, targ_lp, targ_table_n,
                                kLogPdfFloor)
                 : log_pdf_closed(targ_kind, targ_params, v);
    };
    auto prop_logp = [&](float v) {
      // CUSTOM proposals use their log table, like the device kernels —
      // closed-form fallthrough would floor both q terms and silently
      // drop the independence-sampler correction.
      return prop_kind == kCustom
                 ? table_interp(v, prop_lx, prop_lp, prop_log_table_n,
                                kLogPdfFloor)
                 : log_pdf_closed(prop_kind, prop_params, v);
    };
    float logp = targ_logp(x);

    double acc[16] = {0.0};
    for (int64_t i = 0; i < n_burnin + n_steps; ++i) {
      float xp = sample_one(prop_kind, prop_params, chain_seed,
                            static_cast<uint64_t>(i + 1), 2, prop_x_table,
                            prop_cdf_table, prop_table_n);
      float logp_prop = targ_logp(xp);
      float log_alpha =
          logp_prop + prop_logp(x) - logp - prop_logp(xp);
      double u = u01_open(chain_seed, static_cast<uint64_t>(i + 1), 3);
      bool accept = std::log(u) < static_cast<double>(log_alpha);
      if (accept) {
        x = xp;
        logp = logp_prop;
      }
      if (i >= n_burnin) {
        double p = 1.0;
        for (int32_t j = 0; j < k && j < 16; ++j) {
          p *= static_cast<double>(x);
          acc[j] += p;
        }
        if (accept) n_accept += 1.0;
      }
    }
    for (int32_t j = 0; j < k && j < 16; ++j) {
      out[j] += acc[j] / static_cast<double>(n_steps);
    }
  }
  for (int32_t j = 0; j < k; ++j) out[j] /= static_cast<double>(n_chains);
  return n_accept /
         (static_cast<double>(n_chains) * static_cast<double>(n_steps));
}

// Multi-dimensional independence-sampler MH over a JOINT target — the
// independent oracle for the nd MH builder (ops/mcmc_nd.py): d-vector chain state, proposals drawn independently
// per dimension from analytic families, acceptance with the proposal
// log-density SUMMED over dimensions, burn-in/collection/averaging
// conventions identical to the 1-D oracle above.  The target is an
// exchangeable d-dimensional Gaussian with pairwise correlation rho
// (precision matrix computed in closed form: for the exchangeable
// covariance C = (1-rho) I + rho 11', C^-1 = a I + b 11' with
// a = 1/(1-rho), b = -rho / ((1-rho)(1+(d-1)rho))) — a joint density the
// strictly 1-D reference cannot express at all.  Writes E[x_0 x_1] and
// E[x_0^2]; returns the acceptance rate.
double mc_mcmc_nd_gauss(double rho, const float* prop_params, int32_t d,
                        uint64_t seed, int64_t n_chains, int64_t n_steps,
                        int64_t n_burnin, double* out) {
  if (d < 1 || d > 16) return -1.0;
  const double a = 1.0 / (1.0 - rho);
  const double b = -rho / ((1.0 - rho) * (1.0 + (d - 1) * rho));
  auto joint_logp = [&](const float* x) {
    double s = 0.0, q = 0.0;
    for (int32_t j = 0; j < d; ++j) {
      s += static_cast<double>(x[j]);
      q += static_cast<double>(x[j]) * static_cast<double>(x[j]);
    }
    return -0.5 * (a * q + b * s * s);
  };
  auto prop_logq = [&](const float* x) {
    double s = 0.0;
    for (int32_t j = 0; j < d; ++j) {
      s += static_cast<double>(
          log_pdf_closed(kNormal, prop_params + 2 * j, x[j]));
    }
    return s;
  };

  double exy = 0.0, ex2 = 0.0, n_accept = 0.0;
  for (int64_t c = 0; c < n_chains; ++c) {
    uint64_t chain_seed = splitmix64(seed ^ splitmix64(c + 1));
    float x[16], xp[16];
    for (int32_t j = 0; j < d; ++j) {
      x[j] = sample_one(kNormal, prop_params + 2 * j, chain_seed, 0,
                        10 + j, nullptr, nullptr, 0);
    }
    double logp = joint_logp(x);
    double acc_xy = 0.0, acc_x2 = 0.0;
    for (int64_t i = 0; i < n_burnin + n_steps; ++i) {
      for (int32_t j = 0; j < d; ++j) {
        xp[j] = sample_one(kNormal, prop_params + 2 * j, chain_seed,
                           static_cast<uint64_t>(i + 1), 100 + j, nullptr,
                           nullptr, 0);
      }
      double logp_prop = joint_logp(xp);
      double log_alpha = logp_prop + prop_logq(x) - logp - prop_logq(xp);
      double u = u01_open(chain_seed, static_cast<uint64_t>(i + 1), 3);
      bool accept = std::log(u) < log_alpha;
      if (accept) {
        std::memcpy(x, xp, sizeof(float) * d);
        logp = logp_prop;
      }
      if (i >= n_burnin) {
        acc_xy += static_cast<double>(x[0]) *
                  static_cast<double>(x[d > 1 ? 1 : 0]);
        acc_x2 += static_cast<double>(x[0]) * static_cast<double>(x[0]);
        if (accept) n_accept += 1.0;
      }
    }
    exy += acc_xy / static_cast<double>(n_steps);
    ex2 += acc_x2 / static_cast<double>(n_steps);
  }
  out[0] = exy / static_cast<double>(n_chains);
  out[1] = ex2 / static_cast<double>(n_chains);
  return n_accept /
         (static_cast<double>(n_chains) * static_cast<double>(n_steps));
}

// Multi-dimensional product-of-independents integration — the oracle for
// the nd integrate sweep (ops/integrate_nd.py): d independent
// draws per sample (analytic or custom-table per dimension), estimating
// E[prod_j x_j] and E[sum_j x_j^2] in double.
void mc_integrate_nd_mean(const int32_t* kinds, const float* params,
                          int32_t d, uint64_t seed, int64_t n,
                          const float* x_table, const float* cdf_table,
                          int64_t table_n, int32_t table_dim,
                          double* out) {
  double prod_acc = 0.0, sq_acc = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    double p = 1.0, q = 0.0;
    for (int32_t j = 0; j < d && j < 16; ++j) {
      const float* tx = (j == table_dim) ? x_table : nullptr;
      const float* tc = (j == table_dim) ? cdf_table : nullptr;
      float v = sample_one(kinds[j], params + 2 * j, seed,
                           static_cast<uint64_t>(i), 200 + j, tx, tc,
                           (j == table_dim) ? table_n : 0);
      p *= static_cast<double>(v);
      q += static_cast<double>(v) * static_cast<double>(v);
    }
    prod_acc += p;
    sq_acc += q;
  }
  out[0] = prod_acc / static_cast<double>(n);
  out[1] = sq_acc / static_cast<double>(n);
}

// Welford-accumulated moments + standard errors, all double — the
// independent oracle for the kernels' pilot-shifted f32 sum-of-squares
// stderr accumulators (streams differ, so tests compare magnitudes).
void mc_integrate_stderr(int32_t kind, const float* params, uint64_t seed,
                         int64_t n, const float* x_table,
                         const float* cdf_table, int64_t table_n, int32_t k,
                         double* out_mean, double* out_se) {
  // Accumulate the running means in out_mean and the Welford M2 sums in
  // out_se directly — any k, no fixed-size scratch (a 16-slot cap here
  // would silently hand back uninitialized memory for the K>16 fused
  // workloads this oracle exists to cross-check).
  for (int32_t j = 0; j < k; ++j) {
    out_mean[j] = 0.0;
    out_se[j] = 0.0;
  }
  for (int64_t i = 0; i < n; ++i) {
    float x = sample_one(kind, params, seed, static_cast<uint64_t>(i), 0,
                         x_table, cdf_table, table_n);
    double p = 1.0;
    for (int32_t j = 0; j < k; ++j) {
      p *= static_cast<double>(x);
      double d = p - out_mean[j];
      out_mean[j] += d / static_cast<double>(i + 1);
      out_se[j] += d * (p - out_mean[j]);
    }
  }
  for (int32_t j = 0; j < k; ++j) {
    double var = n > 0 ? out_se[j] / static_cast<double>(n) : 0.0;
    out_se[j] = std::sqrt(var / static_cast<double>(n));
  }
}

// Split-R-hat + ESS from reduced split-half statistics, all double — the
// independent oracle for ops/mcmc_xla.split_rhat_ess, including the
// degenerate W == 0 branches (frozen-distinct -> +inf, constant -> 1).
void mc_split_rhat_ess(const double* seq_means, const double* within_vars,
                       int64_t m, int64_t n1, double* out_rhat,
                       double* out_ess) {
  double mean = 0.0;
  for (int64_t i = 0; i < m; ++i) mean += seq_means[i];
  mean /= static_cast<double>(m);
  double ss = 0.0;
  double w_sum = 0.0;
  for (int64_t i = 0; i < m; ++i) {
    ss += (seq_means[i] - mean) * (seq_means[i] - mean);
    w_sum += within_vars[i];
  }
  double w = w_sum / static_cast<double>(m);
  double var_means = m > 1 ? ss / static_cast<double>(m - 1) : 0.0;
  double n1f = n1 > 0 ? static_cast<double>(n1) : 1.0;
  double var_plus = (n1f - 1.0) / n1f * w + var_means;
  double total = static_cast<double>(m) * n1f;
  if (w > 0.0) {
    *out_rhat = std::sqrt(var_plus / w);
  } else {
    *out_rhat = var_means > 0.0 ? HUGE_VAL : 1.0;
  }
  double ess =
      var_means > 0.0 ? static_cast<double>(m) * var_plus / var_means
                      : total;
  *out_ess = ess < total ? ess : total;
}

// Host mean-reduction parity: mean over `threads` partials per function
// (reference src/lib.rs:129-140 summed f32 partials in f64).
void mc_mean_reduce(const float* partials, int64_t threads, int32_t k,
                    double* out) {
  for (int32_t j = 0; j < k; ++j) {
    double s = 0.0;
    for (int64_t t = 0; t < threads; ++t) {
      s += static_cast<double>(partials[t * k + j]);
    }
    out[j] = s / static_cast<double>(threads);
  }
}

}  // extern "C"
