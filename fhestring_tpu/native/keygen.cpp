// Native TFHE key generation (client-side, CPU).
//
// Counterpart of the key-generation machinery inside tfhe-rs
// (reference dependency: `gen_keys_radix`, reference src/client_key.rs:31;
// SURVEY.md section 2.3): binary LWE/GLWE secret keys, the bootstrap key
// (GGSW encryptions of every LWE secret bit) and the big->small keyswitch
// key.  The NumPy oracle (numpy_ref/core.py:133-160) is the semantic
// specification; this is the production path — prod-parameter keygen drops
// from ~70 s (NumPy uint64 matmuls) to ~1 s (binary-key negacyclic
// accumulation + OpenMP).
//
// Randomness: AES-128-CTR (csprng.cpp).  Every parallel work item draws
// from a disjoint counter region, so the output is deterministic for a
// given key regardless of thread schedule:
//   [0, 2^24)              secret keys
//   [2^32 + j*2^20, ...)   bootstrap-key GGSW for LWE bit j
//   [2^48 + i*2^16, ...)   keyswitch-key block for big-key coefficient i
// The Python client hands this module a DIFFERENT counter window than the
// one its own encryption randomness uses (see native/__init__.py).
//
// C ABI:
//   void tfhe_keygen(n, k, N, ell, pbs_base_log, ks_level, ks_base_log,
//                    torus_bits, lwe_noise_std, glwe_noise_std, key16,
//                    lwe_sk[n], glwe_sk[k*N],
//                    bsk[n,(k+1)*ell,k+1,N], ksk[k*N,ks_level,n+1])
//
// torus_bits < 64 (the reduced-precision turbo mode, params.py) quantizes
// every mask and noise sample to the subgroup 2^(64-torus_bits) * Z: masks
// are full u64 draws with the low bits cleared (draw count unchanged),
// noise is round(N(0, std_rel * 2^torus_bits)) << (64 - torus_bits) —
// matching numpy_ref._uniform/_noise exactly.

#include "csprng.cpp"

#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint64_t SK_BASE = 0;
constexpr uint64_t BSK_BASE = 1ull << 32;
constexpr uint64_t BSK_STRIDE = 1ull << 20;
constexpr uint64_t KSK_BASE = 1ull << 48;
constexpr uint64_t KSK_STRIDE = 1ull << 16;

// Buffered AES-CTR u64/double stream over a private counter region.
struct Stream {
  const uint8_t* key;
  uint64_t counter;
  uint32_t torus_bits;
  uint64_t sub_mask;  // clears the low (64 - torus_bits) bits of a draw

  Stream(const uint8_t* key16, uint64_t counter_base, uint32_t tbits = 64)
      : key(key16), counter(counter_base), torus_bits(tbits),
        sub_mask(tbits >= 64 ? ~0ull : ~((1ull << (64 - tbits)) - 1)) {}

  void fill_u64(uint64_t* out, size_t n) {
    aes128_ctr_fill(reinterpret_cast<uint8_t*>(out), n * 8, key, counter);
    counter += (n * 8 + 15) / 16;
  }

  // Uniform torus mask over the effective subgroup (numpy_ref._uniform).
  void fill_mask(uint64_t* out, size_t n) {
    fill_u64(out, n);
    if (torus_bits < 64)
      for (size_t t = 0; t < n; ++t) out[t] &= sub_mask;
  }

  uint64_t next_u64() {
    uint64_t v;
    fill_u64(&v, 1);
    return v;
  }

  // Standard normal via Box-Muller on two uniform u64 draws.
  double next_normal() {
    uint64_t u[2];
    fill_u64(u, 2);
    double u1 = (static_cast<double>(u[0]) + 1.0) * 0x1p-64;
    double u2 = (static_cast<double>(u[1]) + 1.0) * 0x1p-64;
    return std::sqrt(-2.0 * std::log(u1)) * std::cos(6.283185307179586 * u2);
  }

  // Torus noise sample quantized to the subgroup (numpy_ref._noise):
  // round(N(0, std_rel * 2^torus_bits)) << (64 - torus_bits).
  uint64_t next_noise(double std_rel) {
    if (std_rel == 0.0) return 0;
    double z = next_normal() * std_rel * std::ldexp(1.0, torus_bits);
    return static_cast<uint64_t>(static_cast<int64_t>(std::llround(z)))
           << (64 - torus_bits);
  }

  // Batched torus noise: one AES fill for all 2*count uniforms (the AES key
  // schedule is re-derived per fill, so batching matters in hot loops).
  void fill_noise(uint64_t* out, size_t count, double std_rel) {
    if (std_rel == 0.0) {
      for (size_t t = 0; t < count; ++t) out[t] = 0;
      return;
    }
    std::vector<uint64_t> u(2 * count);
    fill_u64(u.data(), u.size());
    const double scale = std_rel * std::ldexp(1.0, torus_bits);
    const uint32_t sh = 64 - torus_bits;
    for (size_t t = 0; t < count; ++t) {
      double u1 = (static_cast<double>(u[2 * t]) + 1.0) * 0x1p-64;
      double u2 = (static_cast<double>(u[2 * t + 1]) + 1.0) * 0x1p-64;
      double z = std::sqrt(-2.0 * std::log(u1)) *
                 std::cos(6.283185307179586 * u2);
      out[t] = static_cast<uint64_t>(
                   static_cast<int64_t>(std::llround(z * scale)))
               << sh;
    }
  }
};

// out[t] += sign * a[(t - i) mod± N]: negacyclic accumulate of a * X^i.
inline void nega_accum_shift(uint64_t* out, const uint64_t* a, uint32_t N,
                             uint32_t i) {
  for (uint32_t t = 0; t < i; ++t) out[t] -= a[t + N - i];
  for (uint32_t t = i; t < N; ++t) out[t] += a[t - i];
}

}  // namespace

extern "C" {

void tfhe_keygen(uint32_t n, uint32_t k, uint32_t N, uint32_t ell,
                 uint32_t pbs_base_log, uint32_t ks_level,
                 uint32_t ks_base_log, uint32_t torus_bits,
                 double lwe_noise_std, double glwe_noise_std,
                 const uint8_t key16[16], int64_t* lwe_sk, int64_t* glwe_sk,
                 uint64_t* bsk, uint64_t* ksk) {
  // ---- secret keys (single stream, deterministic) -------------------------
  {
    Stream s(key16, SK_BASE);
    std::vector<uint64_t> raw(n + static_cast<size_t>(k) * N);
    s.fill_u64(raw.data(), raw.size());
    for (uint32_t j = 0; j < n; ++j) lwe_sk[j] = raw[j] & 1;
    for (uint32_t i = 0; i < static_cast<uint32_t>(k) * N; ++i)
      glwe_sk[i] = raw[n + i] & 1;
  }

  const uint32_t kp1 = k + 1;
  const size_t row_len = static_cast<size_t>(kp1) * N;
  const size_t ggsw_len = static_cast<size_t>(kp1) * ell * row_len;

  // ---- bootstrap key ------------------------------------------------------
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t j = 0; j < static_cast<int64_t>(n); ++j) {
    Stream s(key16, BSK_BASE + static_cast<uint64_t>(j) * BSK_STRIDE,
             torus_bits);
    const uint64_t bit = static_cast<uint64_t>(lwe_sk[j]);
    uint64_t* out_j = bsk + j * ggsw_len;
    for (uint32_t r = 0; r < kp1; ++r) {
      for (uint32_t lev = 0; lev < ell; ++lev) {
        uint64_t* row = out_j + (static_cast<size_t>(r) * ell + lev) * row_len;
        uint64_t* body = row + static_cast<size_t>(k) * N;
        // GLWE encryption of zero: masks a_i, body = sum a_i*S_i + noise.
        s.fill_noise(body, N, glwe_noise_std);
        for (uint32_t i = 0; i < k; ++i) {
          uint64_t* a = row + static_cast<size_t>(i) * N;
          s.fill_mask(a, N);
          const int64_t* ski = glwe_sk + static_cast<size_t>(i) * N;
          for (uint32_t c = 0; c < N; ++c)
            if (ski[c]) nega_accum_shift(body, a, N, c);
        }
        // message: bit * gadget factor on coefficient 0 of poly r.
        const uint64_t g =
            (pbs_base_log * (lev + 1) >= 64)
                ? 0
                : (1ull << (64 - pbs_base_log * (lev + 1)));
        row[static_cast<size_t>(r) * N] += bit * g;
      }
    }
  }

  // ---- keyswitch key (big -> small) ---------------------------------------
  const uint32_t big_dim = k * N;
  const size_t ksk_row = static_cast<size_t>(n) + 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t i = 0; i < static_cast<int64_t>(big_dim); ++i) {
    Stream s(key16, KSK_BASE + static_cast<uint64_t>(i) * KSK_STRIDE,
             torus_bits);
    const uint64_t ski = static_cast<uint64_t>(glwe_sk[i]);  // flattened key
    for (uint32_t lev = 0; lev < ks_level; ++lev) {
      uint64_t* ct = ksk + (static_cast<size_t>(i) * ks_level + lev) * ksk_row;
      s.fill_mask(ct, n);  // the mask a
      uint64_t b = s.next_noise(lwe_noise_std);
      for (uint32_t t = 0; t < n; ++t)
        b += ct[t] * static_cast<uint64_t>(lwe_sk[t]);
      const uint64_t g = (ks_base_log * (lev + 1) >= 64)
                             ? 0
                             : (1ull << (64 - ks_base_log * (lev + 1)));
      ct[n] = b + ski * g;
    }
  }
}

}  // extern "C"
