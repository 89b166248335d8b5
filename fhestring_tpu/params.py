"""Cryptographic parameter sets for the TFHE engine.

The reference (MakisChristou/fhestring) delegates all FHE math to tfhe-rs
0.5.2 with the preset ``PARAM_MESSAGE_2_CARRY_2_KS_PBS`` and 4 radix blocks
per 8-bit character (reference: src/main.rs:3,22-23,43, src/client_key.rs:31).
We mirror that parameter set exactly (``PARAM_MESSAGE_2_CARRY_2_KS_PBS_64``)
so that noise budgets and plaintext encodings line up with the reference
semantics, plus small deterministic parameter sets for fast CI.

Unlike tfhe-rs, our polynomial products are *exact* integer negacyclic
convolutions (int8-limb contractions or an exact CRT-NTT) rather than f64
FFTs, so
there is no transform noise term; parity with the reference is asserted at
the decrypted-plaintext level (see SURVEY.md section 6 "Hard parts").
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class CryptoParams:
    """TFHE/CGGI parameter set (KS→PBS order, as in tfhe-rs ``*_KS_PBS``).

    Ciphertexts "at rest" live under the large GLWE-derived LWE key of
    dimension ``k*N``; a LUT evaluation keyswitches down to the small LWE key
    (dimension ``n``) and bootstraps back up.
    """

    name: str
    # Arithmetic modulus q = 2**q_bits. Always 64: torus arithmetic is
    # carried on uint32 limb pairs wrapping mod 2**64 (torus.py).
    q_bits: int
    # Small LWE dimension (blind-rotation loop length).
    lwe_dimension: int
    # GLWE dimension k and polynomial size N. Large LWE key dim = k*N.
    glwe_dimension: int
    polynomial_size: int
    # Noise standard deviations, relative to q (tfhe-rs "modular std dev").
    lwe_noise_std: float
    glwe_noise_std: float
    # PBS (bootstrap key) gadget decomposition.
    pbs_base_log: int
    pbs_level: int
    # Keyswitch gadget decomposition.
    ks_base_log: int
    ks_level: int
    # Shortint encoding: plaintext space p = message_modulus * carry_modulus,
    # encoded in the top 1 (padding) + log2(p) bits of the torus.
    message_modulus: int = 4
    carry_modulus: int = 4
    # Radix: number of shortint blocks per 8-bit character.
    num_blocks: int = 4
    # Effective torus precision: ciphertext values are multiples of
    # 2**(64 - torus_bits), i.e. they live in the subgroup
    # 2**(64-torus_bits) * Z / 2**64 Z  ~  Z / 2**torus_bits Z.
    # torus_bits=64 is the tfhe-rs-mirroring default.  torus_bits=32 is the
    # turbo mode, implemented end-to-end: noise and uniform-mask sampling
    # are quantized to the subgroup (numpy_ref._noise/_uniform,
    # native/keygen.cpp), the low 4 of 8 balanced byte-limb planes of every
    # keyswitch key are exactly zero so device keys pack 4 planes
    # (crypto/keys.py) and the keyswitch matmul emits 4 output planes
    # (crypto/pbs.keyswitch), and the PBS digits fit one int8 limb.  All
    # mod-2**64 arithmetic is inherited unchanged (the subgroup is closed
    # under +, -, and integer scaling), so the U64 ciphertext
    # representation keeps lo == 0 everywhere.
    torus_bits: int = 64
    # Linear-accumulation noise budget, in fresh-PBS variance units: the
    # shortint/radix/engine layers keep every ciphertext that can enter a
    # bootstrap below this variance, refreshing (identity PBS) lazily past
    # it.  Larger budgets mean wider linear reduction groups and fewer
    # refresh bootstraps per string method.  The failure event this guards
    # is the NEXT bootstrap's slot decode, whose input error is
    #
    #   sigma_in(V)^2 = V * sigma_fresh^2 + sigma_ks^2 + sigma_modswitch^2
    #
    # against the half-slot tolerance 1/(2*full_space) = 2^-6.  The ks and
    # modswitch terms depend only on (n, ks ladder, N) and DOMINATE at both
    # production sets (sigma_ks ~ 2^-9.2, sigma_ms = sqrt((n+1)/12)/(2N)
    # ~ 2^-9.07), so the budget's own contribution is secondary; see the
    # turbo set below for the measured derivation.  34.0 is the
    # conservative default kept for the sets that have no calibration run
    # (benchmarks/noise_calibration.py).
    noise_budget: float = 34.0

    # ---- derived quantities -------------------------------------------------
    @property
    def q(self) -> int:
        return 1 << self.q_bits

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size

    @property
    def plaintext_space(self) -> int:
        """Number of plaintext slots below the padding bit (16 for 2_2)."""
        return self.message_modulus * self.carry_modulus

    @property
    def full_space(self) -> int:
        """Plaintext slots including the padding bit (32 for 2_2)."""
        return 2 * self.plaintext_space

    @property
    def delta(self) -> int:
        """Plaintext scaling factor: m is encoded as m * delta."""
        return self.q // self.full_space

    @property
    def bits_per_block(self) -> int:
        return int(math.log2(self.message_modulus))

    def __post_init__(self) -> None:
        assert self.message_modulus & (self.message_modulus - 1) == 0
        assert self.polynomial_size & (self.polynomial_size - 1) == 0
        assert self.polynomial_size >= self.full_space, (
            "test polynomial needs at least one coefficient per plaintext slot"
        )
        assert self.q_bits == 64, "torus arithmetic is mod 2**64 (torus.py)"
        assert self.torus_bits in (32, 64)
        # Gadget ladders must stay inside the torus precision: digits are
        # taken from the top torus_bits bits, so deeper ladders would read
        # quantization zeros.
        assert self.pbs_base_log * self.pbs_level <= self.torus_bits
        assert self.ks_base_log * self.ks_level <= self.torus_bits
        # delta (and every encode()d constant) must lie in the subgroup.
        assert self.delta % (1 << (64 - self.torus_bits)) == 0


# ---------------------------------------------------------------------------
# Production parameter set: mirrors tfhe-rs 0.5.2 PARAM_MESSAGE_2_CARRY_2_KS_PBS
# (the set the reference binary uses, src/main.rs:3). 128-bit security.
# ---------------------------------------------------------------------------
PARAM_MESSAGE_2_CARRY_2_KS_PBS_64 = CryptoParams(
    name="msg2_carry2_ks_pbs_q64",
    q_bits=64,
    lwe_dimension=742,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_noise_std=0.000007069849454709433,
    glwe_noise_std=0.00000000000000029403601535432533,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
)

# Default production alias used by client/server APIs.
PARAM_PROD = PARAM_MESSAGE_2_CARRY_2_KS_PBS_64

# ---------------------------------------------------------------------------
# 32-bit-torus production set (turbo mode): same plaintext encoding and the
# same end-to-end noise as the 64-bit mirror, with single-limb PBS digits
# and half the keyswitch planes.  Dimensioning rationale:
#
# - LWE (n=742, sigma/q = 2^-17.1): identical dimension AND noise RATIO to
#   tfhe-rs PARAM_MESSAGE_2_CARRY_2_KS_PBS — LWE security depends on
#   (n, sigma/q), so the 128-bit estimate carries over unchanged.
# - GLWE (k=1, N=2048, sigma/q = 2^-32): 128-bit security at dimension 2048
#   only requires sigma/q >= ~2^-51.7 (the tfhe-rs prod value); 2^-32 is
#   ~2^19 MORE noise, i.e. a strictly larger security margin.  The larger
#   BSK noise is absorbed by a deeper gadget ladder (below).
#   Committed estimate: docs/security_estimate.py (primal-uSVP core-SVP,
#   Bai-Galbraith small-secret scaling) gives BKZ block size beta = 626 at
#   the discretized sigma_abs = 1 (603 at an attacker-favoring 0.5) vs
#   beta = 356/337 for the two vetted-128-bit tfhe-rs anchor instances;
#   the sub-3.2-sigma discretization and Arora-Ge/BKW sample-supply
#   analysis are addressed in docs/SECURITY.md.
# - PBS gadget base_log=8, level=3 (covers 24 of 32 torus bits):
#   decomposition-error std ~2^-15.5 rel, BSK-noise term std ~2^-14.2 rel —
#   both negligible against the keyswitch (~2^-9.2) and modswitch (~2^-10)
#   terms, WHICH ARE IDENTICAL to the 64-bit set (they depend only on
#   n, N, ks ladder and relative LWE noise).  End-to-end decode margin is
#   therefore the same as PARAM_PROD's; benchmarks/noise_calibration.py
#   measures it on the device path.
# - Digits |d| <= 128 fit ONE balanced int8 limb and keys quantized to the
#   subgroup have exactly 4 nonzero byte-limb planes.
# ---------------------------------------------------------------------------
PARAM_MESSAGE_2_CARRY_2_KS_PBS_32 = CryptoParams(
    name="msg2_carry2_ks_pbs_q32",
    q_bits=64,
    lwe_dimension=742,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_noise_std=0.000007069849454709433,
    glwe_noise_std=2.0**-32,
    pbs_base_log=8,
    pbs_level=3,
    ks_base_log=3,
    ks_level=5,
    torus_bits=32,
    # Budget derivation (benchmarks/noise_calibration.py --params turbo,
    # 16384 bootstraps on one H100 80GB HBM3 at 700 W, exact einsum path,
    # zero decode failures):
    #   sigma_fresh = 5.55e-5 rel (2^-14.14); the 4x+y pack measures 16.96
    #   fresh-PBS units vs the theoretical 17.
    # Bootstrap-input margin model (the quantity that must clear 7.04 sigma
    # for the two-sided 2^-40 failure target; ks/ms terms from the design
    # analysis above, sigma_ks ~ 1.7e-3, sigma_ms = sqrt(743/12)/4096
    # ~ 1.92e-3):
    #   V = 34:  margin = 2^-6 / sigma_in = 7.68 sigma
    #   V = 192: margin = 7.43 sigma  (p_fail ~ 2^-42.5 per PBS)
    #   V = 356 would cross the 7.04-sigma line — 192 keeps ~2x variance
    #   headroom on the budget-controlled term while nearly saturating the
    #   achievable grouping win (the ks+ms floor dominates regardless).
    # Client-decode margin at V = 192: 68.4 * sqrt(16.96/192) = 20.3 sigma.
    # benchmarks/noise_calibration.py --pack-units 192 bootstraps packs at
    # this budget and counts decode failures.
    noise_budget=192.0,
)

# Turbo alias (the bench.py default parameter set).
PARAM_TURBO = PARAM_MESSAGE_2_CARRY_2_KS_PBS_32

# ---------------------------------------------------------------------------
# Small parameter sets for CI. Zero/tiny noise keeps tests deterministic and
# fast while exercising every code path (decomposition rounding, modswitch
# drift and negacyclic wraparound still occur).  NOT SECURE — tests only.
# ---------------------------------------------------------------------------
PARAM_TEST_ZERO_NOISE = CryptoParams(
    name="test_zero_noise",
    q_bits=64,
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_noise_std=0.0,
    glwe_noise_std=0.0,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
)

PARAM_TEST_NOISY = CryptoParams(
    name="test_noisy",
    q_bits=64,
    lwe_dimension=32,
    glwe_dimension=1,
    polynomial_size=512,
    lwe_noise_std=2.0**-40,
    glwe_noise_std=2.0**-45,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
)

# Statistically meaningful CI noise set: same RELATIVE lwe noise as prod
# (sigma_lwe ~ 2^-17.1) so keyswitch output noise exercises the same order
# of magnitude of the half-slot margin as production, at CI-sized dims.
# Small n/N keep the absolute blind-rotation noise low, so the margin here
# is wider than prod's — prod margins are measured on the device path by
# benchmarks/noise_calibration.py. NOT SECURE — tests only.
PARAM_TEST_STAT = CryptoParams(
    name="test_stat",
    q_bits=64,
    lwe_dimension=32,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_noise_std=0.000007069849454709433,
    glwe_noise_std=2.0**-40,
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
)

# CI mirrors of the 32-bit turbo set (same gadget shape: base 2^8, 3 levels,
# single-limb digits, 4 key limb planes). NOT SECURE — tests only.
PARAM_TEST32_ZERO_NOISE = CryptoParams(
    name="test32_zero_noise",
    q_bits=64,
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_noise_std=0.0,
    glwe_noise_std=0.0,
    pbs_base_log=8,
    pbs_level=3,
    ks_base_log=3,
    ks_level=5,
    torus_bits=32,
    # Mirrors the turbo budget so CI exercises the same wide reduction
    # groups / refresh thresholds the production set uses (zero noise:
    # any budget is decode-safe here).
    noise_budget=192.0,
)

PARAM_TEST32_STAT = CryptoParams(
    name="test32_stat",
    q_bits=64,
    lwe_dimension=32,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_noise_std=0.000007069849454709433,
    glwe_noise_std=2.0**-32,
    pbs_base_log=8,
    pbs_level=3,
    ks_base_log=3,
    ks_level=5,
    torus_bits=32,
)
