"""Bit-exact NumPy reference implementation of the CGGI/TFHE pipeline.

This is the correctness oracle for the JAX production path: every
device kernel (blind rotation, sample extraction, keyswitch, LUT evaluation)
is validated against this module on small parameter sets.  It replaces the
role tfhe-rs v0.5.2 plays for the reference crate (see SURVEY.md section 2.3;
reference call sites: src/ciphertext/fheasciichar.rs:36-103).

Everything is plain ``np.uint64`` arithmetic (numpy wraps mod 2**64, which is
exactly torus arithmetic for q = 2**64).  Polynomial products are exact
integer negacyclic convolutions — O(N^2), fine for the small CI parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..params import CryptoParams

U64 = np.uint64

# Torus arithmetic wraps mod 2**64 by design; numpy's overflow warnings for
# scalar uint64 ops are noise here.
np.seterr(over="ignore")


# ---------------------------------------------------------------------------
# Polynomial helpers (negacyclic ring Z_q[X]/(X^N + 1))
# ---------------------------------------------------------------------------

def negacyclic_matrix(poly: np.ndarray) -> np.ndarray:
    """[N, N] matrix M with M[c, t] = sign * poly[(t - c) mod N].

    Row c is ``poly * X^c`` so that ``a @ M`` is the negacyclic product of
    coefficient vector ``a`` with ``poly``.
    """
    n = poly.shape[-1]
    poly = poly.astype(U64)
    # Row c is the length-N window of w = [-poly[1:], poly] that starts at
    # N-1-c: M[c, t] = poly[t-c] for t >= c and -poly[N+t-c] below.  A
    # read-only strided view, no N x N gather.
    w = np.concatenate([U64(0) - poly[1:], poly])
    return np.lib.stride_tricks.sliding_window_view(w, n)[::-1]


def polymul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact negacyclic product of two coefficient vectors mod 2**64."""
    a = a.astype(U64)
    mat = negacyclic_matrix(b)
    # uint64 matmul wraps mod 2**64 (C semantics) — exact torus arithmetic.
    return a @ mat


def poly_rotate(poly: np.ndarray, amount: int) -> np.ndarray:
    """Multiply by X^amount in the negacyclic ring (amount mod 2N)."""
    n = poly.shape[-1]
    amount = int(amount) % (2 * n)
    sign_flip = amount >= n
    amount = amount % n
    out = np.roll(poly, amount).astype(U64)
    if amount:
        out[:amount] = U64(0) - out[:amount]
    if sign_flip:
        out = U64(0) - out
    return out


# ---------------------------------------------------------------------------
# Gadget decomposition (tfhe-rs style closest-representable, balanced digits)
# ---------------------------------------------------------------------------

def decompose(values: np.ndarray, base_log: int, levels: int, q_bits: int = 64):
    """Signed balanced decomposition of torus values.

    Returns ``digits`` with shape ``(levels,) + values.shape`` (int64, in
    (-B/2, B/2]), ordered most-significant level first, such that

        sum_l digits[l] * q / B**(l+1)  ≈  values   (error < q / (2 B**levels))
    """
    values = values.astype(U64)
    base = 1 << base_log
    half = base >> 1
    shift = q_bits - base_log * levels
    # Round to the closest multiple of 2**shift (ties away from zero is fine:
    # only shifts noise by < 1 LSB of the gadget).
    if shift > 0:
        state = (values >> U64(shift)) + ((values >> U64(shift - 1)) & U64(1))
    else:
        state = values
    digits = np.zeros((levels,) + values.shape, dtype=np.int64)
    for lev in range(levels - 1, -1, -1):  # least significant level first
        d = (state & U64(base - 1)).astype(np.int64)
        state >>= U64(base_log)
        carry = (d >= half).astype(np.int64)
        d = d - carry * base
        state += carry.astype(U64)
        digits[lev] = d
    return digits


def gadget_factor(level: int, base_log: int, levels: int, q_bits: int = 64) -> int:
    """q / B**(level+1) for level in [0, levels), level 0 most significant."""
    del levels
    return 1 << (q_bits - base_log * (level + 1))


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SecretKeys:
    params: CryptoParams
    lwe_sk: np.ndarray   # [n] in {0,1}
    glwe_sk: np.ndarray  # [k, N] in {0,1}

    @property
    def big_lwe_sk(self) -> np.ndarray:
        """Flattened GLWE key as an LWE key of dimension k*N."""
        return self.glwe_sk.reshape(-1)


@dataclasses.dataclass
class ServerKeys:
    params: CryptoParams
    # Bootstrap key: GGSW(lwe_sk[j]) under the GLWE key.
    # bsk[j, row, col, :]: row in [0, (k+1)*levels), col in [0, k+1), poly of N.
    bsk: np.ndarray
    # Keyswitch key big->small: ksk[i, lev, :]: LWE_small(big_sk[i] * g_lev),
    # dim n+1.
    ksk: np.ndarray


def keygen(params: CryptoParams, rng: np.random.Generator) -> tuple[SecretKeys, ServerKeys]:
    p = params
    lwe_sk = rng.integers(0, 2, size=p.lwe_dimension, dtype=np.int64)
    glwe_sk = rng.integers(0, 2, size=(p.glwe_dimension, p.polynomial_size), dtype=np.int64)
    sk = SecretKeys(p, lwe_sk, glwe_sk)

    # --- bootstrap key -----------------------------------------------------
    k, N, ell = p.glwe_dimension, p.polynomial_size, p.pbs_level
    bsk = np.zeros((p.lwe_dimension, (k + 1) * ell, k + 1, N), dtype=U64)
    for j in range(p.lwe_dimension):
        bit = int(lwe_sk[j])
        for r in range(k + 1):
            for lev in range(ell):
                row = glwe_encrypt_zero(sk, rng)
                g = U64(gadget_factor(lev, p.pbs_base_log, ell, p.q_bits) % (1 << 64))
                # add m * g to mask poly r (r < k) or to the body (r == k)
                row[r, 0] = row[r, 0] + U64(bit) * g
                bsk[j, r * ell + lev] = row

    # --- keyswitch key (big key -> small key) ------------------------------
    big_sk = sk.big_lwe_sk
    ksk = np.zeros((p.big_lwe_dimension, p.ks_level, p.lwe_dimension + 1), dtype=U64)
    for i in range(p.big_lwe_dimension):
        for lev in range(p.ks_level):
            g = gadget_factor(lev, p.ks_base_log, p.ks_level, p.q_bits)
            pt = U64((int(big_sk[i]) * g) % (1 << 64))
            ksk[i, lev] = lwe_encrypt_raw(lwe_sk, pt, p.lwe_noise_std, rng,
                                          p.torus_bits)

    return sk, ServerKeys(p, bsk, ksk)


def _noise(std_rel: float, shape, rng: np.random.Generator,
           torus_bits: int = 64) -> np.ndarray:
    """Gaussian torus noise, quantized to the effective torus subgroup:
    multiples of 2**(64 - torus_bits) (exact for torus_bits=64)."""
    if std_rel == 0.0:
        return np.zeros(shape, dtype=U64)
    e = np.rint(rng.normal(0.0, std_rel * 2.0**torus_bits, size=shape))
    e = e.astype(np.int64) << (64 - torus_bits)
    return e.astype(U64)


def _uniform(shape, rng: np.random.Generator, torus_bits: int = 64) -> np.ndarray:
    """Uniform torus mask over the effective subgroup (draw count is
    independent of torus_bits: full u64 draws masked down)."""
    a = rng.integers(0, 1 << 64, size=shape, dtype=U64)
    if torus_bits < 64:
        a &= U64(((1 << torus_bits) - 1) << (64 - torus_bits))
    return a


# ---------------------------------------------------------------------------
# LWE
# ---------------------------------------------------------------------------

def lwe_encrypt_raw(sk_bits: np.ndarray, pt: np.uint64, noise_std: float,
                    rng: np.random.Generator,
                    torus_bits: int = 64) -> np.ndarray:
    """Encrypt raw torus plaintext under a binary LWE key. Returns [dim+1].

    pt must lie in the effective torus subgroup (a multiple of
    2**(64 - torus_bits)); mask and noise are sampled inside it, so the
    ciphertext stays subgroup-valued coordinate-wise."""
    assert int(pt) % (1 << (64 - torus_bits)) == 0, (pt, torus_bits)
    dim = sk_bits.shape[0]
    a = _uniform((dim,), rng, torus_bits)
    b = (a * sk_bits.astype(U64)).sum(dtype=U64) + U64(pt) \
        + _noise(noise_std, (), rng, torus_bits)
    return np.concatenate([a, np.atleast_1d(b)])


def lwe_decrypt_raw(sk_bits: np.ndarray, ct: np.ndarray) -> np.uint64:
    """Return the phase b - <a, s> (plaintext + noise)."""
    a, b = ct[:-1], ct[-1]
    return U64(b - (a * sk_bits.astype(U64)).sum(dtype=U64))


def lwe_trivial(dim: int, pt: np.uint64) -> np.ndarray:
    ct = np.zeros(dim + 1, dtype=U64)
    ct[-1] = U64(pt)
    return ct


# ---------------------------------------------------------------------------
# GLWE
# ---------------------------------------------------------------------------

def glwe_encrypt_zero(sk: SecretKeys, rng: np.random.Generator) -> np.ndarray:
    """GLWE encryption of 0. Returns [k+1, N] (masks then body)."""
    p = sk.params
    k, N = p.glwe_dimension, p.polynomial_size
    out = np.zeros((k + 1, N), dtype=U64)
    body = _noise(p.glwe_noise_std, (N,), rng, p.torus_bits)
    for i in range(k):
        a = _uniform((N,), rng, p.torus_bits)
        out[i] = a
        body = body + polymul(a, sk.glwe_sk[i].astype(U64))
    out[k] = body
    return out


def glwe_decrypt(sk: SecretKeys, ct: np.ndarray) -> np.ndarray:
    """Phase polynomial body - sum_i a_i * S_i."""
    p = sk.params
    k = p.glwe_dimension
    phase = ct[k].copy()
    for i in range(k):
        phase = phase - polymul(ct[i], sk.glwe_sk[i].astype(U64))
    return phase


# ---------------------------------------------------------------------------
# External product, CMux, blind rotation, sample extract, keyswitch
# ---------------------------------------------------------------------------

def external_product(bsk_j: np.ndarray, glwe: np.ndarray, p: CryptoParams) -> np.ndarray:
    """GGSW (x) GLWE -> GLWE.  bsk_j: [(k+1)*ell, k+1, N], glwe: [k+1, N]."""
    k, ell = p.glwe_dimension, p.pbs_level
    out = np.zeros_like(glwe)
    for r in range(k + 1):
        digits = decompose(glwe[r], p.pbs_base_log, ell, p.q_bits)  # [ell, N]
        for lev in range(ell):
            d = digits[lev].astype(U64)  # two's complement wraps mod q
            row = bsk_j[r * ell + lev]   # [k+1, N]
            for col in range(k + 1):
                out[col] = out[col] + polymul(d, row[col])
    return out


def cmux(bsk_j: np.ndarray, d0: np.ndarray, d1: np.ndarray, p: CryptoParams) -> np.ndarray:
    return d0 + external_product(bsk_j, (d1 - d0), p)


def modswitch(ct: np.ndarray, p: CryptoParams) -> np.ndarray:
    """Switch LWE coefficients from q to 2N (rounding)."""
    two_n = 2 * p.polynomial_size
    shift = p.q_bits - (two_n.bit_length() - 1)
    rounded = (ct >> U64(shift)) + ((ct >> U64(shift - 1)) & U64(1))
    return (rounded % U64(two_n)).astype(np.int64)


def blind_rotate(acc: np.ndarray, lwe_2n: np.ndarray,
                 srv: ServerKeys) -> np.ndarray:
    """Rotate acc by -phase(ct) homomorphically; acc: [k+1, N] GLWE."""
    p = srv.params
    a, b = lwe_2n[:-1], int(lwe_2n[-1])
    acc = np.stack([poly_rotate(poly, -b) for poly in acc])
    for j in range(p.lwe_dimension):
        rotated = np.stack([poly_rotate(poly, int(a[j])) for poly in acc])
        acc = cmux(srv.bsk[j], acc, rotated, p)
    return acc


def sample_extract(glwe: np.ndarray, p: CryptoParams) -> np.ndarray:
    """Extract coefficient 0 as an LWE ct under the flattened GLWE key."""
    k, N = p.glwe_dimension, p.polynomial_size
    out = np.zeros(k * N + 1, dtype=U64)
    for i in range(k):
        mask = glwe[i]
        ext = np.zeros(N, dtype=U64)
        ext[0] = mask[0]
        ext[1:] = (-mask[:0:-1].astype(np.int64)).astype(U64)
        out[i * N:(i + 1) * N] = ext
    out[-1] = glwe[k][0]
    return out


def keyswitch(ct_big: np.ndarray, srv: ServerKeys) -> np.ndarray:
    """LWE under big key (k*N) -> LWE under small key (n)."""
    p = srv.params
    out = lwe_trivial(p.lwe_dimension, ct_big[-1])
    a = ct_big[:-1]
    digits = decompose(a, p.ks_base_log, p.ks_level, p.q_bits)  # [lev, kN]
    for lev in range(p.ks_level):
        d = digits[lev].astype(U64)
        out = out - (d[:, None] * srv.ksk[:, lev, :]).sum(axis=0, dtype=U64)
    return out


# ---------------------------------------------------------------------------
# External product over int8 limb planes: the pre-recombination contract of
# the device Hankel path (crypto/pbs._ext_planes_einsum) and of the CRT-NTT
# references (crypto/ntt.py, crypto/ntt2.py).
# ---------------------------------------------------------------------------

def ext_product_planes_reference(drev: np.ndarray, p4: np.ndarray, *,
                                 n_poly: int) -> np.ndarray:
    """Limb-plane external product by explicit negacyclic Hankel strips.

    drev: int8 [La, B, R*N] digit limb planes (c reversed within each of the
    R row blocks); p4: int8 [R, k+1, 8, >= 2N] doubled key limb planes.
    Returns int32 planes [B, k+1, 8, N]; recombine with
    ``sum_s 256^s * sign_extend(plane_s) mod 2^64`` (recombine_planes_numpy).
    """
    drev = np.asarray(drev)
    p4 = np.asarray(p4)
    num_la, B, _ = drev.shape
    num_r, kp1 = p4.shape[:2]
    two_n = 2 * n_poly
    # strip[c', t] = p2[(t - (N-1-c')) mod 2N]
    t = np.arange(n_poly)
    idx = (t[None, :] - (n_poly - 1 - t)[:, None]) % two_n
    d = drev.reshape(num_la, B, num_r, n_poly).astype(np.int64)
    out = np.zeros((B, kp1, 8, n_poly), np.int64)
    for i in range(num_r):
        for j in range(kp1):
            for lb in range(8):
                strip = p4[i, j, lb, :two_n].astype(np.int64)[idx]
                for la in range(min(num_la, 8 - lb)):
                    out[:, j, la + lb] += d[la, :, i] @ strip
    return out.astype(np.int32)


def recombine_planes_numpy(planes) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) uint32 halves of sum_s 256^s * planes[..., s, :] mod 2^64,
    from int32 planes [..., 8, N]."""
    planes = np.asarray(planes)
    acc = np.zeros(planes.shape[:-2] + planes.shape[-1:], np.uint64)
    for s in range(planes.shape[-2]):
        v = planes[..., s, :].astype(np.int64).astype(np.uint64)
        acc += v << np.uint64(8 * s)
    return ((acc & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (acc >> np.uint64(32)).astype(np.uint32))


# ---------------------------------------------------------------------------
# Shortint layer: encode/decode + programmable bootstrap
# ---------------------------------------------------------------------------

def encode(value: int, p: CryptoParams) -> np.uint64:
    return U64((int(value) * p.delta) % (1 << 64))


def decode(phase: np.uint64, p: CryptoParams) -> int:
    full = p.full_space
    rounded = (int(phase) + p.delta // 2) // p.delta
    return rounded % full


def make_test_poly(table, p: CryptoParams) -> np.ndarray:
    """Build the accumulator test polynomial for LUT f: [0,16) -> [0,16).

    T[j] encodes f(m) for the slot containing j, with the last half-slot
    wrapped negacyclically (encodes -f(0))."""
    N = p.polynomial_size
    half_slot = N // p.full_space
    slot = 2 * half_slot  # N / plaintext_space
    out = np.zeros(N, dtype=U64)
    for j in range(N):
        m = (j + half_slot) // slot
        if m < p.plaintext_space:
            out[j] = encode(table[m] % p.plaintext_space, p)
        else:  # wrapped: belongs to m=0 approached from below
            out[j] = U64(-int(encode(table[0] % p.plaintext_space, p)) % (1 << 64))
    return out


def pbs(ct_big: np.ndarray, table, srv: ServerKeys) -> np.ndarray:
    """Full KS->PBS pipeline: LWE(big) in, LWE(big) of table[m] out."""
    p = srv.params
    ct_small = keyswitch(ct_big, srv)
    lwe_2n = modswitch(ct_small, p)
    k, N = p.glwe_dimension, p.polynomial_size
    acc = np.zeros((k + 1, N), dtype=U64)
    acc[k] = make_test_poly(table, p)
    acc = blind_rotate(acc, lwe_2n, srv)
    return sample_extract(acc, p)


# ---------------------------------------------------------------------------
# Convenience: shortint encrypt/decrypt under the big key (ciphertext "at
# rest" representation, matching the KS_PBS order of tfhe-rs).
# ---------------------------------------------------------------------------

def shortint_encrypt(sk: SecretKeys, value: int, rng: np.random.Generator) -> np.ndarray:
    p = sk.params
    return lwe_encrypt_raw(sk.big_lwe_sk, encode(value, p), p.glwe_noise_std,
                           rng, p.torus_bits)


# ---------------------------------------------------------------------------
# LWE public key: encryptions of zero; public-key encryption is a random
# binary subset-sum of them plus the trivial plaintext. Functional parity
# with the tfhe-rs PublicKey the reference constructs (and never uses —
# reference src/client_key.rs:32, fheasciichar.rs:22).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PublicKey:
    """zeros: [M, dim+1] LWE encryptions of 0 under the big key.

    Security rests on LWE + the leftover hash lemma, which needs
    M >= (dim+1) * log2(q) + ~128 — at production parameters that is the
    same multi-GB object tfhe-rs ships for its PublicKey (the reason the
    reference threads but never uses one). Smaller M (tests) still
    decrypts correctly but does not achieve the LHL bound.
    """

    params: CryptoParams
    zeros: np.ndarray

    @property
    def standard_count(self) -> int:
        return (self.zeros.shape[1]) * self.params.q_bits + 128


def public_keygen(sk: SecretKeys, rng: np.random.Generator,
                  zero_count: int | None = None) -> PublicKey:
    p = sk.params
    dim = sk.big_lwe_sk.shape[0]
    m = zero_count or (dim + 1) * p.q_bits + 128
    zeros = np.stack([
        lwe_encrypt_raw(sk.big_lwe_sk, U64(0), p.glwe_noise_std, rng,
                        p.torus_bits)
        for _ in range(m)])
    return PublicKey(p, zeros)


def public_encrypt(pk: PublicKey, value: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Shortint public-key encryption: random subset-sum of zeros + value."""
    r = rng.integers(0, 2, size=pk.zeros.shape[0], dtype=U64)
    ct = (pk.zeros * r[:, None]).sum(axis=0, dtype=U64)
    ct[-1] = U64(ct[-1] + encode(value, pk.params))
    return ct


def shortint_decrypt(sk: SecretKeys, ct: np.ndarray) -> int:
    p = sk.params
    phase = lwe_decrypt_raw(sk.big_lwe_sk, ct)
    return decode(phase, p) % p.plaintext_space
