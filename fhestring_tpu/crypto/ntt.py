"""Exact CRT-NTT polynomial products for the external product.

Replaces the O(N^2) negacyclic int8-limb Hankel convolution inside the
external product with an O(N log N)-class transform evaluated as dense
matrix products (crypto/pbs._ext_planes_ntt).

Formulation. The matmul path contracts digit limb planes against Hankel
strips of the DOUBLED key limb planes: out[t] = sum_c d[c] *
p2_lb[(t - c) mod 2N] — a CYCLIC convolution of length L = 2N (the
negacyclic wrap lives in the p2 data itself: limb planes of the doubled
poly's negated half are independent int8 data, NOT the negated planes).

Exactness strategy (bit-identical to the matmul path, hence to the NumPy
oracle): convolve int8 limb planes — digit planes la (+-128, zero-padded
to 2N) x key planes lb (+-128) — and group products by output shift plane
s = la + lb BEFORE the inverse transform. A grouped conv value is bounded
by num_la * N * 128 * 128 < 2^27, so TWO ~16-bit NTT primes
(p1 = 40961, p2 = 61441, both == 1 mod 4096) reconstruct it exactly via
centered CRT in int32. The resulting planes [B, k+1, 8, N] are the same
integers the matmul path produces; the u64 plane recombination and
everything downstream is unchanged.

Transform layout (per prime): the cyclic length-L NTT
    a_hat[k] = sum_j a[j] w^{jk}          (w = primitive L-th root mod p)
is factored j = N2*j1 + j2, k = k1 + N1*k2 (N1 = 128 lanes) into two
constant-matrix matmuls and one diagonal twiddle:

    Y[k1, j2]   = sum_j1 W1[k1, j1] a[j1, j2]     W1 = w^{N2 j1 k1}
    Z[k1, j2]   = Y * T                           T  = w^{j2 k1}
    ahat[k1,k2] = sum_j2 Z[k1, j2] W2[k2, j2]     W2 = w^{N1 j2 k2}

and the inverse is the mirror image with w^-1 and a folded 1/L. W1/W2/T
are precomputed constants, split into balanced int8 limbs for the matmuls;
operands are re-centered mod p between stages.

This module is the NumPy plan + reference implementation; the batched
device path lives in crypto/pbs.py (_ext_planes_ntt).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# Two NTT primes == 1 (mod 4096): support all power-of-two L = 2N <= 4096.
P1 = 40961   # 2^13 * 5 + 1
P2 = 61441   # 2^12 * 15 + 1
PRIMES = (P1, P2)
M = P1 * P2  # 2,516,787,201 < 2^32; plane-group convs bounded by 2^27 << M/2

LANES = 128


def _find_generator(p: int) -> int:
    """Smallest generator of (Z/p)*."""
    factors = []
    n = p - 1
    d = 2
    while d * d <= n:
        if n % d == 0:
            factors.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        factors.append(n)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
    raise ValueError(p)


@functools.lru_cache(maxsize=None)
def omega_root(p: int, length: int) -> int:
    """A primitive `length`-th root of unity mod p."""
    assert (p - 1) % length == 0, (p, length)
    g = _find_generator(p)
    w = pow(g, (p - 1) // length, p)
    assert pow(w, length, p) == 1 and pow(w, length // 2, p) != 1
    return w


def _center(x: np.ndarray, p: int) -> np.ndarray:
    """Map residues to the balanced range [-(p-1)/2, p/2]."""
    x = np.mod(x, p)
    return np.where(x > p // 2, x - p, x).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class NttPlan:
    """Constant matrices for one (prime, L) pair; centered int64 entries."""

    p: int
    length: int
    n1: int
    n2: int
    w1: np.ndarray      # [N1(k1), N1(j1)]  fwd stage-1
    t: np.ndarray       # [N1(k1), N2(j2)]  fwd twiddle
    w2: np.ndarray      # [N2(k2), N2(j2)]  fwd stage-2
    w1i: np.ndarray     # [N1(j1), N1(k1)]  inv stage-2 (1/L folded in)
    ti: np.ndarray      # [N1(k1), N2(j2)]  inv twiddle
    w2i: np.ndarray     # [N2(k2), N2(j2)]  inv stage-1


@functools.lru_cache(maxsize=None)
def make_plan(p: int, length: int) -> NttPlan:
    n1 = min(LANES, length)
    n2 = length // n1
    w = omega_root(p, length)
    w_inv = pow(w, p - 2, p)
    l_inv = pow(length, p - 2, p)

    k1 = np.arange(n1)[:, None]
    j1 = np.arange(n1)[None, :]
    j2 = np.arange(n2)[None, :]
    k2 = np.arange(n2)[:, None]

    def pp(base, e):
        e = np.mod(e, length)
        return np.array([[pow(base, int(x), p) for x in row] for row in e])

    w1 = pp(w, n2 * j1 * k1)                        # [k1, j1]
    t = pp(w, j2 * k1)                              # [k1, j2]
    w2 = pp(w, n1 * k2 * j2)                        # [k2, j2]
    w1i = pp(w_inv, n2 * j1.T * k1.T) * l_inv % p   # [j1, k1]
    ti = pp(w_inv, j2 * k1)                         # [k1, j2]
    w2i = pp(w_inv, n1 * k2 * j2)                   # [k2, j2]
    return NttPlan(p, length, n1, n2,
                   _center(w1, p), _center(t, p), _center(w2, p),
                   _center(w1i, p), _center(ti, p), _center(w2i, p))


# ---------------------------------------------------------------------------
# NumPy reference transforms (int64 arithmetic, exact)
# ---------------------------------------------------------------------------

def _mm(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """Exact modular matmul via float64 (|a|,|b| <= p/2, K <= 128:
    accumulations bounded by 2^37 << 2^53)."""
    out = a.astype(np.float64) @ b.astype(np.float64)
    return np.rint(out).astype(np.int64) % p


def ntt_fwd(a: np.ndarray, plan: NttPlan) -> np.ndarray:
    """a: int [..., L] -> centered hat [..., L] (index [k1 + N1*k2])."""
    p, n1, n2 = plan.p, plan.n1, plan.n2
    x = _center(a.reshape(a.shape[:-1] + (n1, n2)), p)
    y = np.moveaxis(_mm(plan.w1, np.moveaxis(x, -2, 0).reshape(n1, -1), p)
                    .reshape((n1,) + x.shape[:-2] + (n2,)), 0, -2)
    z = _center(y * plan.t, p)
    out = _mm(z.reshape(-1, n2), plan.w2.T, p).reshape(z.shape)  # [.., k1, k2]
    return _center(out.reshape(a.shape[:-1] + (plan.length,)), p)


def ntt_inv(ahat: np.ndarray, plan: NttPlan) -> np.ndarray:
    """Centered hat [..., L] -> centered coefficients [..., L]."""
    p, n1, n2 = plan.p, plan.n1, plan.n2
    c = _center(ahat.reshape(ahat.shape[:-1] + (n1, n2)), p)
    q = _mm(c.reshape(-1, n2), plan.w2i.T, p).reshape(c.shape)  # [.., k1, j2]
    r = _center(q * plan.ti, p)
    out = np.moveaxis(_mm(plan.w1i, np.moveaxis(r, -2, 0).reshape(n1, -1), p)
                      .reshape((n1,) + r.shape[:-2] + (n2,)), 0, -2)
    return _center(out.reshape(ahat.shape[:-1] + (plan.length,)), p)


def cyclic_mul_ntt(a: np.ndarray, b: np.ndarray, length: int) -> np.ndarray:
    """Exact cyclic convolution of small-int sequences via 2-prime CRT.

    |result coefficients| must be < M/2 (~1.25e9)."""
    res = []
    for p in PRIMES:
        plan = make_plan(p, length)
        res.append(ntt_inv(
            _center(ntt_fwd(a, plan) * ntt_fwd(b, plan), p), plan))
    return crt2(res[0], res[1])


def crt2(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Centered 2-prime CRT: residues (any representatives) -> int in
    (-M/2, M/2]."""
    inv_p1 = pow(P1, P2 - 2, P2)
    x1 = np.mod(v1, P1).astype(np.int64)
    x2 = (np.mod(v2, P2) - x1) * inv_p1 % P2
    v = x1 + P1 * x2                      # in [0, M)
    return np.where(v >= M // 2, v - M, v)


# ---------------------------------------------------------------------------
# External product planes via grouped limb-plane NTT (NumPy reference)
# ---------------------------------------------------------------------------

def key_hats_numpy(p2: np.ndarray) -> list[np.ndarray]:
    """Forward-transform doubled key limb planes: p2 int8 [..., 2N] ->
    [centered int hat [..., 2N] per prime]."""
    length = p2.shape[-1]
    return [ntt_fwd(p2.astype(np.int64), make_plan(p, length))
            for p in PRIMES]


def ext_planes_ntt_numpy(drev: np.ndarray, p4: np.ndarray, n: int) -> np.ndarray:
    """Same contract as numpy_ref.ext_product_planes_reference:
    drev int8 [La, B, R*N] (c reversed per i block), p4 int8 [R, kp1, 8, 4N]
    -> int32 planes [B, kp1, 8, N]. Exact (bit-identical)."""
    num_la, B, kn = drev.shape
    num_r, kp1 = p4.shape[0], p4.shape[1]
    length = 2 * n
    d = drev.reshape(num_la, B, num_r, n)[:, :, :, ::-1].astype(np.int64)
    dpad = np.concatenate([d, np.zeros_like(d)], axis=-1)     # [.., 2N]
    khats = key_hats_numpy(p4[..., :length])                  # [R, kp1, 8, 2N]

    residues = []
    for pi, p in enumerate(PRIMES):
        plan = make_plan(p, length)
        dhat = ntt_fwd(dpad, plan)                            # [La, B, R, 2N]
        convs = np.zeros((8, B, kp1, n), np.int64)
        for s in range(8):
            acc = np.zeros((B, kp1, length), np.int64)
            for la in range(num_la):
                lb = s - la
                if lb < 0 or lb >= 8:
                    continue
                acc += np.einsum("bin,ijn->bjn", dhat[la],
                                 khats[pi][:, :, lb])
            conv = ntt_inv(_center(acc, p), plan)             # [B, kp1, 2N]
            convs[s] = conv[..., :n]                          # t in [0, N)
        residues.append(convs)
    v = crt2(residues[0], residues[1])           # [8, B, kp1, N] exact ints
    return np.moveaxis(v, 0, 2).astype(np.int32)
