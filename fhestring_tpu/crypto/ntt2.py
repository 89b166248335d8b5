"""Negacyclic twist-folded CRT-NTT for the external product.

This is an O(N log N)-class replacement for the O(N^2) int8-limb Hankel
convolution in the blind rotation (crypto/pbs._ext_planes_einsum), shaped so
every transform stage is a dense matrix product; parallel.py shards its
stages over a device mesh.  It improves on crypto/ntt.py (the cyclic-2N
transform) in three ways:

1. **Negacyclic length-N transforms** (not zero-padded cyclic 2N): the
   negacyclic twist a_j -> a_j * psi^j (psi a primitive 2N-th root mod p)
   folds into the precomputed stage constants, halving every transform.
2. **Three shift-plane groups instead of eight planes.**  The external
   product needs sum_s 256^s * W_s (mod 2^64) over limb shift planes
   s = la + lb, where W_s = sum_{la+lb=s} sum_i negconv(d_la, key_lb) are
   exact integers bounded by 3*R*N*128^2.  Grouping three consecutive s
   with in-domain weights 256^{s-3g},
       U_g = W_{3g} + 256*W_{3g+1} + 65536*W_{3g+2},
   still fits centered 3-prime CRT (|U_g| <= 1.33e13 < M3/2 = 1.55e13,
   verified in tests), and cuts inverse transforms from 8 planes to 3
   groups.  The weights are free: 256^{la} folds into the forward stage-2
   constants, 256^{lb} into the precomputed key hats, 256^{-3g} into the
   inverse constants.
3. **Transpose-friendly stage layout**: with j = j1 + n1*j2 (n1 = 128
   lanes) and k = n2*k1 + k2, the four-step factorization

       ahat[k2, k1] = sum_j1 w^{n2 j1 k1} S[j1, k2],
       S[j1, k2]    = sum_j2 a[j1, j2] * Mf[j1][j2, k2],
       Mf[j1][j2,k2] = psi^{j1 + n1 j2} * w^{j1 k2 + n1 j2 k2}

   makes stage 1 a block-diagonal matmul (the per-j1 twiddles folded into
   the blocks) and stage 2 a dense 128-contraction; the inverse mirrors it.
   Data moves [.., j2, j1] -> T -> blk -> T -> dense -> [.., k2, k1].

The final (lo, hi) u64 output is bit-identical to the Hankel path
(numpy_ref.ext_product_planes_reference) and the NumPy oracle: both equal
the exact integer negacyclic convolution digits (x) key reduced mod 2^64.  Replaces the
concrete-fft negacyclic product inside tfhe-rs's PBS (reference dependency,
SURVEY.md section 2.3) with exact integer arithmetic - no transform noise.

This module holds the NumPy plans + bit-exact reference implementation.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .ntt import _center, omega_root

# Three NTT primes == 1 (mod 4096): support negacyclic N for all N <= 2048.
PRIMES3 = (12289, 40961, 61441)
M3 = PRIMES3[0] * PRIMES3[1] * PRIMES3[2]

LANES = 128
NUM_LB = 8          # key limb planes (u64 -> 8 bytes)
GROUP = 3           # shift planes per group
NUM_GROUPS = 3      # ceil(8 / GROUP); s in {0..7} (s >= 8 vanishes mod 2^64)


def max_group_value(num_la: int, num_r: int, n: int) -> int:
    """Worst-case |U_g| for the grouped scheme (balanced +-128 limbs)."""
    w = num_la * num_r * n * 128 * 128  # max pairs per s is num_la
    return w * (1 + 256 + 65536)


@dataclasses.dataclass(frozen=True)
class NegPlan:
    """Twist-folded negacyclic four-step constants for one (prime, N).

    All arrays are centered int64 residues in (-p/2, p/2].
    Index convention: j = j1 + n1*j2, k = n2*k1 + k2; hat layout [k2, k1].
    """

    p: int
    n: int
    n1: int
    n2: int
    # forward stage 1 (block-diag, twist+twiddle folded): [n1(j1), n2(j2), n2(k2)]
    mf: np.ndarray
    # forward stage 2 (dense): [num_la variants][n1(j1), n1(k1)], 256^la folded
    w1: tuple
    # inverse stage 1 (dense): [n1(k1), n1(j1)]
    w1i: np.ndarray
    # inverse stage 2 (block-diag, untwist+twiddle+1/N+256^{-3g} folded):
    # [NUM_GROUPS variants][n1(j1), n2(k2), n2(j2)]
    mi: tuple


@functools.lru_cache(maxsize=None)
def make_neg_plan(p: int, n: int, num_la: int = 3) -> NegPlan:
    assert (p - 1) % (2 * n) == 0, (p, n)
    n1 = min(LANES, n)
    n2 = n // n1
    psi = omega_root(p, 2 * n)
    w = psi * psi % p
    wi = pow(w, p - 2, p)
    psii = pow(psi, p - 2, p)
    n_inv = pow(n, p - 2, p)
    inv256 = pow(256, p - 2, p)

    j1 = np.arange(n1)
    j2 = np.arange(n2)
    k1 = np.arange(n1)
    k2 = np.arange(n2)

    def pw(base, e):
        e = np.mod(e, 2 * n)
        flat = np.array([pow(base, int(x), p) for x in e.ravel()], dtype=np.int64)
        return flat.reshape(e.shape)

    # Mf[j1, j2, k2] = psi^{j1 + n1 j2} * w^{j1 k2 + n1 j2 k2}
    twist = pw(psi, j1[:, None, None] + n1 * j2[None, :, None]
               + 0 * k2[None, None, :])
    tw = pw(w, j1[:, None, None] * k2[None, None, :]
            + n1 * j2[None, :, None] * k2[None, None, :])
    mf = _center(twist * tw % p, p)

    # W1[j1, k1] = w^{n2 j1 k1} * 256^{la}
    w1_base = pw(w, n2 * j1[:, None] * k1[None, :])
    w1 = tuple(_center(w1_base * pow(256, la, p) % p, p)
               for la in range(num_la))

    # W1i[k1, j1] = w^{-n2 j1 k1}
    w1i = _center(pw(wi, n2 * j1[None, :] * k1[:, None]), p)

    # Mi[j1, k2, j2] = sigma_g * psi^{-j1 - n1 j2} * w^{-j1 k2 - n1 j2 k2}
    untwist = pw(psii, j1[:, None, None] + 0 * k2[None, :, None]
                 + n1 * j2[None, None, :])
    twi = pw(wi, j1[:, None, None] * k2[None, :, None]
             + n1 * k2[None, :, None] * j2[None, None, :])
    base_mi = untwist * twi % p
    mi = tuple(
        _center(base_mi * (n_inv * pow(inv256, 3 * g, p) % p) % p, p)
        for g in range(NUM_GROUPS))
    return NegPlan(p, n, n1, n2, mf, w1, w1i, mi)


# ---------------------------------------------------------------------------
# NumPy reference transforms (exact int64 arithmetic)
# ---------------------------------------------------------------------------

def _bmm_exact(x: np.ndarray, mats: np.ndarray, p: int) -> np.ndarray:
    """Exact batched modular contraction sum_j x[.., a, j] mats[a, j, k] via
    float64 BLAS (|x|,|mats| <= p/2 < 2^16, K <= 128: sums < 2^39 << 2^53)."""
    xf = x.astype(np.float64)
    out = np.empty(x.shape[:-1] + (mats.shape[-1],))
    for a in range(mats.shape[0]):
        out[..., a, :] = xf[..., a, :] @ mats[a].astype(np.float64)
    return _center(np.rint(out).astype(np.int64), p)


def neg_fwd(a: np.ndarray, plan: NegPlan, la: int = 0) -> np.ndarray:
    """a int [..., N] -> centered twisted-hat [..., N] (flat h = k2*n1 + k1).

    Computes NTT_n(a_j * psi^j) * 256^la, centered mod p.  All matmuls run
    in float64, which is exact for centered operands (products < 2^31,
    sums over <= 128 terms < 2^39 << 2^53).
    """
    p, n1, n2 = plan.p, plan.n1, plan.n2
    x = a.reshape(a.shape[:-1] + (n2, n1)).astype(np.int64)   # [.., j2, j1]
    xt = np.swapaxes(x, -1, -2)                               # [.., j1, j2]
    # stage 1: S[j1, k2] = sum_j2 x[j1, j2] Mf[j1][j2, k2]
    s = _bmm_exact(_center(xt, p), plan.mf, p)                # [.., j1, k2]
    st = np.swapaxes(s, -1, -2)                               # [.., k2, j1]
    # stage 2: ahat[k2, k1] = sum_j1 S[k2, j1] W1[j1, k1]
    prod = st.astype(np.float64) @ plan.w1[la].astype(np.float64)
    out = _center(np.rint(prod).astype(np.int64), p)          # [.., k2, k1]
    return out.reshape(a.shape[:-1] + (plan.n,))


def neg_inv(ahat: np.ndarray, plan: NegPlan, g: int = 0) -> np.ndarray:
    """Centered hat [..., N] -> centered coefficients of sigma_g * a [..., N]."""
    p, n1, n2 = plan.p, plan.n1, plan.n2
    c = ahat.reshape(ahat.shape[:-1] + (n2, n1)).astype(np.int64)  # [.., k2, k1]
    prod = _center(c, p).astype(np.float64) @ plan.w1i.T.astype(np.float64)
    q = _center(np.rint(prod).astype(np.int64), p)             # [.., k2, j1]
    qt = np.swapaxes(q, -1, -2)                                # [.., j1, k2]
    out = _bmm_exact(qt, plan.mi[g], p)                        # [.., j1, j2]
    out = np.swapaxes(out, -1, -2)                             # [.., j2, j1]
    return out.reshape(ahat.shape[:-1] + (plan.n,))


def negacyclic_mul(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """Exact negacyclic convolution of small-int sequences via 3-prime CRT.

    |result| must be < M3/2."""
    res = []
    for p in PRIMES3:
        plan = make_neg_plan(p, n)
        ah = neg_fwd(a, plan)
        bh = neg_fwd(b, plan)
        res.append(neg_inv(_center(ah * bh, p), plan))
    return crt3(*res)


def crt3(v1: np.ndarray, v2: np.ndarray, v3: np.ndarray) -> np.ndarray:
    """Centered 3-prime CRT (mixed radix): residues -> int in (-M3/2, M3/2]."""
    p1, p2, p3 = PRIMES3
    inv_p1_p2 = pow(p1, p2 - 2, p2)
    inv_p12_p3 = pow(p1 * p2 % p3, p3 - 2, p3)
    x1 = np.mod(v1, p1).astype(np.int64)
    x2 = np.mod((np.mod(v2, p2) - x1) * inv_p1_p2, p2)
    x3 = np.mod((np.mod(v3, p3) - x1 - p1 * x2) * inv_p12_p3, p3)
    v = x1 + p1 * x2 + (p1 * p2) * x3           # in [0, M3)
    # Centered into (-M3/2, M3/2]: subtract when v >= (M3+1)//2, i.e.
    # v > M3//2 for odd M3.
    return np.where(v > M3 // 2, v - M3, v)


# ---------------------------------------------------------------------------
# Grouped external product (NumPy reference, bit-exact vs the matmul path)
# ---------------------------------------------------------------------------

def key_hats(key_limbs: np.ndarray, n: int) -> np.ndarray:
    """Forward-transform key limb planes with 256^lb folded in.

    key_limbs: int8 [..., 8(lb), N] (limb planes of the raw polys, NOT
    doubled).  Returns centered int16 [3(prime), ..., 8, N] twisted hats of
    key_lb * 256^lb."""
    hats = []
    for p in PRIMES3:
        plan = make_neg_plan(p, n)
        h = neg_fwd(key_limbs.astype(np.int64), plan)
        scale = np.array([pow(256, lb, p) for lb in range(NUM_LB)],
                         dtype=np.int64)
        h = _center(h * scale[..., :, None], p)
        hats.append(h)
    return np.stack(hats).astype(np.int16)


def ext_u64_ntt2_numpy(dl: np.ndarray, khat: np.ndarray, n: int):
    """Grouped-CRT external product, NumPy reference.

    dl: int8 [B, R, N, La] digit limbs (natural c order, pbs._digit_limbs);
    khat: int16 [3, R, kp1, 8, N] from key_hats (this step's key).
    Returns (lo, hi) uint32 [B, kp1, N] == the matmul path's u64 output.
    """
    B, R, _, num_la = dl.shape
    kp1 = khat.shape[2]
    assert max_group_value(num_la, R, n) < M3 // 2

    d = np.moveaxis(dl, -1, 0).astype(np.int64)        # [La, B, R, N]
    ug = np.zeros((NUM_GROUPS, B, kp1, n), np.int64)
    for pi, p in enumerate(PRIMES3):
        plan = make_neg_plan(p, n)
        dhat = np.stack([neg_fwd(d[la], plan, la=la)
                         for la in range(num_la)])     # [La, B, R, N]
        kh = khat[pi].astype(np.int64)                 # [R, kp1, 8, N]
        res = []
        for g in range(NUM_GROUPS):
            acc = np.zeros((B, kp1, n), np.int64)
            for la in range(num_la):
                for lb in range(NUM_LB):
                    s = la + lb
                    if s // GROUP != g or s >= NUM_LB:
                        continue
                    acc += np.einsum("bin,ijn->bjn", dhat[la], kh[:, :, lb])
            res.append(neg_inv(_center(acc, p), plan, g=g))
        ug_p = np.stack(res)                           # [G, B, kp1, N]
        if pi == 0:
            residues = [ug_p]
        else:
            residues.append(ug_p)
    u = crt3(*residues)                                # [G, B, kp1, N] ints

    # ext = sum_g U_g << (24 g)  (mod 2^64)
    acc = np.zeros((B, kp1, n), np.uint64)
    for g in range(NUM_GROUPS):
        acc += (u[g].astype(np.int64).astype(np.uint64)
                << np.uint64(24 * g))
    return ((acc & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (acc >> np.uint64(32)).astype(np.uint32))
