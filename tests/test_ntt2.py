"""Negacyclic twist-folded CRT-NTT (crypto/ntt2.py): exactness vs the
Hankel-path oracle (numpy_ref.ext_product_planes_reference)."""

import numpy as np
import pytest

from fhestring_tpu.crypto import ntt2


def naive_negconv(a, b, n):
    """Schoolbook negacyclic convolution, int64."""
    out = np.zeros(n, np.int64)
    for i in range(n):
        for j in range(n):
            t = (i + j) % n
            sgn = 1 if i + j < n else -1
            out[t] += sgn * int(a[i]) * int(b[j])
    return out


@pytest.mark.parametrize("n", [256, 2048])
def test_roundtrip(n):
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, size=(3, n)).astype(np.int64)
    for p in ntt2.PRIMES3:
        plan = ntt2.make_neg_plan(p, n)
        back = ntt2.neg_inv(ntt2.neg_fwd(a, plan), plan)
        np.testing.assert_array_equal(np.mod(back, p), np.mod(a, p))


@pytest.mark.parametrize("n", [256, 512])
def test_negacyclic_mul_exact(n):
    rng = np.random.default_rng(1)
    a = rng.integers(-128, 128, size=n)
    b = rng.integers(-128, 128, size=n)
    got = ntt2.negacyclic_mul(a, b, n)
    np.testing.assert_array_equal(got, naive_negconv(a, b, n))


def _digit_limbs_np(digits, num_la=3):
    """pbs.balanced_limbs_i32 semantics: int32 -> [..., La] int8."""
    out = []
    state = digits.astype(np.int64)
    for _ in range(num_la):
        l = ((state + 128) % 256) - 128
        out.append(l.astype(np.int8))
        state = (state - l) >> 8
    return np.stack(out, axis=-1)


def _matmul_oracle(dl, key_u64, n):
    """u64 ext product via the existing matmul-path reference."""
    from fhestring_tpu.crypto.keys import balanced_limbs_u64, negacyclic_double
    from fhestring_tpu.numpy_ref.core import (
        ext_product_planes_reference, recombine_planes_numpy)

    doubled = negacyclic_double(key_u64)                # [R, kp1, 2N]
    limbs = np.moveaxis(balanced_limbs_u64(doubled), -1, -2)  # [R,kp1,8,2N]
    p4 = np.concatenate([limbs, limbs], axis=-1)
    drev = np.flip(dl, axis=2)                          # reverse c per i
    drev = np.transpose(drev, (3, 0, 1, 2)).reshape(dl.shape[-1],
                                                    dl.shape[0], -1)
    planes = ext_product_planes_reference(drev, p4, n_poly=n)
    return recombine_planes_numpy(np.asarray(planes))


def _ntt2_path(dl, key_u64, n):
    from fhestring_tpu.crypto.keys import balanced_limbs_u64

    raw_limbs = np.moveaxis(balanced_limbs_u64(key_u64), -1, -2)  # [R,kp1,8,N]
    khat = ntt2.key_hats(raw_limbs, n)
    return ntt2.ext_u64_ntt2_numpy(dl, khat, n)


@pytest.mark.parametrize("n", [256, 2048])
def test_ext_u64_matches_matmul_oracle(n):
    rng = np.random.default_rng(2)
    B, R, kp1 = 2, 2, 2
    digits = rng.integers(-(1 << 22), (1 << 22) + 1, size=(B, R, n))
    dl = _digit_limbs_np(digits)
    key = rng.integers(0, 1 << 64, size=(R, kp1, n), dtype=np.uint64)
    lo_m, hi_m = _matmul_oracle(dl, key, n)
    lo_n, hi_n = _ntt2_path(dl, key, n)
    np.testing.assert_array_equal(lo_n, lo_m)
    np.testing.assert_array_equal(hi_n, hi_m)


def test_ext_u64_worst_case_magnitude():
    """Max-magnitude digits and a key whose limbs are all -128: exercises
    the |U_g| < M3/2 CRT bound."""
    n, B, R, kp1 = 2048, 1, 2, 2
    assert ntt2.max_group_value(3, R, n) < ntt2.M3 // 2
    digits = np.full((B, R, n), 1 << 22, np.int64)
    digits[:, :, ::2] = -(1 << 22) + 1
    dl = _digit_limbs_np(digits)
    # value with every balanced limb == -128: v = -128 * (2^64-1)/255 mod 2^64
    v = np.uint64((-128 * ((1 << 64) - 1) // 255) % (1 << 64))
    key = np.full((R, kp1, n), v, np.uint64)
    lo_m, hi_m = _matmul_oracle(dl, key, n)
    lo_n, hi_n = _ntt2_path(dl, key, n)
    np.testing.assert_array_equal(lo_n, lo_m)
    np.testing.assert_array_equal(hi_n, hi_m)
