"""The JAX limb-exact PBS pipeline must match the NumPy oracle bit-exactly.

Same keys, same ciphertexts, fully deterministic compute => ciphertext-level
equality, not just plaintext-level.
"""

import numpy as np
import pytest

from fhestring_tpu import numpy_ref as ref
from fhestring_tpu import params as P
from fhestring_tpu import torus
from fhestring_tpu.crypto import keys as dkeys
from fhestring_tpu.crypto import pbs as dpbs

U64NP = np.uint64

# Every small parameter set: the 64-bit 1-level sets and the 32-bit 3-level
# sets that share turbo's gadget decomposition.
SMALL_SETS = {
    "zero": P.PARAM_TEST_ZERO_NOISE,
    "noisy": P.PARAM_TEST_NOISY,
    "stat": P.PARAM_TEST_STAT,
    "zero32": P.PARAM_TEST32_ZERO_NOISE,
    "stat32": P.PARAM_TEST32_STAT,
}


@pytest.fixture(scope="module", params=sorted(SMALL_SETS))
def ctx(request):
    p = SMALL_SETS[request.param]
    rng = np.random.default_rng(42)
    sk, srv = ref.keygen(p, rng)
    dev = dkeys.pack_server_keys(srv)
    return p, rng, sk, srv, dev


def test_balanced_limbs_roundtrip():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 1 << 64, size=1000, dtype=U64NP)
    limbs = dkeys.balanced_limbs_u64(v)
    recomp = np.zeros_like(v)
    for i in range(8):
        recomp += limbs[..., i].astype(np.int64).astype(U64NP) * U64NP((1 << (8 * i)) % (1 << 64))
    np.testing.assert_array_equal(recomp, v)


def test_decompose_matches_numpy(ctx):
    p, rng, *_ = ctx
    v = rng.integers(0, 1 << 64, size=(4, 7), dtype=U64NP)
    for base_log, levels in [(p.pbs_base_log, p.pbs_level), (p.ks_base_log, p.ks_level)]:
        want = ref.decompose(v, base_log, levels)
        got = np.asarray(dpbs.decompose(torus.from_numpy(v), base_log, levels))
        np.testing.assert_array_equal(got, want)


def test_keyswitch_matches_numpy(ctx):
    p, rng, sk, srv, dev = ctx
    cts = np.stack([ref.shortint_encrypt(sk, m, rng) for m in [0, 3, 7, 15]])
    want = np.stack([ref.keyswitch(ct, srv) for ct in cts])
    got = torus.to_numpy(dpbs.keyswitch(torus.from_numpy(cts), dev))
    np.testing.assert_array_equal(got, want)


def test_modswitch_matches_numpy(ctx):
    p, rng, sk, srv, dev = ctx
    cts = np.stack([ref.shortint_encrypt(sk, m, rng) for m in [1, 9]])
    small = np.stack([ref.keyswitch(ct, srv) for ct in cts])
    want = np.stack([ref.modswitch(ct, p) for ct in small])
    got = np.asarray(dpbs.modswitch(torus.from_numpy(small), p))
    np.testing.assert_array_equal(got, want)


def test_blind_rotate_and_extract_match_numpy(ctx):
    p, rng, sk, srv, dev = ctx
    table = list(range(16))
    tp = ref.make_test_poly(table, p)
    B = 3
    cts = np.stack([ref.shortint_encrypt(sk, m, rng) for m in [2, 11, 15]])
    small = np.stack([ref.keyswitch(ct, srv) for ct in cts])
    lwe2n = np.stack([ref.modswitch(ct, p) for ct in small])

    # numpy side
    want = []
    for i in range(B):
        acc = np.zeros((p.glwe_dimension + 1, p.polynomial_size), dtype=U64NP)
        acc[p.glwe_dimension] = tp
        acc = ref.blind_rotate(acc, lwe2n[i], srv)
        want.append(ref.sample_extract(acc, p))
    want = np.stack(want)

    # device side
    acc0 = np.zeros((B, p.glwe_dimension + 1, p.polynomial_size), dtype=U64NP)
    acc0[:, p.glwe_dimension] = tp
    got_acc = dpbs.blind_rotate(
        torus.from_numpy(acc0), np.asarray(lwe2n, dtype=np.int32), dev
    )
    got = torus.to_numpy(dpbs.sample_extract(got_acc, p))
    np.testing.assert_array_equal(got, want)


def test_full_pbs_batch_matches_numpy(ctx):
    p, rng, sk, srv, dev = ctx
    identity = list(range(16))
    affine = [(3 * m + 1) % 16 for m in range(16)]
    bank = dkeys.pack_luts([identity, affine], p)

    msgs = [0, 1, 5, 8, 15, 3]
    luts = [0, 1, 0, 1, 0, 1]
    cts = np.stack([ref.shortint_encrypt(sk, m, rng) for m in msgs])

    want = np.stack(
        [ref.pbs(cts[i], identity if luts[i] == 0 else affine, srv) for i in range(len(msgs))]
    )
    got = torus.to_numpy(
        dpbs.pbs_batch(
            torus.from_numpy(cts), np.asarray(luts, np.int32), bank, dev
        )
    )
    np.testing.assert_array_equal(got, want)
    # and the plaintexts are what the LUTs say
    for i, m in enumerate(msgs):
        table = identity if luts[i] == 0 else affine
        assert ref.shortint_decrypt(sk, got[i]) == table[m]


def test_full_pbs_batch_ntt_path_matches(ctx):
    """use_ntt=True (CRT-NTT external product) must agree bit-exactly."""
    p, rng, sk, srv, dev = ctx
    from fhestring_tpu.crypto import keys as dkeys2

    dev_ntt = dkeys2.pack_server_keys(srv, with_ntt=True)
    table = [(11 * m + 2) % 16 for m in range(16)]
    bank = dkeys2.pack_luts([table], p)
    msgs = [0, 4, 9, 15, 2, 7, 12, 1]
    cts = np.stack([ref.shortint_encrypt(sk, m, rng) for m in msgs])
    idx = np.zeros(len(msgs), np.int32)
    want = torus.to_numpy(dpbs.pbs_batch(torus.from_numpy(cts), idx, bank, dev))
    got = torus.to_numpy(dpbs.pbs_batch(torus.from_numpy(cts), idx, bank,
                                        dev_ntt, use_ntt=True))
    np.testing.assert_array_equal(got, want)
