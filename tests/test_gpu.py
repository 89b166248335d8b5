"""On-card tier: the bootstrap paths and the served path on a CUDA GPU.

Marked ``gpu``; the ``gpu`` fixture skips them where JAX finds no GPU.
chip_smoke.py runs them in its own process on the card.
"""

import numpy as np
import pytest

from fhestring_tpu import numpy_ref as ref
from fhestring_tpu import params as P
from fhestring_tpu import torus
from fhestring_tpu.crypto import keys as dkeys
from fhestring_tpu.crypto import pbs as dpbs

SMALL_SETS = [P.PARAM_TEST_ZERO_NOISE, P.PARAM_TEST_NOISY, P.PARAM_TEST_STAT,
              P.PARAM_TEST32_ZERO_NOISE, P.PARAM_TEST32_STAT]


@pytest.mark.gpu
@pytest.mark.parametrize("use_ntt", [False, True], ids=["einsum", "ntt"])
@pytest.mark.parametrize("p", SMALL_SETS, ids=lambda p: p.name)
def test_pbs_batch_matches_numpy_on_gpu(gpu, p, use_ntt):
    rng = np.random.default_rng(5)
    sk, srv = ref.keygen(p, rng)
    dev = dkeys.pack_server_keys(srv, with_ntt=use_ntt)
    table = [(7 * m + 2) % 16 for m in range(16)]
    bank = dkeys.pack_luts([table], p)
    msgs = [0, 3, 6, 9, 12, 15, 1, 4]
    cts = np.stack([ref.shortint_encrypt(sk, m, rng) for m in msgs])
    got = torus.to_numpy(dpbs.pbs_batch(
        torus.from_numpy(cts), np.zeros(len(msgs), np.int32), bank, dev,
        use_ntt=use_ntt))
    want = np.stack([ref.pbs(ct, table, srv) for ct in cts])
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_served_round_trip_on_gpu(gpu):
    from fhestring_tpu.client import ClientKey
    from fhestring_tpu.service import FheStringServer, RemoteServerKey

    ck = ClientKey(P.PARAM_TEST32_ZERO_NOISE, seed=4)
    server = FheStringServer(ck.get_server_key()).start()
    try:
        remote = RemoteServerKey(server.address)
        s = ck.encrypt("Hello gpu", 1)
        assert ck.decrypt(remote.to_upper(s)) == "HELLO GPU"
        assert ck.decrypt_char(remote.len(s)) == 9
        assert ck.decrypt_char(
            remote.contains(s, ck.encrypt_no_padding("o g"))) == 1
    finally:
        server.stop()
