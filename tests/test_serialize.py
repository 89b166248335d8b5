"""Key / ciphertext checkpoint round-trips (serialize.py)."""

import numpy as np

from fhestring_tpu import PARAM_TEST_ZERO_NOISE, serialize
from fhestring_tpu.client import ClientKey


def test_client_key_roundtrip(tmp_path):
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=5)
    path = str(tmp_path / "ck.npz")
    serialize.save_client_key(path, ck)
    ck2 = serialize.load_client_key(path)

    # the restored client decrypts ciphertexts made by the original...
    s = ck.encrypt("roundtrip", 1)
    assert ck2.decrypt(s) == "roundtrip"
    # ...and its fresh encryptions decrypt under the original key
    t = ck2.encrypt("hello", 2)
    assert ck.decrypt(t) == "hello"


def test_server_key_roundtrip_and_eval(tmp_path):
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=5)
    path = str(tmp_path / "sk.npz")
    serialize.save_server_key(path, ck)
    srv = serialize.load_server_key(path)

    s = ck.encrypt("abcd", 1)
    pat = ck.encrypt_no_padding("bc")
    assert ck.decrypt_char(srv.contains(s, pat)) == 1
    assert ck.decrypt_char(srv.len(s)) == 4


def test_server_key_file_has_no_secrets(tmp_path):
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=5)
    path = str(tmp_path / "sk.npz")
    serialize.save_server_key(path, ck)
    data = np.load(path, allow_pickle=False)
    assert "lwe_sk" not in data and "glwe_sk" not in data


def test_ciphertext_roundtrip(tmp_path):
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=6)
    s = ck.encrypt("persist", 2)
    path = str(tmp_path / "ct.npz")
    serialize.save_fhe_string(path, s)
    s2 = serialize.load_fhe_string(path)
    assert ck.decrypt(s2) == "persist"

    srv = ck.get_server_key()
    c = srv.len(s2)
    cpath = str(tmp_path / "char.npz")
    serialize.save_fhe_char(cpath, c)
    assert ck.decrypt_char(serialize.load_fhe_char(cpath)) == 7


def test_packed_server_key_roundtrip(tmp_path):
    """The DEVICE-format key checkpoint restores a working server without
    re-packing, including the optional NTT-domain bootstrap key, and
    get_server_key(cache_path=) loads it instead of packing again."""
    from fhestring_tpu.crypto.keys import pack_server_keys
    from fhestring_tpu.params import PARAM_TEST32_ZERO_NOISE
    from fhestring_tpu.server import ServerKey

    ck = ClientKey(PARAM_TEST32_ZERO_NOISE, seed=3)
    path = str(tmp_path / "packed.npz")
    srv = ServerKey(pack_server_keys(ck._server_raw, with_ntt=True),
                    ck.params)
    serialize.save_packed_server_key(path, srv)

    loaded = serialize.load_packed_server_key(path)
    assert loaded.params == ck.params
    np.testing.assert_array_equal(np.asarray(loaded.backend.sc.keys.bsk_ntt),
                                  np.asarray(srv.backend.sc.keys.bsk_ntt))
    s = ck.encrypt("Hi th", 1)
    assert ck.decrypt(loaded.to_upper(s)) == "HI TH"

    # cache hit: the checkpoint's NTT-domain key comes back although the
    # CPU path would not have packed one
    srv2 = ck.get_server_key(cache_path=path)
    assert srv2.backend.sc.keys.bsk_ntt is not None
    assert ck.decrypt_char(srv2.contains_clear(s, "th")) == 1


def test_packed_server_key_old_version_refused(tmp_path):
    """A packed checkpoint of an older format version is refused by name,
    never loaded with a key layout this build does not read."""
    import pytest

    path = str(tmp_path / "old.npz")
    with open(path, "wb") as f:
        np.savez(f, version=1, kind="packed_server_key",
                 params=serialize.params_to_json(PARAM_TEST_ZERO_NOISE),
                 bsk_limbs=np.zeros(1, np.int8),
                 ksk_limbs=np.zeros(1, np.int8),
                 bsk_ntt32=np.zeros(1, np.int16))
    with pytest.raises(ValueError, match="format version 1"):
        serialize.load_packed_server_key(path)
