"""Checkpoint / serialization of keys and ciphertexts.

The reference derives serde on ``MyClientKey``/``MyServerKey``/
``PublicParameters`` (reference src/client_key.rs:9, src/server_key/mod.rs:13,
src/ciphertext/public_parameters.rs:4) but never writes them anywhere; for a
served deployment, persistence actually matters: prod keygen is seconds to
minutes of CPU and the evaluation keys are hundreds of MB that should be
generated once and shipped to servers. Everything here is flat numpy ``.npz`` — no pickles, no
Python objects on the wire.

Formats (all little-endian numpy):

- client key:  lwe_sk[u8], glwe_sk[u8], bsk[u64], ksk[u64] + params JSON
- server key:  bsk[u64], ksk[u64] + params JSON (no secrets)
- ciphertext:  ct[u64 ...xB, kN+1] (+ kind/degree/noise metadata); covers
  FheString ([L, 4, kN+1]), FheChar ([4, kN+1]) and the bit char results.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from . import torus
from .ciphertext import FheChar, FheString, PublicParameters
from .numpy_ref import core as ref
from .params import CryptoParams
from .shortint import Blocks

# 2: the packed server key holds only bsk_limbs, ksk_limbs and the optional
# bsk_ntt; version-1 packed checkpoints carried kernel-specific key layouts.
FORMAT_VERSION = 2


# ---------------------------------------------------------------------------
# params <-> json
# ---------------------------------------------------------------------------

def params_to_json(p: CryptoParams) -> str:
    return json.dumps(dataclasses.asdict(p))


def params_from_json(s: str) -> CryptoParams:
    return CryptoParams(**json.loads(s))


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def save_client_key(path: str, ck) -> None:
    """Full client checkpoint: secrets + the server-key clone it owns
    (mirrors MyClientKey's fields, reference src/client_key.rs:14-28)."""
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        kind="client_key",
        params=params_to_json(ck.params),
        lwe_sk=ck.secret.lwe_sk,
        glwe_sk=ck.secret.glwe_sk,
        bsk=ck._server_raw.bsk,
        ksk=ck._server_raw.ksk,
    )


def load_client_key(path: str):
    from .client import ClientKey
    from .native import SecureRng

    data = np.load(path, allow_pickle=False)
    assert str(data["kind"]) == "client_key", data["kind"]
    params = params_from_json(str(data["params"]))
    ck = ClientKey.__new__(ClientKey)
    ck.params = params
    ck._rng = SecureRng(seed=None)  # fresh randomness for future encryptions
    ck.secret = ref.SecretKeys(params, data["lwe_sk"], data["glwe_sk"])
    ck._server_raw = ref.ServerKeys(params, data["bsk"], data["ksk"])
    ck.public_parameters = PublicParameters(num_blocks=params.num_blocks)
    return ck


def save_server_key(path: str, ck) -> None:
    """Evaluation keys only — safe to ship to an untrusted server."""
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        kind="server_key",
        params=params_to_json(ck.params),
        bsk=ck._server_raw.bsk,
        ksk=ck._server_raw.ksk,
    )


def load_server_key(path: str):
    """Load evaluation keys and pack them for this platform's bootstrap
    path (crypto.pbs.bootstrap_path)."""
    from .crypto.keys import pack_server_keys
    from .crypto.pbs import bootstrap_path
    from .server import ServerKey

    data = np.load(path, allow_pickle=False)
    assert str(data["kind"]) == "server_key", data["kind"]
    params = params_from_json(str(data["params"]))
    raw = ref.ServerKeys(params, data["bsk"], data["ksk"])
    with_ntt = bootstrap_path(params).use_ntt
    return ServerKey(pack_server_keys(raw, with_ntt=with_ntt), params)


# ---------------------------------------------------------------------------
# packed (device-format) server key: the cold-start killer
# ---------------------------------------------------------------------------

_PACKED_OPTIONAL = ("bsk_ntt",)


def save_packed_server_key(path: str, server_key) -> None:
    """Persist the DEVICE-format evaluation keys (limb planes + the
    NTT-domain bootstrap key when packed).  Packing the NTT-domain key is
    the biggest server cold-start cost (host transforms over the whole
    bootstrap key); a packed checkpoint makes startup a load + upload.
    Uncompressed on purpose: load speed is the point."""
    dk = server_key.backend.sc.keys
    arrs = dict(
        version=FORMAT_VERSION,
        kind="packed_server_key",
        params=params_to_json(dk.params),
        bsk_limbs=np.asarray(dk.bsk_limbs),
        ksk_limbs=np.asarray(dk.ksk_limbs),
    )
    for name in _PACKED_OPTIONAL:
        v = getattr(dk, name)
        if v is not None:
            arrs[name] = np.asarray(v)
    # Write through an open handle: np.savez(path) appends ".npz" when the
    # path lacks it, which would desync the filename from the existence
    # check in client.get_server_key (silent repack on every start).
    with open(path, "wb") as f:
        np.savez(f, **arrs)


def load_packed_server_key(path: str):
    """Load a packed server key saved by save_packed_server_key."""
    import jax.numpy as jnp

    from .crypto.keys import DeviceServerKeys
    from .server import ServerKey

    data = np.load(path, allow_pickle=False)
    assert str(data["kind"]) == "packed_server_key", data["kind"]
    version = int(data["version"])
    if version != FORMAT_VERSION:
        raise ValueError(
            f"packed server key {path!r} has format version {version}, this "
            f"build reads version {FORMAT_VERSION}; re-pack it from the "
            "server key")
    params = params_from_json(str(data["params"]))
    opt = {name: jnp.asarray(data[name]) for name in _PACKED_OPTIONAL
           if name in data}
    dk = DeviceServerKeys(
        params=params,
        bsk_limbs=jnp.asarray(data["bsk_limbs"]),
        ksk_limbs=jnp.asarray(data["ksk_limbs"]),
        **opt,
    )
    return ServerKey(dk, params)


# ---------------------------------------------------------------------------
# ciphertexts
# ---------------------------------------------------------------------------

def _save_blocks(path: str, blocks: Blocks, kind: str) -> None:
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        kind=kind,
        ct=torus.to_numpy(blocks.ct),
        degree=blocks.degree,
        noise_var=blocks.noise_var,
    )


def _load_blocks(data) -> Blocks:
    return Blocks(torus.from_numpy(data["ct"]), int(data["degree"]),
                  float(data["noise_var"]))


def save_fhe_string(path: str, s: FheString) -> None:
    _save_blocks(path, s.blocks, "fhe_string")


def load_fhe_string(path: str) -> FheString:
    data = np.load(path, allow_pickle=False)
    assert str(data["kind"]) == "fhe_string", data["kind"]
    return FheString(_load_blocks(data))


def save_fhe_char(path: str, c: FheChar) -> None:
    _save_blocks(path, c.blocks, "fhe_char")


def load_fhe_char(path: str) -> FheChar:
    data = np.load(path, allow_pickle=False)
    assert str(data["kind"]) == "fhe_char", data["kind"]
    return FheChar(_load_blocks(data))
