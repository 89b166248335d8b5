"""Device-format key material for the PBS pipeline.

Host keygen lives in ``numpy_ref`` (client side, CPU).  This module packs the
server-side evaluation keys into the int8-limb layouts the device path
contracts:

- Bootstrap key: negacyclically-doubled polynomials split into 8 balanced
  signed int8 limb planes, ``[n, (k+1)*ell, k+1, 8, 2N]`` — the RHS generator
  for the blind-rotation matmuls.
- Keyswitch key: balanced int8 limb planes flattened for a single
  ``[B, kN*ks_level] @ [kN*ks_level, (n+1)*8]`` int8 matmul.
- LUT bank: doubled test polynomials as U64 ``[num_luts, 2N]``.
- Optionally the NTT-domain bootstrap key for the CRT-NTT external product
  (``crypto.pbs.bootstrap_path`` says whether a platform needs it).

Replaces tfhe-rs's ServerKey/bootstrapping-key memory layout (reference
dependency; SURVEY.md section 2.3).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .. import torus
from ..numpy_ref import core as ref
from ..params import CryptoParams

U64NP = np.uint64


def balanced_limbs_u64(values: np.ndarray, num_limbs: int = 8) -> np.ndarray:
    """Split uint64 values into balanced signed base-256 limbs (int8).

    v == sum_i limbs[i] * 256**i  (mod 2**64); limbs in [-128, 127].
    The final carry out of limb 7 wraps mod 2**64 and is dropped.
    """
    state = values.astype(U64NP).copy()
    out = np.zeros(values.shape + (num_limbs,), dtype=np.int8)
    for i in range(num_limbs):
        d = (state & U64NP(0xFF)).astype(np.int64)
        state >>= U64NP(8)
        carry = (d >= 128).astype(np.int64)
        d = d - carry * 256
        state += carry.astype(U64NP)
        out[..., i] = d.astype(np.int8)
    return out


def negacyclic_double(poly: np.ndarray) -> np.ndarray:
    """[..., N] -> [..., 2N] with the second half negated (mod 2**64)."""
    return np.concatenate([poly.astype(U64NP), U64NP(0) - poly.astype(U64NP)], axis=-1)


@dataclasses.dataclass
class DeviceServerKeys:
    params: CryptoParams
    # int8 [n, (k+1)*ell, k+1, 8, 2N]: doubled BSK polys, balanced limb planes.
    bsk_limbs: jnp.ndarray
    # int8 [kN*ks_level, (n+1)*P]: KSK limb planes ready for the KS matmul.
    # P = 8 byte planes (64-bit torus) or 4 (32-bit torus: the low 4 planes
    # of every subgroup-valued key are identically zero and are dropped).
    ksk_limbs: jnp.ndarray
    # int16 [n, 2(prime), (k+1)*ell, k+1, 8, 2N] or None: NTT-domain key
    # limb planes (centered residues) for the CRT-NTT external product.
    bsk_ntt: jnp.ndarray | None = None


def _dsk_flatten(k: DeviceServerKeys):
    return (k.bsk_limbs, k.ksk_limbs, k.bsk_ntt), k.params


def _dsk_unflatten(params, children):
    return DeviceServerKeys(params, *children)


jax.tree_util.register_pytree_node(DeviceServerKeys, _dsk_flatten, _dsk_unflatten)


def pack_bsk_ntt(bsk_limbs: np.ndarray) -> np.ndarray:
    """Forward-NTT the doubled BSK limb planes per CRT prime.

    bsk_limbs int8 [n, R, k+1, 8, 2N] -> int16 [n, 2, R, k+1, 8, 2N]
    (centered residues; prime axis second for cheap per-step slicing)."""
    from . import ntt

    length = bsk_limbs.shape[-1]
    hats = []
    for p in ntt.PRIMES:
        plan = ntt.make_plan(p, length)
        h = ntt.ntt_fwd(bsk_limbs.astype(np.int64), plan)
        hats.append(h.astype(np.int16))
    return np.stack(hats, axis=1)


def pack_server_keys(srv: ref.ServerKeys,
                     with_ntt: bool = False) -> DeviceServerKeys:
    p = srv.params
    # BSK: [n, R, k+1, N] u64 -> doubled [.., 2N] -> limbs [.., 2N, 8] -> move
    # the limb axis before the coefficient axis.
    doubled = negacyclic_double(srv.bsk)
    limbs = balanced_limbs_u64(doubled)  # [n, R, k+1, 2N, 8]
    bsk_limbs = np.moveaxis(limbs, -1, -2)  # [n, R, k+1, 8, 2N]

    # KSK: [kN, ks_level, n+1] u64 -> limbs [kN, lev, n+1, 8]
    ksk = balanced_limbs_u64(srv.ksk)
    K = p.big_lwe_dimension * p.ks_level
    if p.torus_bits == 32:
        # subgroup-valued keys: byte planes 0-3 are identically zero —
        # drop them so the KS matmul emits (n+1)*4 planes.
        assert not ksk[..., :4].any(), "ksk not in the 32-bit subgroup"
        ksk = ksk[..., 4:]
    nplanes = ksk.shape[-1]
    ksk_limbs = ksk.reshape(K, (p.lwe_dimension + 1) * nplanes)

    bsk_ntt = pack_bsk_ntt(bsk_limbs) if with_ntt else None
    return DeviceServerKeys(
        params=p,
        bsk_limbs=jnp.asarray(bsk_limbs),
        ksk_limbs=jnp.asarray(ksk_limbs),
        bsk_ntt=None if bsk_ntt is None else jnp.asarray(bsk_ntt),
    )


def pack_luts(tables, p: CryptoParams) -> torus.U64:
    """Build a bank of doubled test polynomials. tables: [L][16] ints."""
    polys = np.stack([ref.make_test_poly(t, p) for t in tables])
    return torus.from_numpy(negacyclic_double(polys))
