"""Batched programmable bootstrap: the device compute path.

Pipeline (KS -> PBS order, mirroring tfhe-rs ``*_KS_PBS`` presets used by the
reference, src/main.rs:3):

    LWE(big key, k*N)  --keyswitch-->  LWE(small key, n)
                       --modswitch-->  Z_{2N} coefficients
                       --blind rotate--> GLWE accumulator  (the hot loop)
                       --sample extract--> LWE(big key) of table[m]

All torus arithmetic is exact u64-on-2xuint32 (``torus.py``); every
polynomial product in the blind rotation is an exact integer negacyclic
convolution, evaluated either as int8-limb Hankel contractions with int32
accumulation or as an exact two-prime CRT-NTT.  There is no FFT and
therefore no transform noise (unlike tfhe-rs's f64 FFT; see SURVEY.md
section 6).  ``bootstrap_path`` picks one of the two per platform.

The batch axis B (string positions x blocks x parallel ops) is the
parallelism axis, and the one multi-device sharding splits.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import torus
from ..params import CryptoParams
from ..torus import U64
from .keys import DeviceServerKeys

# ---------------------------------------------------------------------------
# Platform choice
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BootstrapPath:
    """How pbs_batch runs on one platform.

    use_ntt picks the external product, CRT-NTT (True) or Hankel einsum
    (False), and with it the key layout: the CRT-NTT path reads the
    NTT-domain key that ``pack_server_keys(with_ntt=True)`` adds.
    """

    use_ntt: bool

    @property
    def name(self) -> str:
        return "ntt" if self.use_ntt else "einsum"


# The faster exact path on the GPU for each torus width (bits).  bench.py on
# one H100 80GB HBM3 (700 W), warm, full batch: turbo (32-bit, B=2048)
# einsum 477.5 vs CRT-NTT 182.0 PBS/s; 64-bit (B=1024) einsum 691.1 vs
# CRT-NTT 222.7 PBS/s.
_GPU_USE_NTT = {32: False, 64: False}


def bootstrap_path(params: CryptoParams,
                   platform: str | None = None) -> BootstrapPath:
    """The bootstrap path and key layout for ``params`` on ``platform``
    (default: the platform of ``jax.devices()[0]``).  Raises on a platform
    that has no path."""
    if platform is None:
        platform = jax.devices()[0].platform
    if platform == "cpu":
        return BootstrapPath(use_ntt=False)
    if platform == "gpu":
        return BootstrapPath(use_ntt=_GPU_USE_NTT[params.torus_bits])
    raise RuntimeError(f"no bootstrap path for platform {platform!r} "
                       "(supported: cpu, gpu)")


# ---------------------------------------------------------------------------
# Gadget decomposition (device)
# ---------------------------------------------------------------------------

def decompose(v: U64, base_log: int, levels: int) -> jnp.ndarray:
    """Balanced signed decomposition; returns int32 [levels, ...] (level 0 =
    most significant), matching numpy_ref.decompose bit-exactly."""
    shift = 64 - base_log * levels
    state = torus.round_shr(v, shift) if shift > 0 else v
    base = 1 << base_log
    half = base >> 1
    digits = [None] * levels
    for lev in range(levels - 1, -1, -1):
        d = (state.lo & jnp.uint32(base - 1)).astype(jnp.int32)
        state = torus.shr(state, base_log)
        carry = (d >= half).astype(jnp.int32)
        d = d - carry * base
        state = torus.add(state, U64(carry.astype(jnp.uint32), jnp.zeros_like(state.hi)))
        digits[lev] = d
    return jnp.stack(digits)


def balanced_limbs_i32(d: jnp.ndarray, num_limbs: int) -> jnp.ndarray:
    """Split signed int32 digits into balanced int8 limbs: [..., num_limbs]."""
    out = []
    state = d
    for _ in range(num_limbs):
        l = ((state + 128) & 255) - 128
        out.append(l.astype(jnp.int8))
        state = (state - l) >> 8
    return jnp.stack(out, axis=-1)


def recombine_planes(planes: jnp.ndarray) -> U64:
    """sum_s planes[..., s] * 256**s (mod 2**64); planes: int32 [..., 8]."""
    acc = torus.zeros(planes.shape[:-1])
    for s in range(planes.shape[-1]):
        v = torus.from_int32(planes[..., s])
        acc = torus.add(acc, torus.shl(v, 8 * s))
    return acc


# ---------------------------------------------------------------------------
# Keyswitch (big key -> small key)
# ---------------------------------------------------------------------------

def keyswitch(ct: U64, keys: DeviceServerKeys) -> U64:
    """ct: U64 [B, kN+1] -> U64 [B, n+1]."""
    p = keys.params
    kn = p.big_lwe_dimension
    a = U64(ct.lo[:, :kn], ct.hi[:, :kn])
    b = U64(ct.lo[:, kn], ct.hi[:, kn])

    digits = decompose(a, p.ks_base_log, p.ks_level)  # [lev, B, kN] int32
    # K-order must match keys.ksk_limbs: (i, lev) row-major.
    d = jnp.transpose(digits, (1, 2, 0)).astype(jnp.int8)  # [B, kN, lev]
    d = d.reshape(d.shape[0], kn * p.ks_level)

    planes = jax.lax.dot(d, keys.ksk_limbs, preferred_element_type=jnp.int32)
    nplanes = keys.ksk_limbs.shape[1] // (p.lwe_dimension + 1)
    planes = planes.reshape(d.shape[0], p.lwe_dimension + 1, nplanes)
    if nplanes == 4:
        # 32-bit torus: the 4 planes are byte limbs 4..7 of the u64 value —
        # recombine them mod 2^32 into the hi limb; lo stays zero.
        hi = jnp.zeros(planes.shape[:-1], jnp.uint32)
        for s in range(4):
            hi = hi + (planes[..., s].astype(jnp.uint32) << jnp.uint32(8 * s))
        acc = U64(jnp.zeros_like(hi), hi)  # U64 [B, n+1]
    else:
        acc = recombine_planes(planes)  # U64 [B, n+1]

    out = torus.neg(acc)
    out_lo = out.lo.at[:, -1].add(b.lo)
    carry = (out_lo[:, -1] < out.lo[:, -1]).astype(jnp.uint32)
    out_hi = out.hi.at[:, -1].add(b.hi + carry)
    return U64(out_lo, out_hi)


# ---------------------------------------------------------------------------
# Modswitch
# ---------------------------------------------------------------------------

def modswitch(ct: U64, p: CryptoParams) -> jnp.ndarray:
    """U64 [..., n+1] -> int32 in [0, 2N)."""
    two_n_log = (2 * p.polynomial_size).bit_length() - 1
    sh = 32 - two_n_log
    r = (ct.hi >> jnp.uint32(sh)) + ((ct.hi >> jnp.uint32(sh - 1)) & jnp.uint32(1))
    return (r & jnp.uint32(2 * p.polynomial_size - 1)).astype(jnp.int32)


# ---------------------------------------------------------------------------
# CRT-NTT external product (device, XLA): the O(N log N)-class path.
# See crypto/ntt.py for the math; bit-identical planes to the matmul path.
# ---------------------------------------------------------------------------

# Per-prime fold constants: 2^k == c (mod p), |c| small, so
# v -> (v >> k)*c + (v & (2^k - 1)) shrinks |v| while preserving v mod p.
_FOLD = {40961: (17, 8189), 61441: (16, 4095)}


def _modc(v: jnp.ndarray, p: int) -> jnp.ndarray:
    """Centered exact mod: int32 |v| <= 2^30 -> v mod p in (-p/2, p/2]."""
    k, c = _FOLD[p]
    mask = jnp.int32((1 << k) - 1)
    for _ in range(2):
        v = (v >> k) * c + (v & mask)
    # |v| <= ~2^23: exact in f32; v/p never half-integer (p odd).
    q = jnp.round(v.astype(jnp.float32) * jnp.float32(1.0 / p)).astype(jnp.int32)
    return v - q * jnp.int32(p)


def _fold1(v: jnp.ndarray, p: int) -> jnp.ndarray:
    """One fold: |v| <= 2^30 -> |v| <= ~2^27, same residue (cheap, for
    pre-sum shrinking)."""
    k, c = _FOLD[p]
    return (v >> k) * c + (v & jnp.int32((1 << k) - 1))


def _split2(v: jnp.ndarray):
    """Centered int32 |v| <= 32896 -> two balanced int8 limbs."""
    l0 = ((v + 128) & 255) - 128
    l1 = (v - l0) >> 8
    return l0.astype(jnp.int8), l1.astype(jnp.int8)


def _ntt_consts(p: int, length: int):
    """Device constants for one (prime, L): int8 limb pairs of the stage
    matrices + int32 twiddles."""
    from . import ntt as nttmod

    plan = nttmod.make_plan(p, length)

    def limbs(m):
        m = np.asarray(m, np.int64)
        l0 = ((m + 128) % 256) - 128
        l1 = (m - l0) // 256
        assert np.all(np.abs(l1) <= 127)
        return (jnp.asarray(l0, jnp.int8), jnp.asarray(l1, jnp.int8))

    return {
        "w1": limbs(plan.w1), "t": jnp.asarray(plan.t, jnp.int32),
        "w2": limbs(plan.w2),
        "w1i": limbs(plan.w1i), "ti": jnp.asarray(plan.ti, jnp.int32),
        "w2i": limbs(plan.w2i),
        "n1": plan.n1, "n2": plan.n2,
    }


def _eint(subs: str, a8: jnp.ndarray, b8: jnp.ndarray) -> jnp.ndarray:
    """Exact int8 x int8 contraction as a bf16 x bf16 -> f32 matmul.

    int8 values are exact in bf16; products <= 2^14 accumulated over K <=
    128 stay <= 2^21 < 2^24, so the f32 accumulator is exact in any
    summation order.  The operands are bf16, so no TF32 rounding applies."""
    out = jnp.einsum(subs, a8.astype(jnp.bfloat16), b8.astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32)
    return out.astype(jnp.int32)


def _stageA_fwd(x8: jnp.ndarray, cst, p: int) -> jnp.ndarray:
    """x8 int8 [.., N1(j1), N2]; contract j1 with W1 -> centered [.., K1, N2]."""
    acc = None
    for li, wl in enumerate(cst["w1"]):
        part = _eint("KJ,...Jt->...Kt", wl, x8)
        part = part if li == 0 else part * 256
        acc = part if acc is None else acc + part
    return _modc(acc, p)


def _twiddle(y: jnp.ndarray, t: jnp.ndarray, p: int) -> jnp.ndarray:
    return _modc(y * t, p)


def _stageB(z: jnp.ndarray, wlimbs, p: int) -> jnp.ndarray:
    """z centered int32 [.., K1, N2(t)]; contract t with W[C,t] (limb pairs)
    -> centered [.., K1, C]."""
    zl = _split2(z)
    planes = {}
    for lz, zli in enumerate(zl):
        for lw, wli in enumerate(wlimbs):
            s = lz + lw
            part = _eint("...Kt,Ct->...KC", zli, wli)
            planes[s] = planes.get(s, 0) + part
    t2 = _modc(planes[1] + 256 * planes[2], p)
    return _modc(planes[0] + 256 * t2, p)


def _stageA_inv(gl, cst, p: int) -> jnp.ndarray:
    """g limbs (pair of int8 [.., K1, K2]); contract K2 with W2i -> centered
    [.., K1, N2(t)]."""
    planes = {}
    for lg, gli in enumerate(gl):
        for lw, wli in enumerate(cst["w2i"]):
            s = lg + lw
            part = _eint("...KC,Ct->...Kt", gli, wli)
            planes[s] = planes.get(s, 0) + part
    t2 = _modc(planes[1] + 256 * planes[2], p)
    return _modc(planes[0] + 256 * t2, p)


def _stageB_inv(r: jnp.ndarray, cst, p: int) -> jnp.ndarray:
    """r centered [.., K1, N2(t)]; contract K1 with W1i[J,K] -> [.., J, t]."""
    rl = _split2(r)
    planes = {}
    for lr, rli in enumerate(rl):
        for lw, wli in enumerate(cst["w1i"]):
            s = lr + lw
            part = _eint("JK,...Kt->...Jt", wli, rli)
            planes[s] = planes.get(s, 0) + part
    t2 = _modc(planes[1] + 256 * planes[2], p)
    return _modc(planes[0] + 256 * t2, p)


def _ntt_fwd_dev(x8: jnp.ndarray, cst, p: int) -> jnp.ndarray:
    """int8 [.., L] -> centered int32 hat [.., L]."""
    n1, n2 = cst["n1"], cst["n2"]
    x = x8.reshape(x8.shape[:-1] + (n1, n2))
    y = _stageA_fwd(x, cst, p)
    z = _twiddle(y, cst["t"], p)
    out = _stageB(z, cst["w2"], p)
    return out.reshape(x8.shape[:-1] + (n1 * n2,))


def _ntt_inv_dev(ghat: jnp.ndarray, cst, p: int) -> jnp.ndarray:
    """centered int32 [.., L] -> centered int32 coefficients [.., L]."""
    n1, n2 = cst["n1"], cst["n2"]
    g = ghat.reshape(ghat.shape[:-1] + (n1, n2))
    q = _stageA_inv(_split2(g), cst, p)
    r = _twiddle(q, cst["ti"], p)
    out = _stageB_inv(r, cst, p)
    return out.reshape(ghat.shape[:-1] + (n1 * n2,))


def _ext_planes_ntt(dl: jnp.ndarray, khat_j: jnp.ndarray,
                    p_crypto: CryptoParams) -> jnp.ndarray:
    """CRT-NTT external product planes (bit-identical to the matmul path).

    dl: int32 digit limbs [B, R, N, La] (natural c order, from _digit_limbs);
    khat_j: int16 [2(prime), R, kp1, 8, 2N] — this step's NTT-domain key.
    Returns int32 planes [B, kp1, 8, N].
    """
    from . import ntt as nttmod

    N = p_crypto.polynomial_size
    L = 2 * N
    B, R = dl.shape[0], dl.shape[1]
    kp1 = p_crypto.glwe_dimension + 1
    num_la = dl.shape[-1]

    d8 = jnp.transpose(dl, (3, 0, 1, 2)).astype(jnp.int8)   # [La, B, R, N]
    dpad = jnp.concatenate(
        [d8, jnp.zeros_like(d8)], axis=-1)                  # [La, B, R, 2N]

    convs = []
    for pi, p in enumerate(nttmod.PRIMES):
        cst = _ntt_consts(p, L)
        dhat = _ntt_fwd_dev(dpad, cst, p)                   # [La, B, R, L]
        kh = khat_j[pi].astype(jnp.int32)                   # [R, kp1, 8, L]
        groups = []
        for s in range(8):
            acc = None
            for la in range(num_la):
                lb = s - la
                if lb < 0 or lb >= 8:
                    continue
                # sum over input rows i: [B, R, L] * [R, kp1, L] ->
                # [B, kp1, L], elementwise with a fold per row so the int32
                # sum stays exact
                dh = dhat[la]                                # [B, R, L]
                prod = sum(
                    _fold1(dh[:, i, None, :] * kh[i, :, lb], p)
                    for i in range(dh.shape[1]))             # |.| <= R*2^27
                acc = prod if acc is None else acc + prod
            groups.append(_modc(acc, p))
        ghat = jnp.stack(groups)                            # [8, B, kp1, L]
        conv = _ntt_inv_dev(ghat, cst, p)[..., :N]          # [8, B, kp1, N]
        convs.append(conv)

    # centered 2-prime CRT in uint32 (values < M < 2^32)
    P1, P2 = nttmod.PRIMES
    M = P1 * P2
    inv_p1 = pow(P1, P2 - 2, P2)
    x1 = convs[0] + jnp.where(convs[0] < 0, jnp.int32(P1), 0)   # [0, P1)
    x2c = convs[1] + jnp.where(convs[1] < 0, jnp.int32(P2), 0)  # [0, P2)
    t = x2c - x1
    t = t + jnp.where(t < 0, jnp.int32(P2), 0)              # [0, P2)
    prod = t.astype(jnp.uint32) * jnp.uint32(inv_p1)        # < 2^32 exact
    # reduce prod mod P2: folds then exact f32 rounding
    k2, c2 = _FOLD[P2]
    v = (prod >> k2).astype(jnp.int32) * c2 + (prod &
                                               jnp.uint32((1 << k2) - 1)
                                               ).astype(jnp.int32)
    v = _fold1(v, P2)                                       # <= ~2^24
    q = jnp.round(v.astype(jnp.float32) * jnp.float32(1.0 / P2)).astype(jnp.int32)
    x2 = v - q * jnp.int32(P2)
    x2 = x2 + jnp.where(x2 < 0, jnp.int32(P2), 0)           # [0, P2)
    big = x1.astype(jnp.uint32) + jnp.uint32(P1) * x2.astype(jnp.uint32)
    centered = jnp.where(big >= jnp.uint32(M // 2),
                         (big - jnp.uint32(M)).astype(jnp.int32),
                         big.astype(jnp.int32))             # (-M/2, M/2]
    return jnp.moveaxis(centered, 0, 2)                     # [B, kp1, 8, N]


# ---------------------------------------------------------------------------
# Blind rotation
# ---------------------------------------------------------------------------

def _negacyclic_rotate(acc: U64, amounts: jnp.ndarray, n_poly: int) -> U64:
    """acc: U64 [B, C, N]; amounts int32 [B] in [0, 2N): acc * X^amounts."""
    doubled = torus.concatenate([acc, torus.neg(acc)], axis=-1)  # [B, C, 2N]
    t = jnp.arange(n_poly, dtype=jnp.int32)
    idx = (t[None, :] - amounts[:, None]) & (2 * n_poly - 1)  # [B, N]
    idx = idx[:, None, :].astype(jnp.int32)
    idx = jnp.broadcast_to(idx, (acc.lo.shape[0], acc.lo.shape[1], n_poly))
    return torus.gather_last(doubled, idx)


def _negacyclic_rotate_shear(acc: U64, amounts: jnp.ndarray, n_poly: int) -> U64:
    """Gather-free per-item rotation: log2(2N) conditional negacyclic rolls
    (static roll + select per bit of the amount). Bit-identical to
    _negacyclic_rotate."""
    bits = (2 * n_poly).bit_length() - 1  # log2(2N)

    def static_negroll(x: U64, s: int) -> U64:
        if s == 0:
            return x
        head = U64(x.lo[..., n_poly - s:], x.hi[..., n_poly - s:])
        head = torus.neg(head)
        tail = U64(x.lo[..., : n_poly - s], x.hi[..., : n_poly - s])
        return torus.concatenate([head, tail], axis=-1)

    cur = acc
    for k in range(bits):
        s = 1 << k
        if s >= n_poly:
            # rotation by N == global negation
            rolled = torus.neg(cur)
        else:
            rolled = static_negroll(cur, s)
        bit = ((amounts >> k) & 1) == 1  # [B]
        cond = bit[:, None, None]
        cur = torus.where(cond, rolled, cur)
    return cur


def _digit_limbs(diff: U64, p: CryptoParams) -> jnp.ndarray:
    """Decompose diff and split digits into balanced int8 limbs.
    Returns [B, R, N, La] with R = (k+1)*ell ordered (r*ell + lev)."""
    kp1 = p.glwe_dimension + 1
    ell = p.pbs_level
    B = diff.lo.shape[0]
    N = p.polynomial_size
    digits = decompose(diff, p.pbs_base_log, ell)  # [ell, B, k+1, N]
    d = jnp.transpose(digits, (1, 2, 0, 3)).reshape(B, kp1 * ell, N)
    num_digit_limbs = (p.pbs_base_log + 8) // 8  # |digit| <= 2^(base_log-1)
    return balanced_limbs_i32(d, num_digit_limbs)


def _ext_planes_einsum(dl: jnp.ndarray, bsk_j: jnp.ndarray,
                       p: CryptoParams) -> jnp.ndarray:
    """Hankel einsum path: planes int32 [B, kp1, 8, N].
    kp1 is taken from bsk_j (may be a key-sharded slice of k+1)."""
    N = p.polynomial_size
    kp1 = bsk_j.shape[1]
    B = dl.shape[0]
    num_digit_limbs = dl.shape[-1]

    t = jnp.arange(N, dtype=jnp.int32)
    c = jnp.arange(N, dtype=jnp.int32)
    idx = (t[None, :] - c[:, None]) & (2 * N - 1)  # [N, N]
    mats = jnp.take(bsk_j, idx, axis=-1)  # [R, k+1, 8, N, N]

    planes = jnp.zeros((B, kp1, 8, N), jnp.int32)
    for la in range(num_digit_limbs):
        for lb in range(8):
            s = la + lb
            if s >= 8:
                continue
            contrib = jnp.einsum(
                "brn,rcnt->bct", dl[..., la], mats[:, :, lb],
                preferred_element_type=jnp.int32,
            )
            planes = planes.at[:, :, s, :].add(contrib)
    return planes


def _external_product_accumulate(acc: U64, diff: U64, bsk_j: jnp.ndarray,
                                 p: CryptoParams) -> U64:
    """acc += GGSW_j (x) diff.   diff: U64 [B, k+1, N]; bsk_j int8
    [R, k+1, 8, 2N] (doubled limb planes)."""
    dl = _digit_limbs(diff, p)
    planes = _ext_planes_einsum(dl, bsk_j, p)
    ext = recombine_planes(jnp.moveaxis(planes, 2, -1))  # U64 [B, k+1, N]
    return torus.add(acc, ext)


def blind_rotate(acc: U64, lwe_2n: jnp.ndarray, keys: DeviceServerKeys,
                 use_ntt: bool = False) -> U64:
    """acc: U64 [B, k+1, N]; lwe_2n: int32 [B, n+1]. Sequential over the n
    LWE coefficients (the inherently serial axis); throughput comes from B.

    use_ntt selects the CRT-NTT external product (needs keys.bsk_ntt);
    otherwise the Hankel einsum over keys.bsk_limbs. Both are exact and
    bit-identical to numpy_ref.blind_rotate."""
    p = keys.params
    N = p.polynomial_size
    rotate = _negacyclic_rotate_shear if use_ntt else _negacyclic_rotate

    # Initial rotation by -b (the LWE body); pbs_batch pre-rotates the test
    # polynomial and passes b = 0, making this a no-op there.
    b = lwe_2n[:, -1]
    acc = rotate(acc, (2 * N - b) & (2 * N - 1), N)

    def step_ntt(j, acc):
        """CRT-NTT external product (O(N log N)-class; crypto/ntt.py)."""
        a_j = jax.lax.dynamic_slice_in_dim(lwe_2n, j, 1, axis=1)[:, 0]
        khat_j = jax.lax.dynamic_slice_in_dim(keys.bsk_ntt, j, 1, axis=0)[0]
        rotated = rotate(acc, a_j, N)
        diff = torus.sub(rotated, acc)
        dl = _digit_limbs(diff, p)                       # [B, R, N, La]
        planes = _ext_planes_ntt(dl, khat_j, p)
        ext = recombine_planes(jnp.moveaxis(planes, 2, -1))
        return torus.add(acc, ext)

    def step(j, acc):
        a_j = jax.lax.dynamic_slice_in_dim(lwe_2n, j, 1, axis=1)[:, 0]
        bsk_j = jax.lax.dynamic_slice_in_dim(keys.bsk_limbs, j, 1, axis=0)[0]
        rotated = rotate(acc, a_j, N)
        diff = torus.sub(rotated, acc)
        return _external_product_accumulate(acc, diff, bsk_j, p)

    if use_ntt:
        if keys.bsk_ntt is None:
            raise ValueError("the CRT-NTT path needs keys packed with "
                             "pack_server_keys(with_ntt=True)")
        return jax.lax.fori_loop(0, p.lwe_dimension, step_ntt, acc)
    return jax.lax.fori_loop(0, p.lwe_dimension, step, acc)


# ---------------------------------------------------------------------------
# Sample extraction
# ---------------------------------------------------------------------------

def sample_extract(acc: U64, p: CryptoParams) -> U64:
    """U64 [B, k+1, N] -> LWE U64 [B, kN+1] (coefficient 0)."""
    k, N = p.glwe_dimension, p.polynomial_size

    def extract_plane(plane):  # [B, k+1, N] uint32 -> [B, kN+1] pieces
        mask = plane[:, :k, :]
        first = mask[:, :, :1]
        rest = jnp.flip(mask[:, :, 1:], axis=-1)
        return first, rest, plane[:, k, 0]

    lo_f, lo_r, lo_b = extract_plane(acc.lo)
    hi_f, hi_r, hi_b = extract_plane(acc.hi)
    rest = torus.neg(U64(lo_r, hi_r))
    a = torus.concatenate([U64(lo_f, hi_f), rest], axis=-1)  # [B, k, N]
    a = torus.reshape(a, (a.lo.shape[0], k * N))
    b = U64(lo_b[:, None], hi_b[:, None])
    return torus.concatenate([a, b], axis=-1)


# ---------------------------------------------------------------------------
# Full PBS
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("use_ntt",))
def pbs_batch(ct: U64, lut_idx: jnp.ndarray, lut_bank: U64,
              keys: DeviceServerKeys, use_ntt: bool = False) -> U64:
    """Apply per-item LUTs to a batch of big-key LWE ciphertexts.

    ct: U64 [B, kN+1]; lut_idx: int32 [B] into lut_bank U64 [L, 2N].
    Returns U64 [B, kN+1] encrypting table[m] with fresh PBS noise.
    """
    p = keys.params
    N = p.polynomial_size
    B = ct.lo.shape[0]

    small = keyswitch(ct, keys)
    lwe_2n = modswitch(small, p)

    # Init accumulator: body = testpoly * X^{-b}; masks start at zero.
    b = lwe_2n[:, -1]
    sel = U64(lut_bank.lo[lut_idx], lut_bank.hi[lut_idx])  # [B, 2N]
    if use_ntt:
        # gather-free: rotate the N-coefficient poly by (2N - b) via shear
        poly = U64(sel.lo[:, None, :N], sel.hi[:, None, :N])  # [B, 1, N]
        body = _negacyclic_rotate_shear(poly, (2 * N - b) & (2 * N - 1), N)
        body = U64(body.lo[:, 0], body.hi[:, 0])
    else:
        t = jnp.arange(N, dtype=jnp.int32)
        idx = (t[None, :] + b[:, None]) & (2 * N - 1)  # [B, N]
        body = torus.gather_last(sel, idx)  # [B, N]
    zeros_mask = torus.zeros((B, p.glwe_dimension, N))
    acc = torus.concatenate(
        [zeros_mask, torus.reshape(body, (B, 1, N))], axis=1
    )

    lwe_nob = jnp.concatenate([lwe_2n[:, :-1], jnp.zeros((B, 1), jnp.int32)], axis=1)
    acc = blind_rotate(acc, lwe_nob, keys, use_ntt=use_ntt)
    return sample_extract(acc, p)
