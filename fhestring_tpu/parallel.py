"""Multi-chip execution: shard the PBS batch / character lanes over a mesh.

The reference is single-process, single-node (rayon threads only —
SURVEY.md section 2.4); parallel scale-out is new design territory here.
Two shardings are implemented:

1. **Batch sharding** (pbs_batch_sharded): the PBS batch axis (string
   positions x radix blocks x concurrent ops) is pure data parallelism;
   evaluation keys replicated (48 MB BSK + 61 MB KSK per chip at prod
   params). Aggregate bits (contains' OR-tree, len's popcount, eq's
   AND-tree) reduce across devices via GSPMD collectives. Zero
   communication inside a PBS — this is the default and wins whenever the
   keys fit in HBM.

2. **Key sharding / tensor parallelism** (pbs_batch_keysharded): the BSK is
   sharded over the GLWE output axis (k+1) and the KSK over its contraction
   rows, so per-chip key memory drops by the mesh size. The cost is one
   all_gather of the external-product delta ([B, (k+1)/d, N] u64) per
   blind-rotation step plus one psum in the keyswitch. When it wins: when
   key material doesn't fit per-device memory — multi-tenant serving holding
   MANY clients' bootstrap keys resident, or large-N / multi-level
   parameter sets (BSK is O(n*ell*(k+1)^2*N); doubling N at ell=2 already
   exceeds 380 MB/key). For the single-key prod set, batch sharding is
   strictly faster — the per-step all_gather (~(k+1)*N*8B per item) is pure
   overhead. SURVEY.md section 2.4 item 3 / section 7 step 8.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .crypto.pbs import _split2

BATCH_AXIS = "data"
INT32_SAFE = (1 << 31) - 1


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (BATCH_AXIS,))


def shard_string(mesh: Mesh, blocks):
    """Place an FheString block tensor with its position axis sharded over
    the mesh (sequence/lane parallelism)."""
    spec = NamedSharding(mesh, P(BATCH_AXIS))
    return jax.tree.map(lambda x: jax.device_put(x, spec), blocks)


def replicate(mesh: Mesh, tree):
    spec = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, spec), tree)


def pbs_batch_sharded(ct, lut_idx, lut_bank, keys, mesh: Mesh):
    """Batched PBS with the batch axis sharded over the mesh.

    Explicit shard_map (not GSPMD auto-sharding): each device runs the full
    blind-rotation loop on its lane slice with evaluation keys + LUT bank
    replicated, on the path ``bootstrap_path`` picks for the platform.
    There is no cross-device communication inside a PBS — the collectives
    appear only in the aggregate reductions the string engine runs on the
    PBS outputs (contains' OR-tree, len's popcount, ...), which GSPMD lowers
    to psum.

    ct: U64 [B, kN+1] with B divisible by the mesh size.
    """
    from .crypto.pbs import bootstrap_path, pbs_batch

    spec_b = P(BATCH_AXIS)
    spec_r = P()
    use_ntt = bootstrap_path(keys.params, mesh.devices.flat[0].platform).use_ntt

    fn = shard_map(
        partial(pbs_batch, use_ntt=use_ntt),
        mesh=mesh,
        in_specs=(
            jax.tree.map(lambda _: spec_b, ct),
            spec_b,
            jax.tree.map(lambda _: spec_r, lut_bank),
            jax.tree.map(lambda _: spec_r, keys),
        ),
        out_specs=jax.tree.map(lambda _: spec_b, ct),
        check_vma=False,
    )
    return fn(ct, lut_idx, lut_bank, keys)


# ---------------------------------------------------------------------------
# Polynomial-axis-sharded NTT (butterfly-stage all-to-all; SURVEY 2.4 item 3)
# ---------------------------------------------------------------------------

def _modc_f(v, bound: int, p: int):
    """One-multiply approximate Barrett reduction: v' == v (mod p) with
    |v'| <= ~0.51*p, computed as v - round(fl(v)*fl(1/p))*p in exact int32.

    The f32 quotient may be off by eps <= (bound/p)*2^-22 + 2^-22; that only
    widens the output bound (p*(0.5+eps)), never breaks the residue.
    Returns (v', new_bound)."""
    assert bound <= INT32_SAFE - 3 * p, bound
    q = jnp.round(v.astype(jnp.float32) * np.float32(1.0 / p)).astype(jnp.int32)
    out = v - q * np.int32(p)
    qerr = (bound / p) * 2.0 ** -22 + 2.0 ** -22
    return out, int(p * (0.5 + qerr)) + 2


def _modc(v, bound: int, p: int):
    """Exact centered reduction mod p of |v| <= bound: |out| <= (p-1)/2."""
    v, nb = _modc_f(v, bound, p)
    if nb > (p - 1) // 2:
        half = np.int32((p - 1) // 2)
        v = v - jnp.where(v > half, np.int32(p), 0)
        v = v + jnp.where(v < -half, np.int32(p), 0)
    return v


def _horner4(p00, p01, p10, p11, p: int):
    """Recombine 4 limb-pair dot planes (each |.| <= 2^21) exactly mod p:
    p00 + 256*(p01 + p10) + 65536*p11, centered."""
    t, tb = _modc_f(p01 + p10 + (p11 << 8), (1 << 22) + (1 << 29), p)
    v = p00 + (t << 8)
    return _modc(v, (1 << 21) + 256 * tb, p)


POLY_AXIS = "poly"


def make_poly_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (POLY_AXIS,))


def ntt_fwd_poly_sharded(x, n_poly: int, prime: int, mesh: Mesh):
    """One forward negacyclic NTT with the POLYNOMIAL axis sharded across
    the mesh — the four-step transform as distributed butterflies:

        stage 1 (block contraction over j2, twist+twiddle folded) is LOCAL
        on each device's j1 shard; an all_to_all reswizzles the sharded
        axis from j1 to k2; stage 2 (dense contraction over the now-local
        full j1) is LOCAL on each device's k2 shard.

    Bit-identical to ntt2.neg_fwd(x, make_neg_plan(prime, n_poly))
    (tests/test_parallel.py). All modular arithmetic is exact: int8-limb
    contractions with int32 accumulation + a fold/Barrett reduction
    (_modc).

    When it wins: batch sharding (pbs_batch_sharded) is communication-free
    and preferred whenever each chip holds >= 1 batch item per step; this
    path exists for transforms too LARGE for one device (e.g.
    multi-megabyte CRT-RNS ciphertexts), where the polynomial axis itself
    must span devices and the inter-stage all_to_all crosses the device
    interconnect. The reference's concrete-fft has no multi-node
    analog (single process; SURVEY.md section 2.4).

    x: int32 [..., N] centered digits (|x| <= 127, e.g. gadget digits);
    returns centered int32 hats [..., N] (h = k2*n1 + k1), replicated
    output gathered from the k2 shards.
    """
    from .crypto import ntt2

    plan = ntt2.make_neg_plan(prime, n_poly)
    n1, n2 = plan.n1, plan.n2
    nd = mesh.devices.size
    assert n1 % nd == 0, (n1, nd)

    # stage constants as int8 limb pairs (host, once per (prime, N))
    def limbs(m):
        m = np.asarray(m, np.int64)
        l0 = ((m + 128) % 256) - 128
        l1 = (m - l0) // 256
        return (jnp.asarray(l0, jnp.int8), jnp.asarray(l1, jnp.int8))

    mf0, mf1 = limbs(plan.mf)          # [n1(j1), n2(j2), n2(k2)]
    w10, w11 = limbs(plan.w1[0])       # [n1(j1), n1(k1)]

    def inside(xl, mf0l, mf1l):
        # xl [..., n2(j2), n1_loc(j1)] — local j1 shard
        xs = jnp.swapaxes(xl, -1, -2).astype(jnp.int8)   # [.., j1_loc, j2]
        # stage 1 (local): S[j1, k2] = sum_j2 x[j1, j2] mf[j1][j2, k2]
        s = (jnp.einsum("...ij,ijk->...ik", xs, mf0l,
                        preferred_element_type=jnp.int32)
             + (jnp.einsum("...ij,ijk->...ik", xs, mf1l,
                           preferred_element_type=jnp.int32) << 8))
        s = _modc(s, (127 * 128 * n2) * 257, prime)      # centered exact
        # butterfly-stage all_to_all: reshard j1 -> k2
        # local [.., j1_loc, n2(k2)] -> [.., n1(j1), n2_loc(k2)]
        s = jax.lax.all_to_all(s, POLY_AXIS, split_axis=s.ndim - 1,
                               concat_axis=s.ndim - 2, tiled=True)
        # stage 2 (local): out[k2_loc, k1] = sum_j1 S[j1, k2_loc] W1[j1, k1]
        st = jnp.swapaxes(s, -1, -2)                     # [.., k2_loc, j1]
        z0, z1 = _split2(st)
        d8 = partial(jnp.einsum, "...kj,jK->...kK",
                     preferred_element_type=jnp.int32)
        out = _horner4(d8(z0, w10), d8(z0, w11), d8(z1, w10),
                          d8(z1, w11), prime)
        return out                                        # [.., k2_loc, n1]

    x2 = x.reshape(x.shape[:-1] + (n2, n1))
    spec_x = P(*([None] * (x2.ndim - 1) + [POLY_AXIS]))   # shard j1
    out = shard_map(
        inside, mesh=mesh,
        in_specs=(spec_x, P(POLY_AXIS, None, None), P(POLY_AXIS, None, None)),
        out_specs=P(*([None] * (x2.ndim - 2) + [POLY_AXIS, None])),
        check_vma=False,
    )(x2, mf0, mf1)
    return out.reshape(x.shape[:-1] + (n_poly,))


def ntt_inv_poly_sharded(ahat, n_poly: int, prime: int, mesh: Mesh,
                         g: int = 0):
    """Inverse negacyclic NTT with the POLYNOMIAL axis sharded — the mirror
    of ntt_fwd_poly_sharded, completing the distributed four-step pair:

        stage A (dense contraction over k1, W1i) is LOCAL on each device's
        k2 shard — exactly the shard layout ntt_fwd_poly_sharded's output
        arrives in, so a fwd -> pointwise -> inv pipeline reshards only at
        the two butterfly boundaries; an all_to_all reswizzles the sharded
        axis from k2 to j1; stage B (block contraction over k2 with
        untwist + 1/N + 256^{-3g} folded, Mi[j1]) is LOCAL on each
        device's j1 shard.

    Bit-identical to ntt2.neg_inv(ahat, make_neg_plan(prime, n_poly), g)
    (tests/test_parallel.py). ahat: centered int32 [..., N] twisted hats
    (flat h = k2*n1 + k1); returns centered int32 coefficients [..., N].
    """
    from .crypto import ntt2

    plan = ntt2.make_neg_plan(prime, n_poly)
    n1, n2 = plan.n1, plan.n2
    nd = mesh.devices.size
    assert n2 % nd == 0 and n1 % nd == 0, (n1, n2, nd)

    def limbs(m):
        m = np.asarray(m, np.int64)
        l0 = ((m + 128) % 256) - 128
        l1 = (m - l0) // 256
        return (jnp.asarray(l0, jnp.int8), jnp.asarray(l1, jnp.int8))

    w1i0, w1i1 = limbs(plan.w1i.T)      # [n1(k1), n1(j1)]
    mi0, mi1 = limbs(plan.mi[g])        # [n1(j1), n2(k2), n2(j2)]

    def inside(cl, mi0l, mi1l):
        # cl [..., k2_loc, n1(k1)] — local k2 shard (fwd-output layout)
        # stage A (local, dense): q[k2, j1] = sum_k1 c[k2, k1] W1i[k1, j1]
        z0, z1 = _split2(cl)
        d8 = partial(jnp.einsum, "...kj,jK->...kK",
                     preferred_element_type=jnp.int32)
        q = _horner4(d8(z0, w1i0), d8(z0, w1i1), d8(z1, w1i0),
                        d8(z1, w1i1), prime)
        # butterfly-stage all_to_all: reshard k2 -> j1
        # local [.., k2_loc, n1(j1)] -> [.., n2(k2), n1_loc(j1)]
        q = jax.lax.all_to_all(q, POLY_AXIS, split_axis=q.ndim - 1,
                               concat_axis=q.ndim - 2, tiled=True)
        qt = jnp.swapaxes(q, -1, -2)     # [.., j1_loc, n2(k2)]
        # stage B (local, per-j1 block): out[j1, j2] = sum_k2 qt[j1, k2]
        #                                             Mi[j1][k2, j2]
        z0, z1 = _split2(qt)
        e8 = partial(jnp.einsum, "...ij,ijk->...ik",
                     preferred_element_type=jnp.int32)
        out = _horner4(e8(z0, mi0l), e8(z0, mi1l), e8(z1, mi0l),
                          e8(z1, mi1l), prime)
        return out                       # [.., j1_loc, n2(j2)]

    c = ahat.reshape(ahat.shape[:-1] + (n2, n1))
    spec_in = P(*([None] * (c.ndim - 2) + [POLY_AXIS, None]))
    out = shard_map(
        inside, mesh=mesh,
        in_specs=(spec_in, P(POLY_AXIS, None, None), P(POLY_AXIS, None, None)),
        out_specs=P(*([None] * (c.ndim - 2) + [POLY_AXIS, None])),
        check_vma=False,
    )(c, mi0, mi1)
    # [.., j1, j2] -> natural coefficient order t = j1 + n1*j2
    out = jnp.swapaxes(out, -1, -2)
    return out.reshape(ahat.shape[:-1] + (n_poly,))


def ext_group_poly_sharded(digits, khat_prime, n_poly: int, prime: int,
                           mesh: Mesh, g: int = 0):
    """One external-product plane group mod one prime with the POLYNOMIAL
    axis sharded end-to-end — the butterfly transforms WIRED INTO the
    external product (SURVEY 2.4 item 3):

        forward butterflies (one all_to_all per row transform; this
        prototype invokes the forward shard_map once per decomposition
        row — a production kernel would stack the rows into a single
        call) -> per-frequency pointwise multiply-accumulate over the
        decomposition rows (LOCAL on the k2 shards: the hats of every row
        live on the same frequency shard, so the contraction over rows
        needs NO communication) -> inverse butterflies (one all_to_all).

    The remaining external-product steps (CRT across primes, 256^{3g}
    shift-plane recombine, accumulator add — see ntt2.ext_u64_ntt2_numpy) are
    ELEMENTWISE in the coefficient domain and therefore shard-local by
    construction; this function is the complete communicating core.

    digits: int32 [R, ..., N] centered gadget digits (|.| <= 127), one per
        decomposition row; khat_prime: centered int [R, ..., N] NTT-domain
        key hats mod `prime` for the same rows (ntt2.key_hats layout).
    Returns centered int32 [..., N]: coefficients of
        sigma_g * sum_i digits_i (x) key_i, bit-identical to the numpy
        composition neg_inv(sum_i center(neg_fwd(d_i) * khat_i)).
    """
    from .crypto import ntt2

    R = digits.shape[0]
    half = (prime - 1) // 2
    acc, bound = None, 0
    for i in range(R):
        hat = ntt_fwd_poly_sharded(digits[i], n_poly, prime, mesh)
        kh = jnp.asarray(khat_prime[i], jnp.int32)
        term = _modc(hat * kh, half * half, prime)  # |h*k| <= p^2/4 < 2^31
        if acc is None:
            acc, bound = term, half
        else:
            acc, bound = acc + term, bound + half
            if bound + half > (1 << 30):
                acc, bound = _modc(acc, bound, prime), half
    acc = _modc(acc, bound, prime)
    return ntt_inv_poly_sharded(acc, n_poly, prime, mesh, g=g)


# ---------------------------------------------------------------------------
# Key-sharded PBS (tensor parallelism over the key axes)
# ---------------------------------------------------------------------------

KEY_AXIS = "key"


def make_key_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (KEY_AXIS,))


def pbs_batch_keysharded(ct, lut_idx, lut_bank, keys, mesh: Mesh):
    """Batched PBS with the EVALUATION KEYS sharded across the mesh.

    BSK sharded over the GLWE output axis (k+1): each chip computes its
    output-poly slice of every external product and all_gathers the delta
    before the accumulator update (the next step's rotation/decomposition
    needs the full accumulator). KSK sharded over contraction rows with a
    psum. Bit-identical to pbs_batch (tests/test_parallel.py).

    Requires (k+1) % mesh_size == 0 and (kN * ks_level) % mesh_size == 0.
    See the module docstring for when this beats batch sharding.
    """
    from . import torus
    from .crypto import pbs as dpbs
    from .torus import U64

    p = keys.params
    nd = mesh.devices.size
    kp1 = p.glwe_dimension + 1
    K = p.big_lwe_dimension * p.ks_level
    assert kp1 % nd == 0, (kp1, nd)
    assert K % nd == 0, (K, nd)
    N = p.polynomial_size

    def inside(ct, lut_idx, bank, bsk_shard, ksk_shard):
        me = jax.lax.axis_index(KEY_AXIS)
        B = ct.lo.shape[0]

        # -- keyswitch with row-sharded KSK + psum -------------------------
        kn = p.big_lwe_dimension
        a = U64(ct.lo[:, :kn], ct.hi[:, :kn])
        b = U64(ct.lo[:, kn], ct.hi[:, kn])
        digits = dpbs.decompose(a, p.ks_base_log, p.ks_level)
        d = jax.numpy.transpose(digits, (1, 2, 0)).astype(jax.numpy.int8)
        d = d.reshape(d.shape[0], K)
        kloc = K // nd
        d_local = jax.lax.dynamic_slice_in_dim(d, me * kloc, kloc, axis=1)
        planes = jax.lax.dot(d_local, ksk_shard,
                             preferred_element_type=jax.numpy.int32)
        planes = jax.lax.psum(planes, KEY_AXIS)
        planes = planes.reshape(B, p.lwe_dimension + 1, 8)
        acc_ks = dpbs.recombine_planes(planes)
        out = torus.neg(acc_ks)
        out_lo = out.lo.at[:, -1].add(b.lo)
        carry = (out_lo[:, -1] < out.lo[:, -1]).astype(jax.numpy.uint32)
        out_hi = out.hi.at[:, -1].add(b.hi + carry)
        small = U64(out_lo, out_hi)

        lwe_2n = dpbs.modswitch(small, p)
        bb = lwe_2n[:, -1]
        sel = U64(bank.lo[lut_idx], bank.hi[lut_idx])
        poly = U64(sel.lo[:, None, :N], sel.hi[:, None, :N])
        body = dpbs._negacyclic_rotate_shear(
            poly, (2 * N - bb) & (2 * N - 1), N)
        body = U64(body.lo[:, 0], body.hi[:, 0])
        acc = torus.concatenate(
            [torus.zeros((B, p.glwe_dimension, N)),
             torus.reshape(body, (B, 1, N))], axis=1)

        # -- blind rotation: local ext-product slice + all_gather ----------
        def step(j, acc):
            a_j = jax.lax.dynamic_slice_in_dim(lwe_2n, j, 1, axis=1)[:, 0]
            bsk_j = jax.lax.dynamic_slice_in_dim(bsk_shard, j, 1, axis=0)[0]
            rotated = dpbs._negacyclic_rotate_shear(acc, a_j, N)
            diff = torus.sub(rotated, acc)
            dl = dpbs._digit_limbs(diff, p)
            planes = dpbs._ext_planes_einsum(dl, bsk_j, p)  # [B, kp1/nd,...]
            ext = dpbs.recombine_planes(
                jax.numpy.moveaxis(planes, 2, -1))
            full = U64(
                jax.lax.all_gather(ext.lo, KEY_AXIS, axis=1, tiled=True),
                jax.lax.all_gather(ext.hi, KEY_AXIS, axis=1, tiled=True))
            return torus.add(acc, full)

        acc = jax.lax.fori_loop(0, p.lwe_dimension, step, acc)
        return dpbs.sample_extract(acc, p)

    spec_r = P()
    fn = shard_map(
        inside,
        mesh=mesh,
        in_specs=(
            jax.tree.map(lambda _: spec_r, ct),
            spec_r,
            jax.tree.map(lambda _: spec_r, lut_bank),
            P(None, None, KEY_AXIS),   # bsk_limbs [n, R, k+1, 8, 2N]
            P(KEY_AXIS),               # ksk_limbs [K, (n+1)*8]
        ),
        out_specs=jax.tree.map(lambda _: spec_r, ct),
        check_vma=False,
    )
    return fn(ct, lut_idx, lut_bank, keys.bsk_limbs, keys.ksk_limbs)
