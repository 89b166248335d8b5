"""Shortint layer: 2-bit-message blocks with LUT-based evaluation.

Mirrors the role of tfhe-rs's shortint module for the
``PARAM_MESSAGE_2_CARRY_2`` encoding the reference relies on
(message_modulus=4, carry_modulus=4, reference src/main.rs:3,22-23): each
block holds a value in [0, 16) (2 message bits + 2 carry bits + padding bit),
linear operations are free (noise-additive), and any function on packed
values in [0, 16) costs one programmable bootstrap.

The container tracks ``degree`` (max possible plaintext value) and
``noise_var`` (variance in fresh-PBS units) statically, so packing safety
(degree <= 15, noise within budget) is asserted at trace time — the same
bookkeeping tfhe-rs does dynamically.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from . import torus
from .crypto.keys import DeviceServerKeys, pack_luts
from .crypto.pbs import bootstrap_path, pbs_batch
from .params import CryptoParams
from .torus import U64

# Packing/noise budget: a fresh PBS output has variance 1 unit; tfhe-rs 2_2
# parameters are dimensioned for the 4x+y pack (16 + 1 = 17 units).
#
# The budget is PER PARAMETER SET (params.CryptoParams.noise_budget): turbo
# carries a calibrated budget (192 units, derived in params.py from
# benchmarks/noise_calibration.py); other sets keep the conservative default
# below.  At PARAM_TEST_STAT (prod-relative LWE noise, CI dims, 4096
# bootstraps) the worst designed pack measures 17.36 fresh-PBS units vs the
# theoretical 17 — the unit bookkeeping matches measurement within 2%.
MAX_NOISE_VAR = 34.0  # default for sets without a calibrated noise_budget
MAX_DEGREE = 15

# Widest PBS batch run at once.  Wider batches (e.g. whole split grids
# compacted at once) run in chunks of this size: it bounds peak device
# memory (the rotation holds the [B, k+1, N] u64 accumulator plus the
# per-step external-product planes) and keeps the compiled shapes few.
MAX_PBS_CHUNK = 4096


def padded_width(n: int) -> int:
    """Compiled batch width for a chunk of n <= MAX_PBS_CHUNK items: the
    next power of two, at least 8.  Powers of two keep the set of compiled
    shapes small and the width a multiple of any power-of-two mesh, which
    _shard_batch_hint relies on."""
    return max(8, 1 << (n - 1).bit_length())


def _shard_batch_hint(flat: U64) -> U64:
    """Pin the padded PBS batch to data sharding when tracing under a mesh.

    The engine's grids have odd sizes (e.g. (len+1)^2 split buffers), so
    after flattening GSPMD often cannot propagate the lane sharding and
    replicates the widest PBS batches — the dominant cost under a mesh.
    The padded width is a power of two (padded_width), so under a
    power-of-two mesh the constraint is legal; outside a mesh, or when the
    width does not divide, this is a no-op."""
    from .parallel import BATCH_AXIS

    mesh = jax.sharding.get_abstract_mesh()
    if mesh.empty or BATCH_AXIS not in mesh.axis_names:
        return flat
    if flat.lo.shape[0] % mesh.shape[BATCH_AXIS]:
        return flat
    spec = jax.sharding.PartitionSpec(
        BATCH_AXIS, *([None] * (flat.lo.ndim - 1)))
    wsc = jax.lax.with_sharding_constraint
    return U64(wsc(flat.lo, spec), wsc(flat.hi, spec))


@dataclasses.dataclass
class Blocks:
    """A tensor of shortint blocks: ct is U64 [..., kN+1]."""

    ct: U64
    degree: int
    noise_var: float

    @property
    def shape(self):
        return self.ct.lo.shape[:-1]


def _blocks_flatten(b: Blocks):
    return (b.ct,), (b.degree, b.noise_var)


def _blocks_unflatten(aux, children):
    return Blocks(children[0], aux[0], aux[1])


jax.tree_util.register_pytree_node(Blocks, _blocks_flatten, _blocks_unflatten)


class ShortintContext:
    """Server-side evaluator: owns device keys and a LUT cache."""

    def __init__(self, keys: DeviceServerKeys):
        self.keys = keys
        self.params: CryptoParams = keys.params
        self.path = bootstrap_path(keys.params)
        # Per-set linear-noise budget (fresh-PBS variance units); see
        # params.CryptoParams.noise_budget for the derivation.
        self.max_noise_var: float = getattr(
            keys.params, "noise_budget", MAX_NOISE_VAR)
        self._lut_cache: dict[tuple, torus.U64] = {}

    # -- constructors -------------------------------------------------------
    def trivial(self, values) -> Blocks:
        """Noiseless server-side constants (tfhe create_trivial_radix analog,
        reference src/ciphertext/fheasciichar.rs:17-25)."""
        p = self.params
        values = np.asarray(values, dtype=np.uint64)
        ct = np.zeros(values.shape + (p.big_lwe_dimension + 1,), dtype=np.uint64)
        ct[..., -1] = (values % np.uint64(p.full_space)) * np.uint64(p.delta)
        return Blocks(torus.from_numpy(ct), int(values.max()) if values.size else 0, 0.0)

    def from_numpy_cts(self, cts: np.ndarray, degree: int = 3) -> Blocks:
        return Blocks(torus.from_numpy(cts), degree, 1.0)

    # -- linear algebra (no PBS) --------------------------------------------
    def add(self, a: Blocks, b: Blocks) -> Blocks:
        assert a.degree + b.degree <= MAX_DEGREE, (a.degree, b.degree)
        return Blocks(torus.add(a.ct, b.ct), a.degree + b.degree,
                      a.noise_var + b.noise_var)

    def sub_from_scalar(self, scalar: int, a: Blocks) -> Blocks:
        """scalar - a, where a.degree <= scalar (e.g. bit flip 1 - x,
        reference src/ciphertext/fheasciichar.rs:161-168)."""
        assert a.degree <= scalar <= MAX_DEGREE
        enc = int(scalar) * self.params.delta
        out = torus.neg(a.ct)
        lo = out.lo.at[..., -1].add(jnp.uint32(enc & 0xFFFFFFFF))
        carry = (lo[..., -1] < out.lo[..., -1]).astype(jnp.uint32)
        hi = out.hi.at[..., -1].add(jnp.uint32(enc >> 32) + carry)
        return Blocks(U64(lo, hi), scalar, a.noise_var)

    def scalar_mul(self, a: Blocks, c: int) -> Blocks:
        assert a.degree * c <= MAX_DEGREE
        return Blocks(torus.mul_small(a.ct, c), a.degree * c,
                      a.noise_var * c * c)

    def add_scalar(self, a: Blocks, c: int) -> Blocks:
        assert a.degree + c <= MAX_DEGREE
        enc = int(c) * self.params.delta
        lo = a.ct.lo.at[..., -1].add(jnp.uint32(enc & 0xFFFFFFFF))
        carry = (lo[..., -1] < a.ct.lo[..., -1]).astype(jnp.uint32)
        hi = a.ct.hi.at[..., -1].add(jnp.uint32(enc >> 32) + carry)
        return Blocks(U64(lo, hi), a.degree + c, a.noise_var)

    def sum_many(self, blocks: list[Blocks]) -> Blocks:
        out = blocks[0]
        for b in blocks[1:]:
            out = self.add(out, b)
        return out

    def sum_axis(self, a: Blocks, axis: int, count: int, max_value: int) -> Blocks:
        """Sum along an axis of known length; caller guarantees the summed
        plaintext value never exceeds max_value <= 15."""
        assert max_value <= MAX_DEGREE
        # carry-correct limb sum over the chosen axis
        ax = axis if axis >= 0 else axis - 1  # account for trailing ct dim
        summed = torus.sum_axis(a.ct, ax)
        return Blocks(summed, max_value, a.noise_var * count)

    # -- LUT evaluation (PBS) -------------------------------------------------
    def _bank_for(self, tables: tuple[tuple[int, ...], ...]) -> torus.U64:
        key = tables
        if key not in self._lut_cache:
            # The cache outlives any single trace; build the bank under
            # compile-time eval so a first use inside a lax.scan body does
            # not stage the constant into (and leak it out of) that trace.
            with jax.ensure_compile_time_eval():
                self._lut_cache[key] = pack_luts(
                    [list(t) for t in tables], self.params)
        return self._lut_cache[key]

    def _pbs_padded(self, flat: torus.U64, idx: jnp.ndarray, bank: torus.U64):
        """Run pbs_batch in chunks of at most MAX_PBS_CHUNK items, each
        padded to padded_width, on the platform's bootstrap path."""
        from . import metrics

        n = flat.lo.shape[0]
        if n > MAX_PBS_CHUNK:
            outs = []
            for s in range(0, n, MAX_PBS_CHUNK):
                e = min(s + MAX_PBS_CHUNK, n)
                outs.append(self._pbs_padded(
                    U64(flat.lo[s:e], flat.hi[s:e]), idx[s:e], bank))
            return U64(jnp.concatenate([o.lo for o in outs]),
                       jnp.concatenate([o.hi for o in outs]))
        padded = padded_width(n)
        metrics.record_pbs(n, padded)
        if padded != n:
            pad = padded - n
            zlo = jnp.zeros((pad,) + flat.lo.shape[1:], jnp.uint32)
            flat = U64(jnp.concatenate([flat.lo, zlo]),
                       jnp.concatenate([flat.hi, zlo]))
            idx = jnp.concatenate([idx, jnp.zeros(pad, jnp.int32)])
        flat = _shard_batch_hint(flat)
        out = pbs_batch(flat, idx, bank, self.keys, use_ntt=self.path.use_ntt)
        if padded != n:
            out = U64(out.lo[:n], out.hi[:n])
        return out

    def apply_lut(self, a: Blocks, table) -> Blocks:
        """Univariate LUT via one batched PBS. table: 16 ints in [0, 16)."""
        table = tuple(int(v) % 16 for v in table)
        assert a.noise_var <= self.max_noise_var
        bank = self._bank_for((table,))
        shape = a.shape
        flat = torus.reshape(a.ct, (-1, a.ct.lo.shape[-1]))
        idx = jnp.zeros(flat.lo.shape[0], jnp.int32)
        out = self._pbs_padded(flat, idx, bank)
        out = torus.reshape(out, shape + (a.ct.lo.shape[-1],))
        return Blocks(out, max(table), 1.0)

    def apply_lut_multi(self, a: Blocks, tables, table_idx: jnp.ndarray) -> Blocks:
        """Per-element LUT selection: tables [L][16], table_idx int32 a.shape."""
        tables = tuple(tuple(int(v) % 16 for v in t) for t in tables)
        assert a.noise_var <= self.max_noise_var
        bank = self._bank_for(tables)
        shape = a.shape
        flat = torus.reshape(a.ct, (-1, a.ct.lo.shape[-1]))
        idx = table_idx.reshape(-1).astype(jnp.int32)
        out = self._pbs_padded(flat, idx, bank)
        out = torus.reshape(out, shape + (a.ct.lo.shape[-1],))
        return Blocks(out, max(max(t) for t in tables), 1.0)

    def apply_lut_bivariate(self, x: Blocks, y: Blocks, fn: Callable[[int, int], int]) -> Blocks:
        """LUT over a packed pair: out = fn(x, y) with x,y in [0, msg_mod)."""
        m = self.params.message_modulus
        assert x.degree < m and y.degree < m, (x.degree, y.degree)
        packed = self.add(self.scalar_mul(x, m), y)
        table = [fn(u // m, u % m) for u in range(self.params.plaintext_space)]
        return self.apply_lut(packed, table)

    def refresh(self, a: Blocks) -> Blocks:
        """Identity bootstrap (noise reset), degree preserved <= 3."""
        assert a.degree <= 3
        return self.apply_lut(a, list(range(4)) * 4)

    def maybe_refresh(self, a: Blocks, incoming_var: float) -> Blocks:
        if a.noise_var + incoming_var > self.max_noise_var:
            return self.refresh(a)
        return a
