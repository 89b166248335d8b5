"""64-bit torus arithmetic emulated on 2x uint32 limbs.

JAX runs 32-bit integers by default (64-bit types need jax_enable_x64), so
torus elements mod 2**64 are carried as (lo, hi) uint32 pairs.  All helpers
are shape-polymorphic and jit-friendly; they run identically on the CPU
(tests) and the GPU (production).

This module replaces the role of tfhe-rs's u64 torus arithmetic
(reference dependency; see SURVEY.md section 2.3).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class U64(NamedTuple):
    """A tensor of torus elements mod 2**64 as two uint32 limb planes."""

    lo: jnp.ndarray
    hi: jnp.ndarray

    @property
    def shape(self):
        return self.lo.shape


def from_numpy(arr: np.ndarray) -> U64:
    arr = arr.astype(np.uint64)
    return U64(
        jnp.asarray((arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray((arr >> np.uint64(32)).astype(np.uint32)),
    )


def to_numpy(v: U64) -> np.ndarray:
    lo = np.asarray(v.lo).astype(np.uint64)
    hi = np.asarray(v.hi).astype(np.uint64)
    return lo | (hi << np.uint64(32))


def zeros(shape) -> U64:
    return U64(jnp.zeros(shape, jnp.uint32), jnp.zeros(shape, jnp.uint32))


def full(shape, value: int) -> U64:
    value = int(value) % (1 << 64)
    return U64(
        jnp.full(shape, value & 0xFFFFFFFF, jnp.uint32),
        jnp.full(shape, value >> 32, jnp.uint32),
    )


def add(a: U64, b: U64) -> U64:
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(jnp.uint32)
    return U64(lo, a.hi + b.hi + carry)


def sub(a: U64, b: U64) -> U64:
    lo = a.lo - b.lo
    borrow = (a.lo < b.lo).astype(jnp.uint32)
    return U64(lo, a.hi - b.hi - borrow)


def neg(a: U64) -> U64:
    return sub(zeros(a.lo.shape), a)


def add_scalar(a: U64, value: int) -> U64:
    value = int(value) % (1 << 64)
    b = U64(
        jnp.uint32(value & 0xFFFFFFFF) + jnp.zeros_like(a.lo),
        jnp.uint32(value >> 32) + jnp.zeros_like(a.hi),
    )
    return add(a, b)


def _mul_u32(a: jnp.ndarray, b: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full 32x32 -> 64 product of uint32 tensors, as (lo, hi) uint32."""
    a0 = a & jnp.uint32(0xFFFF)
    a1 = a >> jnp.uint32(16)
    b0 = b & jnp.uint32(0xFFFF)
    b1 = b >> jnp.uint32(16)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> jnp.uint32(16)) + (p01 & jnp.uint32(0xFFFF)) + (p10 & jnp.uint32(0xFFFF))
    lo = (p00 & jnp.uint32(0xFFFF)) | (mid << jnp.uint32(16))
    hi = p11 + (p01 >> jnp.uint32(16)) + (p10 >> jnp.uint32(16)) + (mid >> jnp.uint32(16))
    return lo, hi


def mul_u32(a: U64, b: jnp.ndarray) -> U64:
    """Multiply torus elements by unsigned 32-bit integers (mod 2**64)."""
    b = b.astype(jnp.uint32)
    lo, carry = _mul_u32(a.lo, b)
    hi = a.hi * b + carry
    return U64(lo, hi)


def mul_small(a: U64, c: int) -> U64:
    """Multiply by a small plaintext-side constant (used for LUT packing)."""
    if c == 0:
        return zeros(a.lo.shape)
    if c == 1:
        return a
    return mul_u32(a, jnp.full(a.lo.shape, c, jnp.uint32))


def shl(a: U64, k: int) -> U64:
    """Left shift by a static amount."""
    if k == 0:
        return a
    if k >= 64:
        return zeros(a.lo.shape)
    if k >= 32:
        return U64(jnp.zeros_like(a.lo), a.lo << jnp.uint32(k - 32))
    return U64(
        a.lo << jnp.uint32(k),
        (a.hi << jnp.uint32(k)) | (a.lo >> jnp.uint32(32 - k)),
    )


def shr(a: U64, k: int) -> U64:
    """Logical right shift by a static amount."""
    if k == 0:
        return a
    if k >= 64:
        return zeros(a.lo.shape)
    if k >= 32:
        return U64(a.hi >> jnp.uint32(k - 32), jnp.zeros_like(a.hi))
    return U64(
        (a.lo >> jnp.uint32(k)) | (a.hi << jnp.uint32(32 - k)),
        a.hi >> jnp.uint32(k),
    )


def from_int32(v: jnp.ndarray) -> U64:
    """Sign-extend int32 values to torus elements (two's complement)."""
    lo = v.astype(jnp.uint32)
    hi = (v >> 31).astype(jnp.uint32)  # arithmetic shift: 0 or 0xFFFFFFFF
    return U64(lo, hi)


def round_shr(a: U64, k: int) -> U64:
    """Rounded right shift: floor((a + 2**(k-1)) / 2**k) mod 2**64."""
    assert k >= 1
    half = add_scalar(a, 1 << (k - 1))
    return shr(half, k)


def gather_last(a: U64, idx: jnp.ndarray) -> U64:
    """take_along_axis over the last axis, applied to both limb planes."""
    return U64(
        jnp.take_along_axis(a.lo, idx, axis=-1),
        jnp.take_along_axis(a.hi, idx, axis=-1),
    )


def where(cond: jnp.ndarray, a: U64, b: U64) -> U64:
    return U64(jnp.where(cond, a.lo, b.lo), jnp.where(cond, a.hi, b.hi))


def stack(vals, axis=0) -> U64:
    return U64(
        jnp.stack([v.lo for v in vals], axis=axis),
        jnp.stack([v.hi for v in vals], axis=axis),
    )


def concatenate(vals, axis=0) -> U64:
    return U64(
        jnp.concatenate([v.lo for v in vals], axis=axis),
        jnp.concatenate([v.hi for v in vals], axis=axis),
    )


def reshape(a: U64, shape) -> U64:
    return U64(a.lo.reshape(shape), a.hi.reshape(shape))


def sum_axis(a: U64, axis: int) -> U64:
    """Sum torus elements along an axis (mod 2**64), carry-correct.

    Carries are recovered by splitting lo into 16-bit halves so partial sums
    never overflow uint32 before the carry is accounted.
    """
    lo_low = (a.lo & jnp.uint32(0xFFFF)).astype(jnp.uint32)
    lo_high = (a.lo >> jnp.uint32(16)).astype(jnp.uint32)
    s_low = lo_low.sum(axis=axis, dtype=jnp.uint32)
    s_high = lo_high.sum(axis=axis, dtype=jnp.uint32)
    s_hi = a.hi.sum(axis=axis, dtype=jnp.uint32)
    lo = s_low + (s_high << jnp.uint32(16))
    carry = (s_high + (s_low >> jnp.uint32(16))) >> jnp.uint32(16)
    return U64(lo, s_hi + carry)
