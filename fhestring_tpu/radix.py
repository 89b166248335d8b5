"""Radix layer: 8-bit characters as 4x 2-bit shortint blocks.

Provides the exact op set the reference consumes from tfhe-rs
(eq/ne/lt/le/gt/ge, bitand/bitor, add/sub, if_then_else/cmux, trivial
encodings — reference src/ciphertext/fheasciichar.rs:35-104) plus fused
character predicates (is_whitespace/is_lowercase/is_uppercase, reference
fheasciichar.rs:106-158) that collapse the reference's chains of radix
comparisons into 3 bootstraps via nibble LUTs.

Conventions:
- A "Chars" value is a Blocks whose trailing axis is the 4 radix blocks,
  block 0 least significant (value = sum_b block_b * 4**b).
- A "Bits" value is a Blocks holding 0/1 (no block axis).
All ops are elementwise over the leading batch shape and lower to a small
constant number of batched PBS calls — the batch axis carries every string
position at once, which is what fills the device.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .shortint import Blocks, ShortintContext

NB = 4  # blocks per char
MSG = 4  # message modulus


def _sign_table():
    """LUT over 4x+y: 0 if x<y, 1 if x==y, 2 if x>y."""
    return [0 if (u >> 2) < (u & 3) else (1 if (u >> 2) == (u & 3) else 2)
            for u in range(16)]


def _combine_table(final_op=None):
    """LUT over 4a+b (a,b in {0,1,2}): a if a != 1 else b; optionally mapped
    through final_op on the combined state."""
    out = []
    for u in range(16):
        a, b = u >> 2, u & 3
        s = a if a != 1 else b
        out.append(final_op(s) if final_op else s)
    return out


class RadixContext:
    """Character-level homomorphic ops over a ShortintContext."""

    def __init__(self, sc: ShortintContext):
        self.sc = sc

    # ---- constructors / structure ---------------------------------------
    def trivial_chars(self, values) -> Blocks:
        values = np.asarray(values, dtype=np.uint64)
        blocks = np.stack(
            [(values >> np.uint64(2 * b)) & np.uint64(3) for b in range(NB)], axis=-1
        )
        return self.sc.trivial(blocks)

    def trivial_bits(self, values) -> Blocks:
        return self.sc.trivial(np.asarray(values, dtype=np.uint64) & np.uint64(1))

    def block(self, chars: Blocks, i: int) -> Blocks:
        ct = chars.ct
        return Blocks(type(ct)(ct.lo[..., i, :], ct.hi[..., i, :]),
                      min(chars.degree, 3), chars.noise_var)

    def from_blocks(self, blocks: list[Blocks]) -> Blocks:
        from . import torus
        ct = torus.stack([b.ct for b in blocks], axis=-2)
        return Blocks(ct, max(b.degree for b in blocks),
                      max(b.noise_var for b in blocks))

    def _nibbles(self, x: Blocks) -> tuple[Blocks, Blocks]:
        """(lo, hi) nibble values in [0,16): lo = 4*b1 + b0, hi = 4*b3 + b2.
        Linear only — no PBS."""
        sc = self.sc
        lo = sc.add(sc.scalar_mul(self.block(x, 1), MSG), self.block(x, 0))
        hi = sc.add(sc.scalar_mul(self.block(x, 3), MSG), self.block(x, 2))
        return lo, hi

    def _fresh(self, x: Blocks) -> Blocks:
        """Refresh chars if too noisy to enter a 4x+y pack."""
        sc = self.sc
        if x.noise_var * 16 + 2 > sc.max_noise_var or x.degree > 3:
            return sc.apply_lut(x, list(range(4)) * 4)
        return x

    # ---- equality ---------------------------------------------------------
    def eq(self, x: Blocks, y: Blocks) -> Blocks:
        """Charwise equality bit (reference fheasciichar.rs:35-38)."""
        sc = self.sc
        x, y = self._fresh(x), self._fresh(y)
        packed = sc.add(sc.scalar_mul(x, MSG), y)  # [.., NB]
        beq = sc.apply_lut(packed, [1 if (u >> 2) == (u & 3) else 0 for u in range(16)])
        total = sc.sum_axis(beq, axis=-1, count=NB, max_value=NB)
        return sc.apply_lut(total, [1 if v == NB else 0 for v in range(16)])

    def ne(self, x: Blocks, y: Blocks) -> Blocks:
        sc = self.sc
        x, y = self._fresh(x), self._fresh(y)
        packed = sc.add(sc.scalar_mul(x, MSG), y)
        beq = sc.apply_lut(packed, [1 if (u >> 2) == (u & 3) else 0 for u in range(16)])
        total = sc.sum_axis(beq, axis=-1, count=NB, max_value=NB)
        return sc.apply_lut(total, [0 if v == NB else 1 for v in range(16)])

    # ---- ordering ---------------------------------------------------------
    def _compare(self, x: Blocks, y: Blocks, final_op) -> Blocks:
        """Lexicographic-over-blocks comparison (MSB first)."""
        sc = self.sc
        x, y = self._fresh(x), self._fresh(y)
        packed = sc.add(sc.scalar_mul(x, MSG), y)
        s = sc.apply_lut(packed, _sign_table())  # [.., NB] in {0,1,2}
        s3, s2, s1, s0 = (self.block(s, i) for i in (3, 2, 1, 0))
        hi = sc.apply_lut(sc.add(sc.scalar_mul(s3, MSG), s2), _combine_table())
        lo = sc.apply_lut(sc.add(sc.scalar_mul(s1, MSG), s0), _combine_table())
        return sc.apply_lut(sc.add(sc.scalar_mul(hi, MSG), lo),
                            _combine_table(final_op))

    def lt(self, x, y):
        return self._compare(x, y, lambda s: 1 if s == 0 else 0)

    def le(self, x, y):
        return self._compare(x, y, lambda s: 1 if s != 2 else 0)

    def gt(self, x, y):
        return self._compare(x, y, lambda s: 1 if s == 2 else 0)

    def ge(self, x, y):
        return self._compare(x, y, lambda s: 1 if s != 0 else 0)

    # ---- boolean algebra on bits -------------------------------------------
    def and_(self, a: Blocks, b: Blocks) -> Blocks:
        sc = self.sc
        return sc.apply_lut(sc.add(a, b), [0, 0, 1, 0] + [0] * 12)

    def or_(self, a: Blocks, b: Blocks) -> Blocks:
        sc = self.sc
        return sc.apply_lut(sc.add(a, b), [0, 1, 1, 0] + [0] * 12)

    def not_(self, a: Blocks) -> Blocks:
        return self.sc.sub_from_scalar(1, a)

    def any_axis(self, bits: Blocks, axis: int) -> Blocks:
        """OR-reduce along an axis (replaces the reference's bitor chains)."""
        return self._reduce_bits(bits, axis, lambda v, g: 1 if v >= 1 else 0,
                                 pad_value=0)

    def all_axis(self, bits: Blocks, axis: int) -> Blocks:
        return self._reduce_bits(bits, axis, lambda v, g: 1 if v == g else 0,
                                 pad_value=1)

    def _reduce_bits(self, bits: Blocks, axis: int, table_fn, pad_value: int) -> Blocks:
        from . import torus
        sc = self.sc
        cur = bits
        if axis < 0:
            axis = len(cur.shape) + axis
        while cur.shape[axis] > 1:
            n = cur.shape[axis]
            g = min(n, 15, int(sc.max_noise_var // max(cur.noise_var, 1e-9)) or 1)
            g = max(g, 2)
            pad = (-n) % g
            ct = cur.ct
            if pad:
                zshape = list(ct.lo.shape)
                zshape[axis] = pad
                pv = np.full(zshape[:-1], pad_value, np.uint64)
                padded = sc.trivial(pv).ct
                cur = Blocks(
                    type(ct)(jnp.concatenate([ct.lo, padded.lo], axis=axis),
                             jnp.concatenate([ct.hi, padded.hi], axis=axis)),
                    cur.degree, cur.noise_var)
            shape = list(cur.ct.lo.shape)
            groups = shape[axis] // g
            new_shape = shape[:axis] + [groups, g] + shape[axis + 1:]
            resh = torus.reshape(cur.ct, new_shape)
            summed = torus.sum_axis(resh, axis + 1)
            sblocks = Blocks(summed, min(g, 15), cur.noise_var * g)
            # mid-levels reduce with "any>=1"/"all==g" to keep bit semantics
            cur = sc.apply_lut(sblocks, [table_fn(v, g) for v in range(16)])
        ct = cur.ct
        lo = jnp.squeeze(ct.lo, axis=axis)
        hi = jnp.squeeze(ct.hi, axis=axis)
        return Blocks(type(ct)(lo, hi), cur.degree, cur.noise_var)

    # ---- selection ----------------------------------------------------------
    def select(self, cond: Blocks, x: Blocks, y: Blocks) -> Blocks:
        """cond ? x : y elementwise; cond bits broadcast over the block axis.

        Two masked bootstraps per block, out = cond*x + (1-cond)*y; replaces
        tfhe's if_then_else (reference fheasciichar.rs:93-104) while staying
        inside the designed 4x+y packing noise budget.
        """
        from . import torus
        mx = self.mul_bit(x, cond)
        my = self.mul_bit(y, self.not_(cond))
        return Blocks(torus.add(mx.ct, my.ct), 3, mx.noise_var + my.noise_var)

    def _fresh_bit(self, c: Blocks, scale: int) -> Blocks:
        if c.noise_var * scale * scale + 2 > self.sc.max_noise_var:
            return self.sc.apply_lut(c, [1 if v >= 1 else 0 for v in range(16)])
        return c

    def mul_bit(self, x: Blocks, bit: Blocks) -> Blocks:
        """x * bit (char masking): one PBS per block."""
        sc = self.sc
        x = self._fresh(x)
        bit = self._fresh_bit(bit, scale=4)
        from . import torus
        b_lo = bit.ct.lo[..., None, :]
        b_hi = bit.ct.hi[..., None, :]
        bb = type(bit.ct)(jnp.broadcast_to(b_lo, x.ct.lo.shape),
                          jnp.broadcast_to(b_hi, x.ct.hi.shape))
        packed = Blocks(torus.add(torus.mul_small(bb, MSG), x.ct), 7,
                        16 * bit.noise_var + x.noise_var)
        return sc.apply_lut(packed, [(u - 4) if u >= 4 else 0 for u in range(8)] + [0] * 8)

    # ---- char predicates (fused nibble LUTs) --------------------------------
    def ne_zero(self, x: Blocks) -> Blocks:
        sc = self.sc
        x = self._fresh(x)
        lo, hi = self._nibbles(x)
        a = sc.apply_lut(lo, [0] + [1] * 15)
        b = sc.apply_lut(hi, [0] + [1] * 15)
        return sc.apply_lut(sc.add(a, b), [0, 1, 1] + [0] * 13)

    def eq_zero(self, x: Blocks) -> Blocks:
        sc = self.sc
        x = self._fresh(x)
        lo, hi = self._nibbles(x)
        a = sc.apply_lut(lo, [1] + [0] * 15)
        b = sc.apply_lut(hi, [1] + [0] * 15)
        return sc.apply_lut(sc.add(a, b), [0, 0, 1] + [0] * 13)

    def is_whitespace(self, x: Blocks) -> Blocks:
        """Whitespace set {0x09..0x0D, 0x20} in 3 PBS (vs 6 eq + 5 or in the
        reference, fheasciichar.rs:106-130)."""
        sc = self.sc
        x = self._fresh(x)
        lo, hi = self._nibbles(x)
        s = sc.apply_lut(lo, [1] + [0] * 8 + [2] * 5 + [0, 0])  # 1:lo==0, 2:lo in 9..13
        e = sc.apply_lut(hi, [1, 0, 2] + [0] * 13)              # 1:hi==0, 2:hi==2
        packed = sc.add(sc.scalar_mul(e, MSG), s)
        table = [1 if ((u >> 2) == 1 and (u & 3) == 2) or ((u >> 2) == 2 and (u & 3) == 1)
                 else 0 for u in range(16)]
        return sc.apply_lut(packed, table)

    def _is_case(self, x: Blocks, hi_lo_val: int) -> Blocks:
        """Range test [hi_lo_val*16+1-16 .. ]: chars hi==h: lo>=1; hi==h+1: lo<=10."""
        sc = self.sc
        x = self._fresh(x)
        lo, hi = self._nibbles(x)
        s_tab = [(1 if v >= 1 else 0) + 2 * (1 if v <= 10 else 0) for v in range(16)]
        s = sc.apply_lut(lo, s_tab)
        e_tab = [0] * 16
        e_tab[hi_lo_val] = 1
        e_tab[hi_lo_val + 1] = 2
        e = sc.apply_lut(hi, e_tab)
        packed = sc.add(sc.scalar_mul(e, MSG), s)
        table = [1 if (((u >> 2) == 1 and ((u & 3) & 1)) or ((u >> 2) == 2 and ((u & 3) & 2)))
                 else 0 for u in range(16)]
        return sc.apply_lut(packed, table)

    def is_uppercase(self, x: Blocks) -> Blocks:
        """'A'(0x41)..'Z'(0x5A), reference fheasciichar.rs:132-144."""
        return self._is_case(x, 4)

    def is_lowercase(self, x: Blocks) -> Blocks:
        """'a'(0x61)..'z'(0x7A), reference fheasciichar.rs:146-158."""
        return self._is_case(x, 6)

    def _adjust_case_block2(self, x: Blocks, flag: Blocks, sign: int) -> Blocks:
        """x.block2 +- 2*flag; valid because flag implies block2 has room."""
        sc = self.sc
        from . import torus
        b2 = self.block(x, 2)
        two_flag = sc.scalar_mul(flag, 2)
        if sign > 0:
            nb2 = torus.add(b2.ct, two_flag.ct)
        else:
            nb2 = torus.sub(b2.ct, two_flag.ct)
        new_b2 = Blocks(nb2, 3, b2.noise_var + two_flag.noise_var)
        return self.from_blocks([self.block(x, 0), self.block(x, 1), new_b2,
                                 self.block(x, 3)])

    def to_upper_char(self, x: Blocks) -> Blocks:
        """c - 32*is_lowercase(c): 4 PBS/char (reference to_upper is ~30,
        src/server_key/mod.rs:65-84)."""
        return self._adjust_case_block2(x, self.is_lowercase(x), -1)

    def to_lower_char(self, x: Blocks) -> Blocks:
        return self._adjust_case_block2(x, self.is_uppercase(x), +1)

    # ---- radix arithmetic ----------------------------------------------------
    def add_chars(self, x: Blocks, y: Blocks, carry_in: int = 0) -> Blocks:
        """x + y mod 256 with sequential carry propagation."""
        sc = self.sc
        x, y = self._fresh(x), self._fresh(y)
        carry = None
        out = []
        for b in range(NB):
            s = sc.add(self.block(x, b), self.block(y, b))
            if b == 0 and carry_in:
                s = sc.add_scalar(s, carry_in)
            if carry is not None:
                s = sc.add(s, carry)
            out.append(sc.apply_lut(s, [v % 4 for v in range(16)]))
            if b < NB - 1:
                carry = sc.apply_lut(s, [v // 4 for v in range(16)])
        return self.from_blocks(out)

    def sub_chars(self, x: Blocks, y: Blocks) -> Blocks:
        """x - y mod 256 via complement: x + (255 - y) + 1."""
        comp = self.sc.sub_from_scalar(3, self._fresh(y))
        return self.add_chars(x, comp, carry_in=1)

    def sum_bits(self, bits: Blocks, axis: int) -> Blocks:
        """Sum n bits (n <= 255) along an axis into a full u8 char.

        Carry-save accumulation: repeatedly sum groups linearly and split
        into (mod 4, div 4) block pairs — the engine's replacement for the
        reference's chains of radix adds in len() (src/server_key/mod.rs:478).
        """
        sc = self.sc
        if axis < 0:
            axis = len(bits.shape) + axis
        n = bits.shape[axis]
        assert n <= 255
        from . import torus

        def move_last(b: Blocks) -> Blocks:
            lo = jnp.moveaxis(b.ct.lo, axis, -2)
            hi = jnp.moveaxis(b.ct.hi, axis, -2)
            return Blocks(type(b.ct)(lo, hi), b.degree, b.noise_var)

        # positions[i] = list-like Blocks with trailing count axis at -2
        positions: list[Blocks | None] = [move_last(bits), None, None, None]

        def group_sum(b: Blocks, g: int) -> Blocks:
            cnt = b.ct.lo.shape[-2]
            pad = (-cnt) % g
            ct = b.ct
            if pad:
                zshape = list(ct.lo.shape)
                zshape[-2] = pad
                z = jnp.zeros(zshape, jnp.uint32)
                ct = type(ct)(jnp.concatenate([ct.lo, z], axis=-2),
                              jnp.concatenate([ct.hi, z], axis=-2))
            shape = list(ct.lo.shape)
            shape[-2:-1] = [shape[-2] // g, g]
            resh = torus.reshape(ct, shape)
            summed = torus.sum_axis(resh, -2)
            return Blocks(summed, min(b.degree * g, 15), b.noise_var * g)

        done = [None, None, None, None]
        while True:
            busy = False
            for pos in range(NB):
                cur = positions[pos]
                if cur is None:
                    continue
                cnt = cur.ct.lo.shape[-2]
                if cnt == 1 and cur.degree <= 3:
                    done[pos] = Blocks(
                        type(cur.ct)(cur.ct.lo[..., 0, :], cur.ct.hi[..., 0, :]),
                        cur.degree, cur.noise_var)
                    positions[pos] = None
                    continue
                busy = True
                g = max(2, min(cnt, 15 // max(cur.degree, 1)))
                g = min(g, cnt)
                summed = group_sum(cur, g)  # degree <= 15
                low = sc.apply_lut(summed, [v % 4 for v in range(16)])
                high = sc.apply_lut(summed, [v // 4 for v in range(16)])
                positions[pos] = low
                if pos + 1 < NB:
                    nxt = positions[pos + 1]
                    if nxt is None and done[pos + 1] is not None:
                        nxt = Blocks(
                            type(done[pos + 1].ct)(
                                done[pos + 1].ct.lo[..., None, :],
                                done[pos + 1].ct.hi[..., None, :]),
                            done[pos + 1].degree, done[pos + 1].noise_var)
                        done[pos + 1] = None
                    if nxt is None:
                        positions[pos + 1] = high
                    else:
                        cat = torus.concatenate([nxt.ct, high.ct], axis=-2)
                        positions[pos + 1] = Blocks(
                            cat, max(nxt.degree, high.degree),
                            max(nxt.noise_var, high.noise_var))
            if not busy:
                break
        zero = sc.trivial(np.zeros((), np.uint64))
        blocks = []
        for pos in range(NB):
            if done[pos] is None:
                zshape = bits.shape[:axis] + bits.shape[axis + 1:]
                blocks.append(sc.trivial(np.zeros(zshape, np.uint64)))
            else:
                blocks.append(done[pos])
        del zero
        return self.from_blocks(blocks)
