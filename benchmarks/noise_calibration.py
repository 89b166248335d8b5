#!/usr/bin/env python
"""Calibrate the shortint noise budget against measured PBS output noise.

Round-1 shipped MAX_NOISE_VAR = 34.0 "fresh-PBS units" as a guess
(shortint.py TODO). This script measures, on the real device at production
parameters (or on the CPU oracle path at CI parameters):

  1. fresh-PBS output noise: encrypt random messages, bootstrap, compute the
     exact torus phase error e = phase - encode(table[m]) with the secret
     key; report sigma in relative-torus units;
  2. the pre-blind-rotation error of the WORST designed pack (4x + y with a
     bootstrapped x, y): this is the quantity that must stay inside the test
     polynomial's half-slot for the next PBS to decode correctly;
  3. the implied safe budget: MAX_NOISE_VAR = (tol / z)^2 / var_fresh with
     tol = 1/(2*full_space) (half-slot, relative torus) and z = 7.04
     (two-sided 2^-40 failure target), minus the KS+modswitch path variance
     measured in (2);
  4. a >= 10^4-bootstrap zero-failure check (the statistical test the CI
     suite mirrors at smaller scale in tests/test_noise_stats.py).

Usage: python benchmarks/noise_calibration.py [--params prod] [--n 16384]
Prints one JSON object with all measured quantities.
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def phase_errors(sk, cts: np.ndarray, expected: np.ndarray, p) -> np.ndarray:
    """Exact signed torus error (relative units in [-0.5, 0.5))."""
    from fhestring_tpu.numpy_ref import core as ref

    sk_bits = sk.big_lwe_sk.astype(np.uint64)
    a = cts[:, :-1].astype(np.uint64)
    b = cts[:, -1].astype(np.uint64)
    phase = b - (a * sk_bits[None, :]).sum(axis=1)  # uint64 wraps
    enc = (expected.astype(np.uint64) * np.uint64(p.delta))
    err = (phase - enc).astype(np.float64)  # uint64 wraps
    err = np.where(err >= 2.0 ** 63, err - 2.0 ** 64, err)
    return err / 2.0 ** 64


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="prod",
                    choices=["prod", "turbo", "noisy", "stat", "stat32"])
    ap.add_argument("--n", type=int, default=16384,
                    help="total bootstraps to sample (>= 10^4 for the "
                         "failure check)")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--pack-units", type=int, default=0,
                    help="also BOOTSTRAP packs synthesized at ~this many "
                         "fresh-PBS variance units (4x+y with x a sum of "
                         "independent bootstrapped zeros) and count decode "
                         "failures: the empirical check for raising "
                         "params.noise_budget")
    args = ap.parse_args()

    import jax

    from fhestring_tpu.compat import enable_compile_cache

    enable_compile_cache()

    from fhestring_tpu import params as P
    from fhestring_tpu import torus
    from fhestring_tpu.crypto import keys as dkeys
    from fhestring_tpu.crypto import pbs as dpbs
    from fhestring_tpu.numpy_ref import core as ref
    from fhestring_tpu.compat import device_info

    params = {"prod": P.PARAM_PROD, "turbo": P.PARAM_TURBO,
              "noisy": P.PARAM_TEST_NOISY,
              "stat": getattr(P, "PARAM_TEST_STAT", P.PARAM_TEST_NOISY),
              "stat32": P.PARAM_TEST32_STAT}[args.params]
    path = dpbs.bootstrap_path(params)
    print(f"# params={params.name} device={jax.devices()[0]} "
          f"path={path.name}", file=sys.stderr)

    if args.params in ("prod", "turbo"):
        import bench
        sk, srv = bench.get_keys(params)
    else:
        rng0 = np.random.default_rng(0)
        sk, srv = ref.keygen(params, rng0)
    dev = dkeys.pack_server_keys(srv, with_ntt=path.use_ntt)

    table = list(range(4)) * 4  # identity-on-message LUT
    bank = dkeys.pack_luts([table], params)
    rng = np.random.default_rng(11)

    fresh_errs, pack_errs, failures, total = [], [], 0, 0
    B = args.batch
    rounds = max(1, args.n // B)
    for r in range(rounds):
        msgs = rng.integers(0, 4, size=B)
        cts = np.stack([ref.shortint_encrypt(sk, int(m), rng) for m in msgs])
        out = dpbs.pbs_batch(torus.from_numpy(cts), np.zeros(B, np.int32),
                             bank, dev, use_ntt=path.use_ntt)
        host = torus.to_numpy(out)
        exp = np.array([table[m] for m in msgs])
        errs = phase_errors(sk, host, exp, params)
        fresh_errs.append(errs)
        dec = np.array([ref.shortint_decrypt(sk, host[i]) for i in range(B)])
        failures += int((dec != exp).sum())
        total += B

        # Worst designed pack: 4x + y from two bootstrapped outputs.
        half = B // 2
        x, y = host[:half], host[half:2 * half]
        packed = np.uint64(4) * x + y  # uint64 wraps
        pexp = (4 * exp[:half] + exp[half:2 * half]) % 16
        pack_errs.append(phase_errors(sk, packed, pexp, params))

    # ---- optional: bootstrap packs at ~pack_units variance -----------------
    # Synthesize 4x+y with x = fresh(m) + sum of (k-1) independent
    # bootstrapped zeros: variance 16k + 1 units, plaintext 4m + m2.  Then
    # BOOTSTRAP the pack — the decode failure this counts is exactly the
    # event params.noise_budget guards (pack error + keyswitch + modswitch
    # crossing the half-slot during blind rotation).
    pack_hi_failures = pack_hi_total = 0
    pack_hi_errs = []
    if args.pack_units:
        k = max(1, round((args.pack_units - 1) / 16))
        for r in range(max(1, args.n // B)):
            msgs = rng.integers(0, 4, size=B)
            m2 = rng.integers(0, 4, size=B)
            cts = np.stack([ref.shortint_encrypt(sk, int(m), rng)
                            for m in msgs])
            zct = np.stack([ref.shortint_encrypt(sk, 0, rng)
                            for _ in range((k - 1) * B)]) if k > 1 else None
            y_ct = np.stack([ref.shortint_encrypt(sk, int(m), rng)
                             for m in m2])
            allc = np.concatenate([cts, y_ct] + ([zct] if k > 1 else []))
            boot = torus.to_numpy(dpbs.pbs_batch(
                torus.from_numpy(allc),
                np.zeros(len(allc), np.int32), bank, dev,
                use_ntt=path.use_ntt))
            x = boot[:B]
            y = boot[B:2 * B]
            if k > 1:
                x = x + boot[2 * B:].reshape(k - 1, B, -1).sum(
                    axis=0, dtype=np.uint64)
            packed = np.uint64(4) * x + y                    # 16k + 1 units
            pexp = (4 * msgs + m2) % 16
            pack_hi_errs.append(phase_errors(sk, packed, pexp, params))
            out2 = torus.to_numpy(dpbs.pbs_batch(
                torus.from_numpy(packed), np.zeros(B, np.int32),
                dkeys.pack_luts([list(range(16))], params), dev,
                use_ntt=path.use_ntt))
            dec2 = np.array([ref.shortint_decrypt(sk, out2[i])
                             for i in range(B)])
            pack_hi_failures += int((dec2 != pexp % 16).sum())
            pack_hi_total += B

    fresh = np.concatenate(fresh_errs)
    pack = np.concatenate(pack_errs)
    var_fresh = float(np.var(fresh))
    var_pack = float(np.var(pack))

    tol = 1.0 / (2 * params.full_space)   # half-slot, relative torus
    z = 7.04                              # two-sided 2^-40
    budget_var = (tol / z) ** 2
    max_units = budget_var / var_fresh if var_fresh > 0 else float("inf")

    print(json.dumps({
        "params": params.name,
        "path": path.name,
        **device_info(),
        "samples": total,
        "decode_failures": failures,
        "sigma_fresh_rel": math.sqrt(var_fresh),
        "sigma_fresh_log2": math.log2(math.sqrt(var_fresh) + 1e-300),
        "sigma_pack4xy_rel": math.sqrt(var_pack),
        "pack_vs_fresh_units": var_pack / var_fresh if var_fresh else None,
        "half_slot_rel": tol,
        "budget_var_rel": budget_var,
        "max_noise_var_units_2^-40": max_units,
        "margin_sigma_at_pack": tol / math.sqrt(var_pack) if var_pack else None,
        **({
            "pack_units_requested": args.pack_units,
            "pack_units_measured": (float(np.var(np.concatenate(pack_hi_errs)))
                                    / var_fresh if var_fresh else None),
            "pack_hi_bootstraps": pack_hi_total,
            "pack_hi_decode_failures": pack_hi_failures,
        } if args.pack_units else {}),
    }))


if __name__ == "__main__":
    main()
