#!/usr/bin/env python
"""Bootstrap throughput on one GPU: batched PBS per second at a parameter set.

Times ``pbs_batch`` on B encrypted blocks with one LUT, warm, and checks
that every output decrypts to its LUT value.  Prints one JSON line per
bootstrap path, naming the parameter set, the path, the batch, the
compile time of the first call, the peak device memory, and the device
(platform, device kind and count, the card's name and power limit).

It measures the GPU only: with no CUDA device it exits non-zero before
timing anything.  A wrong decryption, or a failed --profile trace, exits
non-zero as well.

Usage: python bench.py [--params turbo|prod] [--batch 2048] [--iters 3]
                       [--path einsum ntt] [--profile DIR]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

from fhestring_tpu.compat import REPO_ROOT

CACHE_DIR = os.path.join(REPO_ROOT, ".key_cache")


def get_keys(params, seed=0):
    """Generate (or load cached) client/server keys for `params`."""
    from fhestring_tpu.numpy_ref import core as ref

    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"keys_{params.name}_{seed}.npz")
    if os.path.exists(path):
        data = np.load(path)
        sk = ref.SecretKeys(params, data["lwe_sk"], data["glwe_sk"])
        srv = ref.ServerKeys(params, data["bsk"], data["ksk"])
        return sk, srv
    return _gen_keys(params, seed, path)


def _gen_keys(params, seed, path):
    from fhestring_tpu import native
    from fhestring_tpu.numpy_ref import core as ref

    t0 = time.time()
    if native.keygen_available():
        sk, srv = native.keygen_native(params, seed.to_bytes(16, "little"))
    else:
        rng = np.random.default_rng(seed)
        sk, srv = ref.keygen(params, rng)
    print(f"# keygen took {time.time() - t0:.1f}s", file=sys.stderr)
    np.savez(path, lwe_sk=sk.lwe_sk, glwe_sk=sk.glwe_sk, bsk=srv.bsk,
             ksk=srv.ksk)
    return sk, srv


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--params", default="turbo", choices=["turbo", "prod"],
                    help="turbo = 32-bit-torus production set; prod = the "
                         "64-bit tfhe-rs mirror")
    ap.add_argument("--path", nargs="+", choices=["einsum", "ntt"],
                    default=None,
                    help="bootstrap paths to time, each on its own line "
                         "(default: the one crypto.pbs.bootstrap_path picks)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of one iteration")
    args = ap.parse_args(argv)

    import jax

    from fhestring_tpu.compat import (device_info, enable_compile_cache,
                                      require_gpu)

    require_gpu(jax.devices())
    enable_compile_cache()

    from fhestring_tpu import params as P
    from fhestring_tpu import torus
    from fhestring_tpu.crypto import keys as dkeys
    from fhestring_tpu.crypto import pbs as dpbs
    from fhestring_tpu.numpy_ref import core as ref

    params = {"turbo": P.PARAM_TURBO, "prod": P.PARAM_PROD}[args.params]
    paths = args.path or [dpbs.bootstrap_path(params).name]
    device = device_info()
    print(f"# params={params.name} paths={paths} device={device}",
          file=sys.stderr)

    sk, srv = get_keys(params)
    t0 = time.time()
    dev = dkeys.pack_server_keys(srv, with_ntt="ntt" in paths)
    jax.block_until_ready(dev)
    pack_s = time.time() - t0
    table = [(3 * x + 1) % 16 for x in range(16)]
    bank = dkeys.pack_luts([table], params)

    B = args.batch
    rng = np.random.default_rng(1)
    msgs = rng.integers(0, 16, size=B)
    cts = np.stack([ref.shortint_encrypt(sk, int(m), rng) for m in msgs])
    dct = torus.from_numpy(cts)
    idx = np.zeros(B, np.int32)
    want = np.array([table[m] for m in msgs])

    failed = False
    for name in paths:
        use_ntt = name == "ntt"

        def run():
            return jax.block_until_ready(
                dpbs.pbs_batch(dct, idx, bank, dev, use_ntt=use_ntt))

        t0 = time.time()
        out = run()
        compile_s = time.time() - t0
        times = []
        for _ in range(args.iters):
            t0 = time.time()
            out = run()
            times.append(time.time() - t0)
        if args.profile:
            with jax.profiler.trace(os.path.join(args.profile, name)):
                run()

        host = torus.to_numpy(out)
        got = np.array([ref.shortint_decrypt(sk, host[i]) for i in range(B)])
        wrong = int((got != want).sum())
        failed |= wrong > 0
        best = min(times)
        stats = jax.devices()[0].memory_stats() or {}
        print(json.dumps({
            "metric": "pbs_throughput",
            "value": B / best,
            "unit": "PBS/s",
            "params": params.name,
            "path": name,
            "batch": B,
            "seconds": times,
            "first_call_s": compile_s,
            "key_pack_s": pack_s,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "wrong_decryptions": wrong,
            **device,
        }))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
