#!/usr/bin/env python
"""Weak-scaling of the sharded PBS batch over a device mesh.

Shards a fixed per-device PBS batch across 1, 2, 4, ... devices
(parallel.pbs_batch_sharded) and reports per-mesh-size wall-clock and
scaling efficiency. On the virtual CPU mesh this validates the sharded
path end-to-end (the CPU devices share host cores, so "efficiency" there
is a correctness smoke, not a perf number); on a multi-GPU host the same
script measures weak scaling across the cards.

Usage: python benchmarks/scaling.py [--per-device 16] [--iters 2]
       [--params test|noisy|prod]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=16)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--params", default="test",
                    choices=["test", "noisy", "prod"])
    ap.add_argument("--cpu", action="store_true",
                    help="force the 8-device virtual CPU mesh")
    args = ap.parse_args()

    if args.cpu or os.environ.get("JAX_PLATFORMS") == "cpu":
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    from fhestring_tpu import params as P, torus, parallel
    from fhestring_tpu.compat import enable_compile_cache
    from fhestring_tpu.crypto import keys as dkeys
    from fhestring_tpu.crypto.pbs import bootstrap_path
    from fhestring_tpu.numpy_ref import core as ref

    enable_compile_cache()

    params = {"prod": P.PARAM_PROD, "test": P.PARAM_TEST_ZERO_NOISE,
              "noisy": P.PARAM_TEST_NOISY}[args.params]
    n_dev = len(jax.devices())
    print(f"# params={params.name} devices={n_dev} "
          f"platform={jax.devices()[0].platform}", file=sys.stderr)

    rng = np.random.default_rng(0)
    sk, srv = ref.keygen(params, rng)
    dev = dkeys.pack_server_keys(
        srv, with_ntt=bootstrap_path(params).use_ntt)
    table = [(3 * x + 1) % 16 for x in range(16)]
    bank = dkeys.pack_luts([table], params)

    results = []
    base_time = None
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    for nd in sizes:
        B = args.per_device * nd
        msgs = rng.integers(0, 16, size=B)
        cts = np.stack([ref.shortint_encrypt(sk, int(m), rng) for m in msgs])
        dct = torus.from_numpy(cts)
        idx = np.zeros(B, np.int32)
        mesh = parallel.make_mesh(nd)

        def run():
            out = parallel.pbs_batch_sharded(dct, idx, bank, dev, mesh)
            np.asarray(out.lo)  # host fetch = reliable fence
            return out

        out = run()  # compile + warm
        times = []
        for _ in range(args.iters):
            t0 = time.time()
            out = run()
            times.append(time.time() - t0)
        best = min(times)
        if nd == 1:
            base_time = best
        eff = base_time / best if base_time else float("nan")
        host = torus.to_numpy(out)
        ok = all(ref.shortint_decrypt(sk, host[i]) == table[msgs[i]]
                 for i in range(min(B, 8)))
        rec = {"devices": nd, "batch": B, "seconds": round(best, 4),
               "pbs_per_sec": round(B / best, 1),
               "weak_scaling_efficiency": round(eff, 3), "correct": ok}
        results.append(rec)
        print(json.dumps(rec))

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
