#!/usr/bin/env python
"""Per-method benchmark: the analog of the reference's 52-method timing
table (reference src/main.rs:102-115 prints `{method} {duration}`).

For each method variant: encrypt -> homomorphic op -> decrypt, timed, with
PBS counts from metrics.py, emitted as JSON lines:

    {"method": ..., "seconds": ..., "pbs": ..., "ok": ...}

Defaults to the deterministic test parameter set on CPU (runs all 52 in
minutes); pass --params turbo or prod on a GPU host for production-parameter
latencies (every new PBS batch shape pays a one-time compile; the
persistent compile cache keeps it for later runs).

Usage: python benchmarks/methods.py [--methods Contains Len ...]
       [--string "hello world"] [--pattern "ello"] [--params test]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--string", default="hello world")
    ap.add_argument("--pattern", default="ello")
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--frm", default="o")
    ap.add_argument("--to", default="0")
    ap.add_argument("--params", default="test",
                    choices=["test", "test32", "noisy", "prod", "turbo"])
    ap.add_argument("--methods", nargs="*", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu or os.environ.get("JAX_PLATFORMS") == "cpu":
        import jax
        jax.config.update("jax_platforms", "cpu")

    from fhestring_tpu import cli, metrics
    from fhestring_tpu.client import ClientKey
    from fhestring_tpu.compat import enable_compile_cache

    enable_compile_cache()

    t0 = time.time()
    params = cli.PARAM_SETS[args.params]
    client = ClientKey(params, seed=0)
    if args.params in ("prod", "turbo"):
        # Production sets: reuse bench.py's raw-key cache and keep a packed
        # checkpoint so reruns skip the key packing.
        import bench

        sk, srv_raw = bench.get_keys(params)
        client.secret, client._server_raw = sk, srv_raw
        cache = os.path.join(bench.CACHE_DIR, f"packed_{params.name}.npz")
        server = client.get_server_key(cache_path=cache)
    else:
        server = client.get_server_key()
    print(f"# keygen {time.time() - t0:.1f}s", file=sys.stderr)

    methods = args.methods or cli.METHODS
    for method in methods:
        metrics.reset()
        t0 = time.time()
        try:
            import contextlib
            import io

            with contextlib.redirect_stdout(io.StringIO()):
                ok = cli.run_fhe_str_method(server, client, args, method)
        except Exception as e:
            print(f"# {method} errored: {e!r}", file=sys.stderr)
            ok = False
        dt = time.time() - t0
        print(json.dumps({
            "method": method,
            "seconds": round(dt, 3),
            "pbs": metrics.GLOBAL.pbs_items,
            "pbs_batches": metrics.GLOBAL.pbs_calls,
            "ok": bool(ok),
        }))

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
