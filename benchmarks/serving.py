#!/usr/bin/env python
"""Multi-query serving benchmark: N concurrent encrypted queries per step.

The headline bench (bench.py) measures raw batched-PBS throughput at
B = 2048, but a SINGLE query's per-op PBS batches are small (8-194 wide at
the methods.py shapes) so a one-query-at-a-time server idles the device.
Query batching answers that: Q concurrent queries' PBS work flattens into
one wide batch (query x window x pattern x block), so per-op batch width
scales with Q and the device approaches its raw kernel throughput.

This benchmark runs a batched homomorphic `contains` ("hello world" x
"ello", the reference driver's flagship op, reference
src/server_key/mod.rs:151-182) over Q in {1, 8, 32} concurrent queries and
reports queries/s, achieved PBS/s, and the fraction of bench.py's raw
kernel throughput reached.

Usage: python benchmarks/serving.py [--params turbo] [--queries 1 8 32]
Prints one JSON line per Q.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def batched_contains(backend, s_blocks, pat_blocks, L: int, m: int):
    """contains over a query axis: s [Q, L] chars, pat [Q, m] chars -> [Q]
    bits. Same algorithm as engine.strings.contains (windowed eq ->
    AND-tree -> OR-tree) with every PBS batch Q x wider."""
    b = backend
    W = L - m + 1
    idx = np.arange(W)[:, None] + np.arange(m)[None, :]
    wins = b.take(s_blocks, idx, axis=1)            # [Q, W, m]
    pat_b = b.reshape(pat_blocks, (-1, 1, m))       # [Q, 1, m]
    eqs = b.eq(wins, pat_b)                         # [Q, W, m]
    match = b.all_axis(eqs, 2)                      # [Q, W]
    return b.any_axis(match, 1)                     # [Q]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="turbo",
                    choices=["turbo", "prod", "test", "test32"])
    ap.add_argument("--queries", type=int, nargs="*", default=[1, 8, 32])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--string", default="hello world")
    ap.add_argument("--pattern", default="ello")
    ap.add_argument("--ops", nargs="*",
                    default=["contains", "to_upper", "split"],
                    help="ops to benchmark: contains (predicate), to_upper "
                         "(rewrite), split (structured, vmapped engine)")
    ap.add_argument("--socket", action="store_true",
                    help="also measure the single-query end-to-end path "
                         "through the real service.py socket boundary "
                         "(serialize -> TCP -> evaluate -> serialize back)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from fhestring_tpu.compat import enable_compile_cache

    enable_compile_cache()

    from fhestring_tpu import metrics
    from fhestring_tpu import params as P
    from fhestring_tpu.client import ClientKey
    from fhestring_tpu.shortint import Blocks
    from fhestring_tpu.torus import U64

    params = {"turbo": P.PARAM_TURBO, "prod": P.PARAM_PROD,
              "test": P.PARAM_TEST_ZERO_NOISE,
              "test32": P.PARAM_TEST32_ZERO_NOISE}[args.params]
    print(f"# params={params.name} devices={jax.devices()}", file=sys.stderr)

    if args.params in ("turbo", "prod"):
        import bench

        ck = ClientKey(params, seed=0)
        sk, srv_raw = bench.get_keys(params)
        ck.secret, ck._server_raw = sk, srv_raw  # reuse the bench key cache
        cache = os.path.join(bench.CACHE_DIR, f"packed_{params.name}.npz")
        server = ck.get_server_key(cache_path=cache)
    else:
        ck = ClientKey(params, seed=0)
        server = ck.get_server_key()
    b = server.backend

    text, pat_txt = args.string, args.pattern
    L = len(text) + 1  # STRING_PADDING = 1
    m = len(pat_txt)
    want = int(pat_txt in text)

    fence = jax.jit(lambda lo: lo.ravel()[::97].astype(jnp.uint32).sum())

    # oracle expectations
    from fhestring_tpu.utils import trim_str_vector
    want_upper = text.upper()
    want_split = text.split(pat_txt)

    for Q in args.queries:
        encs = [ck.encrypt(text, padding=1) for _ in range(Q)]
        pats = [ck.encrypt_no_padding(pat_txt) for _ in range(Q)]
        sb = Blocks(U64(jnp.stack([e.blocks.ct.lo for e in encs]),
                        jnp.stack([e.blocks.ct.hi for e in encs])), 3, 1.0)
        pb = Blocks(U64(jnp.stack([p.blocks.ct.lo for p in pats]),
                        jnp.stack([p.blocks.ct.hi for p in pats])), 3, 1.0)

        for op in args.ops:
            if op == "contains":
                run = lambda: batched_contains(b, sb, pb, L, m)
            elif op == "to_upper":
                # rewrite op batched over the query axis: [Q, L] chars
                run = lambda: b.to_upper(sb)
            elif op == "split":
                # structured op: vmap the 1-D engine split over the query
                # axis — every PBS batch inside the scan and the post-pass
                # becomes Q x wider (the dryrun_multichip stage-2 pattern)
                def one(sq, pq):
                    grid, found = server.engine._split(
                        sq, pq, False, False, None)
                    return grid, server.engine._bit_to_char(found)
                vsplit = jax.vmap(one, in_axes=(0, 0))
                run = lambda: vsplit(sb, pb)
            else:
                raise SystemExit(f"unknown op {op}")

            metrics.reset()
            with metrics.measure(f"{op}_q{Q}"):
                out = run()
                first = jax.tree.leaves(out)[0]
                np.asarray(fence(first))
            rec = metrics.last()
            pbs_total = rec.pbs_items
            if op == "split":
                # metrics count trace-time batch widths; the vmapped engine
                # executes every PBS batch Q x wider than traced
                pbs_total *= Q

            best = rec.seconds  # seed from the measured first run (reps=0 ok)
            for _ in range(args.reps):
                t0 = time.time()
                out = run()
                first = jax.tree.leaves(out)[0]
                np.asarray(fence(first))
                best = min(best, time.time() - t0)

            # correctness: decode query 0 (and for contains, all queries)
            if op == "contains":
                ones = b.trivial_chars(np.ones(Q, np.uint8))
                chars = b.mul_bit(ones, out)
                got = [ck.decrypt_char(_wrap_bit(chars, i)) for i in range(Q)]
                ok = all(g == want for g in got)
            elif op == "to_upper":
                ok = ck.decrypt(_wrap_string(out, 0)) == want_upper
            else:
                from fhestring_tpu.ciphertext import FheChar, FheSplit
                grid, fchar = out
                g0 = jax.tree.map(lambda x: x[0], grid)
                f0 = jax.tree.map(lambda x: x[0], fchar)
                parts, _ = ck.decrypt_split(FheSplit(g0, FheChar(f0)))
                ok = trim_str_vector(parts) == trim_str_vector(want_split)

            print(json.dumps({
                "metric": f"serving_{op}",
                "params": params.name,
                "queries": Q,
                "string_len": L,
                "pattern_len": m,
                "pbs_per_query": round(pbs_total / Q, 1),
                "wall_s": round(best, 4),
                "queries_per_s": round(Q / best, 2),
                "achieved_pbs_per_s": round(pbs_total / best, 1),
                "ok": bool(ok),
            }), flush=True)

    if args.socket:
        # single-query end-to-end through the REAL process boundary:
        # serialize -> TCP socket -> server evaluates -> serialize back.
        from fhestring_tpu.service import FheStringServer, RemoteServerKey

        fss = FheStringServer(server).start()
        try:
            remote = RemoteServerKey(fss.address)
            s_enc = ck.encrypt(text, padding=1)
            p_enc = ck.encrypt_no_padding(pat_txt)
            socket_ops = [
                ("contains", lambda: remote.contains(s_enc, p_enc),
                 lambda r: ck.decrypt_char(r) == want),
                ("to_upper", lambda: remote.to_upper(s_enc),
                 lambda r: ck.decrypt(r) == want_upper),
                ("split", lambda: remote.split(s_enc, p_enc),
                 lambda r: trim_str_vector(ck.decrypt_split(r)[0])
                 == trim_str_vector(want_split)),
            ]
            for op, fn, check in [t for t in socket_ops if t[0] in args.ops]:
                t0 = time.time()
                res = fn()  # warm (compile)
                best = time.time() - t0
                for _ in range(args.reps):
                    t0 = time.time()
                    res = fn()
                    best = min(best, time.time() - t0)
                print(json.dumps({
                    "metric": f"serving_socket_{op}",
                    "params": params.name,
                    "queries": 1,
                    "wall_s": round(best, 4),
                    "queries_per_s": round(1 / best, 2),
                    "ok": bool(check(res)),
                }), flush=True)
        finally:
            fss.stop()


def _wrap_bit(out, i):
    import jax

    from fhestring_tpu.ciphertext import FheChar

    return FheChar(jax.tree.map(lambda x: x[i], out))


def _wrap_string(out, i):
    import jax

    from fhestring_tpu.ciphertext import FheString

    return FheString(jax.tree.map(lambda x: x[i], out))


if __name__ == "__main__":
    main()
