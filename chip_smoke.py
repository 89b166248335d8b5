#!/usr/bin/env python
"""Smoke test of the encrypted-string server on one CUDA GPU.

Runs as one process, the only JAX process on the card:

1. device: requires a CUDA GPU and prints what JAX and nvidia-smi report;
2. set-up at the 32-bit-torus production set (PARAM_TURBO): native keygen,
   device key packing, peak device memory;
3. bootstrap: pbs_batch on the platform's path at turbo (B=2048) and at the
   64-bit set (PARAM_PROD, B=512); every output must decrypt to its LUT
   value, the first item must be bit-identical to numpy_ref.pbs, and a
   sample of 8 must be bit-identical to the same jitted path on JAX's CPU
   backend (on a second thread, overlapping phase 4);
4. served path: a FheStringServer on a thread answers requests from a
   RemoteServerKey over a socket at turbo; every decrypted answer must
   equal Python's str; prints each request's latency and PBS count;
5. GPU test tier: the tests marked ``gpu``, in this process.

Every compiled PBS shape is printed with the time of its first call.  Any
failure exits non-zero; the last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Usage: python chip_smoke.py
"""

import json
import os
import sys
import time

import numpy as np

from fhestring_tpu.compat import nvidia_smi, require_gpu

TURBO_BATCH = 2048
PROD_BATCH = 512
CPU_SAMPLE = 8
ORACLE_ITEMS = 1


def result_line(devices) -> str:
    """The last line of a passing run, from the devices JAX reports."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}})


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class ShapeTimer:
    """Wraps pbs_batch; times the first call of each compiled shape
    (compile + one run) and prints it.  Calls traced inside an enclosing
    jit (the engine's scans) pass straight through."""

    def __init__(self, fn):
        self.fn = fn
        self.seen = set()

    def __call__(self, ct, lut_idx, bank, keys, use_ntt=False):
        import jax

        if isinstance(ct.lo, jax.core.Tracer):
            return self.fn(ct, lut_idx, bank, keys, use_ntt=use_ntt)
        key = (keys.params.name, ct.lo.shape[0],
               "ntt" if use_ntt else "einsum",
               next(iter(keys.ksk_limbs.devices())).platform)
        if key in self.seen:
            return self.fn(ct, lut_idx, bank, keys, use_ntt=use_ntt)
        t0 = time.perf_counter()
        out = jax.block_until_ready(
            self.fn(ct, lut_idx, bank, keys, use_ntt=use_ntt))
        self.seen.add(key)
        log("compile", params=key[0], batch=key[1], path=key[2],
            platform=key[3], first_call_s=time.perf_counter() - t0)
        return out


def phase_device():
    import jax

    devices = jax.devices()
    require_gpu(devices)
    log("device", platform=devices[0].platform,
        kind=devices[0].device_kind, count=len(devices),
        jax_platforms=os.environ.get("JAX_PLATFORMS"),
        jax_version=jax.__version__)
    print(nvidia_smi(), flush=True)
    return devices


def peak_bytes():
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def phase_setup(params):
    import jax

    from fhestring_tpu.client import ClientKey

    t0 = time.perf_counter()
    ck = ClientKey(params, seed=0)
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    server_key = ck.get_server_key()
    jax.block_until_ready(server_key.backend.sc.keys)
    pack_s = time.perf_counter() - t0
    log("setup", params=params.name, path=server_key.backend.sc.path.name,
        keygen_s=keygen_s, key_pack_s=pack_s, peak_bytes_in_use=peak_bytes())
    return ck, server_key


def phase_bootstrap(params, ck, keys, batch, pbs):
    """pbs_batch at `batch` on the GPU path: every item decrypts right and
    the first ORACLE_ITEMS are bit-identical to numpy_ref.pbs.  Returns the
    comparison of the first CPU_SAMPLE items with the same jitted path on
    the CPU backend, as a function to run on another thread (it takes
    minutes at full width; XLA runs it without holding the GIL)."""
    import jax

    from fhestring_tpu import torus
    from fhestring_tpu.crypto import keys as dkeys
    from fhestring_tpu.crypto.pbs import bootstrap_path
    from fhestring_tpu.numpy_ref import core as ref

    path = bootstrap_path(params)
    table = [(5 * m + 3) % 16 for m in range(16)]
    bank = dkeys.pack_luts([table], params)
    rng = np.random.default_rng(7)
    msgs = rng.integers(0, 16, size=batch)
    cts = np.stack([ref.shortint_encrypt(ck.secret, int(m), rng)
                    for m in msgs])
    idx = np.zeros(batch, np.int32)

    pbs(torus.from_numpy(cts), idx, bank, keys, use_ntt=path.use_ntt)
    t0 = time.perf_counter()
    out = jax.block_until_ready(
        pbs(torus.from_numpy(cts), idx, bank, keys, use_ntt=path.use_ntt))
    warm_s = time.perf_counter() - t0
    host = torus.to_numpy(out)
    got = np.array([ref.shortint_decrypt(ck.secret, host[i])
                    for i in range(batch)])
    wrong = int((got != np.array([table[m] for m in msgs])).sum())

    t0 = time.perf_counter()
    oracle = [ref.pbs(cts[i], table, ck._server_raw)
              for i in range(ORACLE_ITEMS)]
    oracle_s = time.perf_counter() - t0
    oracle_ok = all(np.array_equal(o, host[i]) for i, o in enumerate(oracle))

    log("bootstrap", params=params.name, path=path.name, batch=batch,
        warm_s=warm_s, pbs_per_s=batch / warm_s, wrong_decryptions=wrong,
        oracle_items=ORACLE_ITEMS, oracle_bit_identical=oracle_ok,
        oracle_s=oracle_s, peak_bytes_in_use=peak_bytes())
    if wrong or not oracle_ok:
        raise AssertionError(f"bootstrap at {params.name} is wrong")

    def compare_on_cpu():
        cpu = jax.devices("cpu")[0]
        t0 = time.perf_counter()
        cpu_out = pbs(jax.device_put(torus.from_numpy(cts[:CPU_SAMPLE]), cpu),
                      idx[:CPU_SAMPLE], jax.device_put(bank, cpu),
                      jax.device_put(keys, cpu), use_ntt=path.use_ntt)
        same = bool(np.array_equal(torus.to_numpy(cpu_out),
                                   host[:CPU_SAMPLE]))
        log("cpu_compare", params=params.name, path=path.name,
            items=CPU_SAMPLE, bit_identical=same,
            seconds=time.perf_counter() - t0)
        if not same:
            raise AssertionError(f"GPU and CPU differ at {params.name}")

    return compare_on_cpu


# (op, argument strings, expected answer from Python's str)
def served_requests():
    s8, t8 = "Ab3 xY9z", "Ab3 xY9z"
    s32 = "  The quick brown fox jumps ov  "
    assert len(s8) == 8 and len(s32) == 32
    return [
        ("len", (s8,), len(s8)),
        ("is_empty", (s8,), int(s8 == "")),
        ("eq", (s8, t8), int(s8 == t8)),
        ("contains", (s32, "brown"), int("brown" in s32)),
        ("to_upper", (s32,), s32.upper()),
        ("trim", (s32,), s32.strip()),
    ]


def phase_served(ck, server_key, card, pbs):
    """One request per op through the socket; the shapes it compiles first
    are counted, since their compile time is inside its latency."""
    from fhestring_tpu import metrics
    from fhestring_tpu.ciphertext import FheChar
    from fhestring_tpu.service import FheStringServer, RemoteServerKey

    server = FheStringServer(server_key).start()
    try:
        remote = RemoteServerKey(server.address)
        for op, strings, want in served_requests():
            args = [ck.encrypt(strings[0], 1)]
            # a second string argument is the pattern (unpadded) for
            # contains and a full string for eq
            if len(strings) > 1:
                args.append(ck.encrypt_no_padding(strings[1])
                            if op == "contains" else ck.encrypt(strings[1], 1))
            shapes = len(pbs.seen)
            before = metrics.GLOBAL.snapshot()
            t0 = time.perf_counter()
            res = getattr(remote, op)(*args)
            latency = time.perf_counter() - t0
            d = metrics.GLOBAL.delta(before)
            got = (ck.decrypt_char(res) if isinstance(res, FheChar)
                   else ck.decrypt(res))
            log("served", op=op, latency_s=latency, pbs=d.pbs_items,
                pbs_padded=d.pbs_items_padded, pbs_batches=d.pbs_calls,
                new_pbs_shapes=len(pbs.seen) - shapes, answer=got,
                expected=want, card=card)
            if got != want:
                raise AssertionError(f"{op}: got {got!r}, want {want!r}")
    finally:
        server.stop()


def phase_gpu_tests():
    import pytest

    # conftest.py keeps the process's platform when JAX_PLATFORMS names the
    # GPU; the backends are already initialised, so this changes nothing
    # else in this process.
    os.environ["JAX_PLATFORMS"] = "cuda"
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests")])
    log("gpu_tests", exit_code=int(rc))
    if rc != 0:
        raise AssertionError(f"GPU test tier failed (pytest exit {rc})")


def run(devices, turbo, prod, turbo_batch, prod_batch) -> None:
    """Phases 2-5 at the given parameter sets and batches."""
    from concurrent.futures import ThreadPoolExecutor

    from fhestring_tpu import shortint
    from fhestring_tpu.compat import enable_compile_cache
    from fhestring_tpu.crypto import pbs as dpbs

    cache = enable_compile_cache()
    log("compile_cache", dir=cache, entries_at_start=len(os.listdir(cache)))
    pbs = ShapeTimer(dpbs.pbs_batch)
    shortint.pbs_batch = pbs
    card = nvidia_smi()

    with ThreadPoolExecutor(max_workers=1) as cpu_thread:
        ck, server_key = phase_setup(turbo)
        cpu_checks = [cpu_thread.submit(phase_bootstrap(
            turbo, ck, server_key.backend.sc.keys, turbo_batch, pbs))]
        ck64, server64 = phase_setup(prod)
        cpu_checks.append(cpu_thread.submit(phase_bootstrap(
            prod, ck64, server64.backend.sc.keys, prod_batch, pbs)))
        del ck64, server64
        phase_served(ck, server_key, card, pbs)
        for check in cpu_checks:
            check.result()
    phase_gpu_tests()
    print(card, flush=True)


def main() -> int:
    # Phase 3 compares with JAX's CPU backend in this process, so keep it
    # available where the environment restricts JAX to the GPU.
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    devices = phase_device()

    from fhestring_tpu import params as P

    run(devices, P.PARAM_TURBO, P.PARAM_PROD, TURBO_BATCH, PROD_BATCH)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
