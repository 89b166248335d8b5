"""Platform-facing choices: the bootstrap path per platform, batch padding,
the compile-cache location, the GPU guards of the measurement scripts, and
the native build."""

import os
import shutil
import subprocess
import types

import numpy as np
import pytest

from fhestring_tpu import compat, metrics, native, shortint, torus
from fhestring_tpu import params as P
from fhestring_tpu.crypto import keys as dkeys
from fhestring_tpu.crypto import pbs as dpbs
from fhestring_tpu.numpy_ref import keygen

# ---------------------------------------------------------------------------
# bootstrap_path: one choice per platform, and its key layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("p", [P.PARAM_TEST32_ZERO_NOISE,
                               P.PARAM_TEST_ZERO_NOISE], ids=lambda p: p.name)
def test_bootstrap_path_and_key_layout(platform, p):
    path = dpbs.bootstrap_path(p, platform)
    if platform == "cpu":
        assert not path.use_ntt and path.name == "einsum"
    else:
        assert path.use_ntt == dpbs._GPU_USE_NTT[p.torus_bits]
    # the key layout the path reads is the one pack_server_keys produces
    _, srv = keygen(p, np.random.default_rng(0))
    dev = dkeys.pack_server_keys(srv, with_ntt=path.use_ntt)
    assert (dev.bsk_ntt is not None) == path.use_ntt


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL"])
def test_bootstrap_path_refuses_unknown_platform(platform):
    with pytest.raises(RuntimeError, match=platform):
        dpbs.bootstrap_path(P.PARAM_TURBO, platform)


def test_ntt_path_without_ntt_key_is_refused():
    p = P.PARAM_TEST_ZERO_NOISE
    _, srv = keygen(p, np.random.default_rng(1))
    dev = dkeys.pack_server_keys(srv)
    bank = dkeys.pack_luts([list(range(16))], p)
    ct = torus.zeros((8, p.big_lwe_dimension + 1))
    with pytest.raises(ValueError, match="with_ntt=True"):
        dpbs.pbs_batch(ct, np.zeros(8, np.int32), bank, dev, use_ntt=True)


# ---------------------------------------------------------------------------
# Batch padding: powers of two from 8, chunks of MAX_PBS_CHUNK
# ---------------------------------------------------------------------------

# n -> padded width of each chunk
PADDING = {
    1: [8], 8: [8], 36: [64], 128: [128], 129: [256], 1000: [1024],
    4096: [4096], 4097: [4096, 8], 9000: [4096, 4096, 1024],
}


@pytest.mark.parametrize("n", sorted(PADDING))
def test_pbs_padding_policy(n, monkeypatch):
    assert shortint.MAX_PBS_CHUNK == 4096
    calls = []

    def fake_pbs(flat, idx, bank, keys, use_ntt=False):
        calls.append(flat.lo.shape[0])
        return flat

    monkeypatch.setattr(shortint, "pbs_batch", fake_pbs)
    ctx = shortint.ShortintContext.__new__(shortint.ShortintContext)
    ctx.keys = None
    ctx.path = dpbs.BootstrapPath(use_ntt=False)
    lo = np.arange(n * 3, dtype=np.uint32).reshape(n, 3)
    flat = torus.U64(lo, lo + 1)
    before = metrics.GLOBAL.snapshot()
    out = ctx._pbs_padded(flat, np.zeros(n, np.int32), None)

    assert calls == PADDING[n]
    d = metrics.GLOBAL.delta(before)
    assert d.pbs_calls == len(PADDING[n])
    assert d.pbs_items == n
    assert d.pbs_items_padded == sum(PADDING[n])
    # padding is stripped again and the items come back in order
    np.testing.assert_array_equal(np.asarray(out.lo), lo)
    np.testing.assert_array_equal(np.asarray(out.hi), lo + 1)


# ---------------------------------------------------------------------------
# Compile cache location
# ---------------------------------------------------------------------------


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compat.compile_cache_dir() == str(tmp_path / "c")


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    a = compat.compile_cache_dir()
    assert a == compat.compile_cache_dir()
    assert a == os.path.join(compat.REPO_ROOT, ".jax_cache")
    if shutil.which("git"):
        ignored = subprocess.run(["git", "check-ignore", "-q", a],
                                 cwd=compat.REPO_ROOT).returncode
        assert ignored in (0, 128)  # 128: not a git checkout


# ---------------------------------------------------------------------------
# GPU guards of the measurement scripts
# ---------------------------------------------------------------------------


def _dev(platform, kind):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


def test_require_gpu_refuses_cpu_devices():
    import jax

    with pytest.raises(RuntimeError, match="cpu"):
        compat.require_gpu(jax.devices())
    with pytest.raises(RuntimeError, match="no device"):
        compat.require_gpu([])


def test_chip_smoke_formats_last_line_from_gpu_device():
    import json

    import chip_smoke

    devs = [_dev("gpu", "NVIDIA H100 80GB HBM3")]
    compat.require_gpu(devs)
    line = json.loads(chip_smoke.result_line(devs))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("script", ["chip_smoke", "bench"])
def test_measurement_scripts_refuse_cpu(script, capsys):
    import importlib

    mod = importlib.import_module(script)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        mod.main() if script == "chip_smoke" else mod.main([])
    assert '"ok"' not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Native libraries: built from the committed sources, never committed
# ---------------------------------------------------------------------------


def test_native_libraries_build_outside_tracked_files():
    assert native._load() is not None and native.keygen_available()
    for so in (native._SO_PATH, native._KG_SO_PATH):
        assert os.path.dirname(so) == native.BUILD_DIR and os.path.exists(so)
    if shutil.which("git"):
        ls = subprocess.run(["git", "ls-files", "*.so"],
                            cwd=compat.REPO_ROOT, capture_output=True,
                            text=True)
        assert ls.stdout == ""


def test_native_rebuilds_when_a_source_is_newer(tmp_path):
    out = str(tmp_path / "build" / "libcsprng.so")
    assert native._stale(out, (native._CSPRNG_SRC,))
    assert native._compile(native._CSPRNG_SRC, out, (["-maes", "-msse4.1"],
                                                     []))
    assert not native._stale(out, (native._CSPRNG_SRC,))
    src = tmp_path / "newer.cpp"
    src.write_text("")
    os.utime(src, (os.path.getmtime(out) + 10,) * 2)
    assert native._stale(out, (native._CSPRNG_SRC, str(src)))
    assert os.listdir(tmp_path / "build") == ["libcsprng.so"]
