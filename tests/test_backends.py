"""Per-platform defaults, the compile cache, and the entry points'
refusal to measure without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from isee3_decoder_tpu import backends

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_platform_defaults_resolve(platform):
    d = backends.defaults(platform)
    assert d.fano_unroll >= 1


def test_unmeasured_platform_is_an_error():
    assert set(backends.PLATFORM_DEFAULTS) == {"cpu", "gpu"}
    with pytest.raises(ValueError, match="no measured defaults"):
        backends.defaults("rocm")


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backends.compile_cache_dir() == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert backends.compile_cache_dir() == str(ROOT / "build" / "jax_cache")


@pytest.mark.parametrize("user_value", [None, "true"])
def test_cli_stage_allocates_on_demand(monkeypatch, user_value):
    """A CLI stage turns preallocation off (so piped stages share one
    card) unless the user chose otherwise."""
    from isee3_decoder_tpu.cli._io import setup_jax

    if user_value is None:
        monkeypatch.delenv("XLA_PYTHON_CLIENT_PREALLOCATE", raising=False)
    else:
        monkeypatch.setenv("XLA_PYTHON_CLIENT_PREALLOCATE", user_value)
    setup_jax()
    assert os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] == (user_value or "false")


def test_every_jax_cli_calls_setup_jax():
    for path in sorted((ROOT / "isee3_decoder_tpu" / "cli").glob("*.py")):
        src = path.read_text()
        if "jax" in src and path.name != "_io.py":
            assert "setup_jax()" in src, path.name


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    r = _run(["chip_smoke.py"], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu():
    r = _run(["bench.py"], ROOT)
    assert r.returncode != 0
    assert not r.stdout.strip()
