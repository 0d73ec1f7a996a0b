"""Native runtime tests: build, bindings, and cross-validation against
the JAX kernels (the cross-implementation pattern of SURVEY.md §4.2)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from isee3_decoder_tpu.config import MCQLI24, CodeSpec
from isee3_decoder_tpu.ops import encode_bits, viterbi
from isee3_decoder_tpu.ops.encode import bytes_to_bits
from isee3_decoder_tpu.utils import native

K9F = CodeSpec("TESTK9F", 0o713, 0o715, 9, 0, 1)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


def test_iq_deinterleave_matches_numpy():
    rng = np.random.default_rng(0)
    raw = rng.integers(-32768, 32767, 4096, dtype=np.int16)
    a = native.iq_deinterleave(raw)
    b = raw.astype(np.float32).reshape(-1, 2)
    want = (b[:, 0] + 1j * b[:, 1]).astype(np.complex64)
    np.testing.assert_array_equal(a, want)
    af = native.iq_deinterleave(raw, flip=True)
    wantf = (b[:, 1] + 1j * b[:, 0]).astype(np.complex64)
    np.testing.assert_array_equal(af, wantf)


def test_native_encoder_matches_jax():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 64, dtype=np.uint8)
    for code in (MCQLI24, K9F):
        got_syms, got_state = native.conv_encode(data, code, 0)
        want_syms, want_state = encode_bits(bytes_to_bits(jnp.asarray(data)), 0, code)
        np.testing.assert_array_equal(got_syms, np.asarray(want_syms))
        assert got_state == int(want_state)


def test_native_viterbi_matches_jax():
    rng = np.random.default_rng(2)
    nbits = 96
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    bits[-(K9F.k - 1):] = 0
    syms, _ = encode_bits(jnp.asarray(bits), 0, K9F)
    noisy = np.clip(
        np.where(np.asarray(syms) > 0, 170, 86).astype(np.int32)
        + rng.integers(-70, 70, 2 * nbits),
        0, 255,
    ).astype(np.uint8)
    got = native.viterbi_decode_frame(noisy, nbits, 0, 0, K9F)
    want = np.asarray(viterbi.decode_frame(jnp.asarray(noisy), nbits, 0, 0, K9F))[0]
    np.testing.assert_array_equal(got, want)


def test_stream_reader_pipe():
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:  # child: writer
        os.close(r)
        with os.fdopen(w, "wb") as f:
            f.write(payload)
        os._exit(0)
    os.close(w)
    reader = native.StreamReader(r, capacity=1 << 16)
    got = b""
    while True:
        chunk = reader.read(37_123)
        got += chunk
        if len(chunk) < 37_123:
            break
    reader.close()
    os.waitpid(pid, 0)
    os.close(r)
    assert got == payload


@pytest.mark.slow
def test_native_viterbi_full_k24_frame():
    """Cross-implementation check on the real code at a useful length:
    the C++ oracle and the JAX kernel agree on a noisy MCQLI-24 frame."""
    rng = np.random.default_rng(5)
    nbits = 96
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    bits[-(MCQLI24.k - 1):] = 0
    syms, _ = encode_bits(jnp.asarray(bits), 0, MCQLI24)
    noisy = np.clip(
        np.where(np.asarray(syms) > 0, 170, 86).astype(np.int32)
        + rng.integers(-75, 75, 2 * nbits),
        0, 255,
    ).astype(np.uint8)
    got = native.viterbi_decode_frame(noisy, nbits, 0, 0, MCQLI24)
    want = np.asarray(
        viterbi.decode_frame(jnp.asarray(noisy), nbits, 0, 0, MCQLI24)
    )[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, bits)


def test_native_build_is_shared_by_threads(monkeypatch, tmp_path):
    """Threads that ask for the library while the first caller builds it
    wait for that build instead of seeing it unavailable."""
    import shutil
    import threading
    import time
    import types
    from concurrent.futures import ThreadPoolExecutor

    assert native.available()
    real = native._NATIVE_DIR / "libisee3_io.so"
    builds = []

    def slow_make(*args, **kwargs):
        builds.append(threading.get_ident())
        time.sleep(0.3)
        shutil.copy(real, tmp_path / "libisee3_io.so")

    monkeypatch.setattr(native, "_NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "subprocess", types.SimpleNamespace(run=slow_make))
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda _: native.available(), range(4)))
    assert got == [True] * 4
    assert len(builds) == 1
