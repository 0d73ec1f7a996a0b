"""Raw int16 ingestion: the carrier demod and the chain fed the
recording format directly against the same samples as complex IQ."""

import numpy as np
import jax.numpy as jnp
import pytest

from isee3_decoder_tpu.ops import carrier
from tests.test_pmdemod import pm_signal


def _raw_int16(iq: np.ndarray) -> np.ndarray:
    ri = np.stack([iq.real, iq.imag], axis=-1).reshape(iq.shape[0], -1)
    return np.trunc(np.clip(ri, -32767, 32767)).astype(np.int16)


def _complex(raw: np.ndarray) -> np.ndarray:
    q = raw.astype(np.float32).reshape(raw.shape[0], -1, 2)
    return (q[..., 0] + 1j * q[..., 1]).astype(np.complex64)


def _signals(cfg, T, nch=8, seed=11, chirp=None):
    n = cfg.fftsize
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2, 256) * 2 - 1
    freqs = 2000.0 + 137.0 * np.arange(nch)
    iq = np.stack([
        pm_signal(T * n, cfg.samprate, f, 1.1, data, 32.0, amp=12000)
        + rng.normal(0, 300, T * n) + 1j * rng.normal(0, 300, T * n)
        for f in freqs
    ])
    if chirp is not None:
        iq = iq * chirp
    return _raw_int16(iq), freqs


@pytest.mark.parametrize("doppler_rate", [0.0, 50.0])
def test_raw_scan_matches_complex_scan(doppler_rate):
    """pm_demod_scan over raw int16 blocks equals the scan over the same
    samples as complex64, bit for bit, over several blocks (lock carry)
    and with a Doppler de-chirp."""
    cfg = carrier.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0,
                           doppler_rate=doppler_rate)
    n, nch, T = cfg.fftsize, 8, 3
    raw, _ = _signals(cfg, T, nch)
    carry = carrier.init_carry(nch, cfg)
    c1, o1 = carrier.pm_demod_scan(
        carry, jnp.asarray(raw.reshape(nch, T, 2 * n)), cfg)
    c2, o2 = carrier.pm_demod_scan(
        carry, jnp.asarray(_complex(raw).reshape(nch, T, n)), cfg)
    assert np.asarray(o1.locked)[-1].all(), "carriers did not lock"
    for a, b in zip((*o1, *c1), (*o2, *c2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_raw_flip_swaps_iq():
    """-f (flip) reads Q,I pairs: the same as swapping the axes of the
    complex samples."""
    cfg = carrier.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0)
    n, nch = cfg.fftsize, 4
    raw, _ = _signals(cfg, 1, nch, seed=5)
    z = _complex(raw)
    carry = carrier.init_carry(nch, cfg)
    _, o1 = carrier.pm_demod_scan(
        carry, jnp.asarray(raw.reshape(nch, 1, 2 * n)), cfg, flip=True)
    swapped = (z.imag + 1j * z.real).astype(np.complex64)
    _, o2 = carrier.pm_demod_scan(
        carry, jnp.asarray(swapped.reshape(nch, 1, n)), cfg)
    np.testing.assert_array_equal(np.asarray(o1.baseband), np.asarray(o2.baseband))
    np.testing.assert_array_equal(np.asarray(o1.locked), np.asarray(o2.locked))
    # the two conversions fuse differently: float32 sum-order ulps
    for a, b in ((o1.carrier_freq, o2.carrier_freq), (o1.cn0, o2.cn0)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5)


def test_windowed_bins_match_float64_fft():
    """The windowed carrier DFT's bins equal a float64 FFT's to float32
    rounding (HIGHEST-precision contractions), peak bins exactly."""
    cfg = carrier.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0)
    n, nch = cfg.fftsize, 8
    raw, freqs = _signals(cfg, 1, nch, seed=9)
    z = _complex(raw)
    K = carrier._window_bins(cfg)
    first1 = np.trunc((freqs - cfg.search_width) / cfg.actual_binsize).astype(
        np.int32) - 1
    S = np.asarray(carrier.windowed_bins(jnp.asarray(z), jnp.asarray(first1),
                                         K, cfg))
    X = np.fft.fft(z.astype(np.complex128), axis=-1)
    ref = np.take_along_axis(X, first1[:, None] + np.arange(K)[None, :], axis=1)
    rel = np.abs(S - ref).max(1) / np.abs(ref).max(1)
    assert rel.max() < 1e-5, rel.max()
    np.testing.assert_array_equal(np.abs(S).argmax(1), np.abs(ref).argmax(1))


def test_demod_raw_matches_complex_input():
    """demod_to_symbols fed the int16 recording equals the chain fed the
    same samples as complex64: soft symbols, baseband and C/N0."""
    from isee3_decoder_tpu.models.pipeline import PipelineConfig, demod_to_symbols
    from isee3_decoder_tpu.ops.symbols import SymConfig
    from isee3_decoder_tpu.utils import testsignal

    rng = np.random.default_rng(2)
    frames = testsignal.random_frames(rng, 3)
    samprate, symrate = 32768.0, 1024.0
    iq = testsignal.synthesize_iq(
        frames, samprate=samprate, symrate=symrate, carrier=5000.0,
        noise_std=800.0, lead_symbols=40, rng=rng,
    )
    raw = np.broadcast_to(testsignal.iq_to_int16(iq), (2, 2 * iq.size))
    cfg = PipelineConfig(
        pm=carrier.PMConfig(samprate=samprate, binsize=8.0, search_width=100.0),
        sym=SymConfig(samprate=samprate, symrate=symrate),
    )
    out_r = demod_to_symbols(jnp.asarray(raw), cfg)
    out_c = demod_to_symbols(jnp.asarray(_complex(np.ascontiguousarray(raw))), cfg)
    assert out_r[0].size > 0
    for a, b in zip(out_r, out_c):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
