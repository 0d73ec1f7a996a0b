"""Polyphase channelizer tests: tone isolation and end-to-end decode of
multiple telemetry signals from one wideband stream."""

import numpy as np
import pytest
import jax.numpy as jnp

from isee3_decoder_tpu.models.decode import DecodeConfig, decode_stream
from isee3_decoder_tpu.models.pipeline import PipelineConfig, demod_to_symbols
from isee3_decoder_tpu.ops.carrier import PMConfig
from isee3_decoder_tpu.ops.channelizer import channel_center, channelize
from isee3_decoder_tpu.ops.symbols import SymConfig
from isee3_decoder_tpu.utils import testsignal


def test_tone_isolation():
    """Tones at different channel centers land in their channels with
    the right baseband offsets and little leakage elsewhere."""
    fs = 1_024_000.0
    M = 16  # 64 kHz channels
    L = 1 << 17
    t = np.arange(L)
    tones = {2: 1500.0, 9: -3000.0, 13: 0.0}
    x = np.zeros(L, np.complex64)
    for k, off in tones.items():
        fc = channel_center(k, fs, M) + off
        x += np.exp(2j * np.pi * fc * t / fs).astype(np.complex64)

    y = np.asarray(channelize(jnp.asarray(x), M))[0]  # (M, nout)
    fs_out = fs / M
    power = (np.abs(y) ** 2).mean(axis=1)
    loud = set(np.nonzero(power > 0.1 * power.max())[0])
    assert loud == set(tones), (loud, power)
    for k, off in tones.items():
        spec = np.fft.fft(y[k])
        freqs = np.fft.fftfreq(len(y[k]), 1 / fs_out)
        fpk = freqs[np.argmax(np.abs(spec))]
        assert abs(fpk - off) < fs_out / len(y[k]) * 2 + 1, (k, fpk, off)


def test_oversampled_edge_tones():
    """2x oversampled mode: tones past the critical half-spacing stay
    unaliased at the doubled output rate (the critical bank folds them),
    and center tones still land at DC (the odd-frame phase fix)."""
    fs = 1_024_000.0
    M = 16  # 64 kHz spacing; critical output Nyquist ±32 kHz, 2x ±64 kHz
    L = 1 << 17
    t = np.arange(L)
    # 0.55/−0.6 of the spacing off-center: outside the critical Nyquist
    tones = {3: 35_200.0, 10: -38_400.0, 5: 0.0}
    x = np.zeros(L, np.complex64)
    for k, off in tones.items():
        fc = channel_center(k, fs, M) + off
        x += np.exp(2j * np.pi * fc * t / fs).astype(np.complex64)

    y = np.asarray(channelize(jnp.asarray(x), M, oversample=2))[0]
    fs_out = 2 * fs / M
    for k, off in tones.items():
        spec = np.fft.fft(y[k])
        freqs = np.fft.fftfreq(len(y[k]), 1 / fs_out)
        fpk = freqs[np.argmax(np.abs(spec))]
        assert abs(fpk - off) < fs_out / len(y[k]) * 2 + 1, (k, fpk, off)
    # an edge tone also appears in the neighbor channel, offset by the
    # spacing — the overlapping passbands that make the bank gapless
    spec = np.fft.fft(y[4])
    freqs = np.fft.fftfreq(y.shape[1], 1 / fs_out)
    assert abs(freqs[np.argmax(np.abs(spec))] - (35_200.0 - fs / M)) < 20.0
    # cross-check: the critically sampled bank folds the 35.2 kHz tone
    y1 = np.asarray(channelize(jnp.asarray(x), M))[0]
    spec1 = np.fft.fft(y1[3])
    f1 = np.fft.fftfreq(len(y1[3]), M / fs)
    assert abs(f1[np.argmax(np.abs(spec1))] - (35_200.0 - fs / M)) < 20.0


def test_oversampled_edge_carrier_decodes():
    """A telemetry downlink whose carrier sits exactly at a channel EDGE
    — the midpoint between two centers, where the critically sampled
    bank puts its output Nyquist — demodulates and decodes cleanly from
    the 2x oversampled output."""
    rng = np.random.default_rng(7)
    fs = 1_024_000.0
    M = 8  # 128 kHz spacing; edge at ±64 kHz
    fs_out = 2 * fs / M  # 256 kHz oversampled channel rate
    frames = testsignal.random_frames(rng, 3)

    iq = testsignal.synthesize_iq(
        frames,
        samprate=fs,
        symrate=1024.0,
        carrier=channel_center(3, fs, M) + 64_000.0,  # exact edge
        amplitude=3000.0,
        noise_std=30.0,
        rng=rng,
    )
    y = np.asarray(channelize(jnp.asarray(iq.astype(np.complex64)), M,
                              oversample=2))[0]
    cfg = PipelineConfig(
        pm=PMConfig(samprate=fs_out, binsize=4.0, search_width=200.0),
        sym=SymConfig(samprate=fs_out, symrate=1024.0),
    )
    soft, bb, freq, cn0 = demod_to_symbols(jnp.asarray(y[3:4]), cfg)
    assert abs(np.asarray(freq)[-1, 0] - 64_000.0) < 50.0
    recs, _ = decode_stream(np.asarray(soft), DecodeConfig())
    good = sum(
        1
        for r in recs
        if r.good[0] and any(np.array_equal(r.data[0], f) for f in frames)
    )
    assert good >= 1


@pytest.mark.slow
def test_wideband_to_frames():
    """Four telemetry downlinks in one 2 Msps capture: channelize →
    per-channel pipeline decodes all of them."""
    rng = np.random.default_rng(0)
    fs = 2_048_000.0
    M = 8  # 256 kHz channels
    fs_out = fs / M
    chans = [1, 3, 4, 6]
    frames = testsignal.random_frames(rng, 4)

    nsamp_out = None
    wide = None
    for c in chans:
        iq = testsignal.synthesize_iq(
            frames,
            samprate=fs_out,
            symrate=1024.0,
            carrier=20_000.0,  # offset inside the channel
            amplitude=3000.0,
            noise_std=0.0,
            rng=rng,
        )
        # upconvert to the channel center at the wideband rate: zero-stuff
        # by M then mix (cheap synthetic upsampler: repeat samples)
        up = np.repeat(iq, M)
        n = len(up)
        t = np.arange(n)
        fc = channel_center(c, fs, M)
        sig = up * np.exp(2j * np.pi * fc * t / fs)
        if wide is None:
            wide = np.zeros(n, np.complex64)
        wide[: len(sig)] += sig.astype(np.complex64)

    wide += (rng.normal(0, 40, len(wide)) + 1j * rng.normal(0, 40, len(wide))).astype(
        np.complex64
    )
    y = np.asarray(channelize(jnp.asarray(wide), M))[0]  # (M, nout)

    cfg = PipelineConfig(
        pm=PMConfig(samprate=fs_out, binsize=4.0, search_width=200.0),
        sym=SymConfig(samprate=fs_out, symrate=1024.0),
    )
    sel = y[chans]  # (4, nout)
    soft, bb, freq, cn0 = demod_to_symbols(jnp.asarray(sel), cfg)
    # sample-repeat upsampling keeps the carrier near 20 kHz in-channel
    f_est = np.asarray(freq)[-1]
    assert np.all(np.abs(f_est - 20_000.0) < 50.0), f_est

    recs, _ = decode_stream(np.asarray(soft), DecodeConfig())
    goods = np.zeros(len(chans), int)
    for r in recs:
        for i in range(len(chans)):
            if r.good[i] and any(np.array_equal(r.data[i], f) for f in frames):
                goods[i] += 1
    assert (goods >= 1).all(), goods


# --- the wideband chain's front end: packed capture → per-channel int16 ---

M_FE, P_FE = 128, 8


def _packed(z: np.ndarray) -> np.ndarray:
    """Complex capture → packed int32 words (I low half, Q high half)."""
    i = np.round(z.real).astype(np.int32)
    q = np.round(z.imag).astype(np.int32)
    return (i & 0xFFFF) | (q << 16)


@pytest.mark.parametrize("fmt", ["packed", "int16"])
def test_wideband_to_raw_recovers_a_tone(fmt):
    """A pure carrier in channel k of a packed (or interleaved int16)
    capture lands in output row k, everything else >= 40 dB down."""
    from isee3_decoder_tpu.models.pipeline import wideband_to_raw

    n = np.arange((2 * 128 + P_FE) * M_FE)
    k = 37
    tone = 8000.0 * np.exp(2j * np.pi * k * n / M_FE)
    if fmt == "packed":
        wide = _packed(tone)
    else:
        ri = np.stack([tone.real, tone.imag], axis=-1).reshape(-1)
        wide = np.round(ri).astype(np.int16)
    raw = np.asarray(wideband_to_raw(jnp.asarray(wide), M_FE, P_FE))
    iq = raw.astype(np.float32).reshape(M_FE, -1, 2)
    power = (iq[..., 0] ** 2 + iq[..., 1] ** 2).mean(axis=1)
    assert power.argmax() == k
    assert np.delete(power, k).max() < power[k] * 1e-4


def test_oversampled_front_end_keeps_edge_tone():
    """A tone halfway between channels k and k+1 survives the 2x bank:
    both neighbours see it at ±fs_out/4 (fs_out = 2·fs_in/M)."""
    n = np.arange((2 * 128 + P_FE) * M_FE)
    k = 21
    tone = 9000.0 * np.exp(2j * np.pi * (k + 0.5) / M_FE * n)
    z = np.asarray(channelize(jnp.asarray(tone.astype(np.complex64)), M_FE,
                              P_FE, oversample=2))[0]
    power = (np.abs(z) ** 2).mean(axis=1)
    assert set(np.argsort(power)[-2:]) == {k, k + 1}
    zk = z[k][P_FE:]  # skip filter warm-up
    freq = np.angle((zk[1:] * np.conj(zk[:-1])).mean()) / (2 * np.pi)
    assert abs(freq - 0.25) < 0.01


def test_front_end_int16_feeds_demod_like_complex():
    """The int16 recording the front end hands the per-channel chain
    demodulates to near-identical soft symbols as the unquantized
    complex channel outputs."""
    cfg = PipelineConfig(
        pm=PMConfig(samprate=8192.0, binsize=8.0, search_width=400.0),
        sym=SymConfig(samprate=8192.0, symrate=64.0, window=0.25),
    )
    from isee3_decoder_tpu.models.pipeline import wideband_to_raw

    rng = np.random.default_rng(3)
    Lc = 7 * 1024  # per-channel samples: enough for >= 2 symdemod windows
    wide = (rng.integers(-20000, 20000, (Lc * M_FE, 2))
            .astype(np.float32) @ np.array([1, 1j])).astype(np.complex64)
    raw = wideband_to_raw(jnp.asarray(_packed(wide)), M_FE, P_FE)
    chans = channelize(jnp.asarray(wide), M_FE, P_FE)[0]
    soft_r, _, _, _ = demod_to_symbols(raw, cfg)
    soft_c, _, _, _ = demod_to_symbols(chans, cfg)
    a = np.asarray(soft_r, np.int32)
    b = np.asarray(soft_c, np.int32)
    assert a.shape == b.shape and a.size > 0
    # int16 truncation of noise-like channel outputs perturbs the demod
    # gain marginally: a few per cent of symbols move by <= 3 LSB
    assert np.abs(a - b).max() <= 3
    assert (a != b).mean() < 0.05
