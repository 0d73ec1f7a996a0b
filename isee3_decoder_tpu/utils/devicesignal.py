"""On-device telemetry signal synthesis.

Benchmarks and large-scale tests synthesize IQ *on the device*, so the
host↔device path stays out of what they measure: only the frame
bytes (a few KB) are uploaded, and the encode → Manchester → PM chain
runs as jitted jnp ops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from isee3_decoder_tpu.config import DEFAULT_CODE, SYNC_STATE, CodeSpec
from isee3_decoder_tpu.ops.encode import bytes_to_bits, encode_bits


@functools.partial(
    jax.jit,
    static_argnames=(
        "nsamples", "samprate", "symrate", "mod_index", "amplitude",
        "noise_std", "code",
    ),
)
def synthesize_iq_device(
    frames: jax.Array,
    carrier_hz: jax.Array,
    key: jax.Array,
    nsamples: int,
    samprate: float = 250_000.0,
    symrate: float = 1024.0,
    mod_index: float = 1.1,
    amplitude: float = 12_000.0,
    noise_std: float = 0.0,
    code: CodeSpec = DEFAULT_CODE,
) -> jax.Array:
    """(B, nframes, 128) frame bytes → (B, nsamples) complex64 IQ.

    carrier_hz: (B,) per-channel carrier frequencies.
    The symbol stream repeats cyclically to fill nsamples.
    """
    B = frames.shape[0]
    data = frames.reshape(B, -1)
    bits = bytes_to_bits(data)
    syms, _ = encode_bits(bits, SYNC_STATE, code)  # (B, 2*nbits)
    nsym = syms.shape[-1]

    ssamp = samprate / symrate
    t = jnp.arange(nsamples, dtype=jnp.float32)
    pos = t / jnp.float32(ssamp)
    sym_idx = jnp.floor(pos).astype(jnp.int32) % nsym
    frac = pos - jnp.floor(pos)
    second_half = frac >= 0.5
    level = jnp.where(
        jnp.take_along_axis(
            syms, jnp.broadcast_to(sym_idx[None, :], (B, nsamples)), axis=-1
        ) > 0,
        1.0,
        -1.0,
    ).astype(jnp.float32)
    d = jnp.where(second_half[None, :], level, -level)

    ph = (
        2 * jnp.pi * carrier_hz[:, None] * t[None, :] / samprate
        + mod_index * d
        + 0.7
    )
    iq = amplitude * jnp.exp(1j * ph)
    if noise_std > 0:
        kr, ki = jax.random.split(key)
        iq = iq + noise_std * (
            jax.random.normal(kr, iq.shape, jnp.float32)
            + 1j * jax.random.normal(ki, iq.shape, jnp.float32)
        )
    return iq.astype(jnp.complex64)


@functools.partial(
    jax.jit,
    static_argnames=(
        "nsamples", "nchan", "samprate", "symrate", "mod_index",
        "amplitude", "noise_std", "code",
    ),
)
def synthesize_wideband_device(
    frames: jax.Array,
    carrier_hz: jax.Array,
    key: jax.Array,
    nsamples: int,
    nchan: int,
    samprate: float = 250_000.0,
    symrate: float = 1024.0,
    mod_index: float = 1.1,
    amplitude: float = 12_000.0,
    noise_std: float = 0.0,
    code: CodeSpec = DEFAULT_CODE,
) -> jax.Array:
    """(nchan, nframes, 128) frame bytes → ONE wideband capture carrying
    one telemetry downlink per polyphase channel slot.

    The flagship many-channel scenario (SURVEY.md §2.5 channel-axis row)
    starts from a single wide receiver capture, not nchan separate
    recordings.  Each channel's PM signal is synthesized at the channel
    rate (`synthesize_iq_device`), then the wide capture is assembled in
    the frequency domain: channel k's length-L spectrum occupies wide
    bins kL+b (b < L/2) and (k-1)L+b (b >= L/2) — an exact, perfectly
    bandlimited upsample-and-shift, so channel k of a critically sampled
    polyphase channelizer recovers x_k to within prototype-filter error.

    Args:
      frames: (nchan, nframes, 128) uint8 frame bytes per channel.
      carrier_hz: (nchan,) carrier offset WITHIN each channel slot
        (i.e. relative to the slot center k*samprate).
      nsamples: per-channel sample count L; the capture has
        nchan*L complex samples at rate nchan*samprate.

    DYNAMIC RANGE: the wide capture sums nchan unit-modulus carriers,
    so its peaks reach ~amplitude*nchan (worst case) /
    ~amplitude*sqrt(nchan)*crest in practice.  If the capture will be
    quantized to int16 (the recording format), pick
    ``amplitude <~ 30000 / nchan`` — at the default 12,000 a
    128-channel capture clips at ~4x full scale and the
    intermodulation wipes out several channels (found the hard way in
    round 5).  Per-channel C/N0 is set by amplitude/noise_std, so scale
    both together.

    Returns (nchan*nsamples,) complex64 wideband samples.
    """
    M = nchan
    L = nsamples
    x = synthesize_iq_device(
        frames, carrier_hz, key, L,
        samprate=samprate, symrate=symrate, mod_index=mod_index,
        amplitude=amplitude, noise_std=noise_std, code=code,
    )  # (M, L)
    X = jnp.fft.fft(x, axis=-1)
    wide_spec = jnp.concatenate(
        [X[:, : L // 2], jnp.roll(X, -1, axis=0)[:, L // 2 :]], axis=1
    ).reshape(M * L)
    # length-ML inverse of length-L bins: amplitude needs the M factor
    return (jnp.fft.ifft(wide_spec) * M).astype(jnp.complex64)
