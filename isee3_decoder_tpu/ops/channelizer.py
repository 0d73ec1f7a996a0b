"""Polyphase FFT channelizer: one wideband stream → many channels.

The reference processes exactly one downlink per run (its carrier found
inside a single 250 ksps passband).  Scaling to the 100+ channel target
needs a front-end that splits a wideband capture into per-channel
basebands — the classic critically-sampled polyphase filterbank:
the polyphase filtering is P tap-weighted frame sums and the channel
transform is a batched FFT.

Channel k (k = 0..M-1) is centered at frequency k·fs_out (negative
frequencies alias as usual), with output rate fs_in / M.  Outputs feed
straight into the per-channel PM demod (`models/pipeline.py`) via the
batch axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def prototype_lowpass(
    nchan: int,
    taps_per_branch: int = 8,
    beta: float = 9.0,
    cutoff_scale: float = 1.0,
) -> np.ndarray:
    """Kaiser-windowed sinc prototype for a polyphase filterbank.

    Cutoff at ``cutoff_scale`` × half the channel spacing; length
    nchan * taps_per_branch.  The critically sampled bank needs
    cutoff_scale=1.0 (anything past half-spacing aliases); the 2×
    oversampled bank uses 1.2 — the passband then covers the channel
    *edge* (−2 dB at ±spacing/2 vs −6 dB) while the stopband is still
    ~−97 dB by the doubled output Nyquist (±spacing)."""
    n = nchan * taps_per_branch
    t = np.arange(n) - (n - 1) / 2
    h = np.sinc(cutoff_scale * t / nchan) * np.kaiser(n, beta)
    return (h / h.sum()).astype(np.float32)


def _pfb_frames(x: jax.Array, hb: jax.Array, nchan: int) -> jax.Array:
    """(B, L) → (B, nout, M) tap-weighted frame sums at hop M.

    Windowed frames: y[m] = sum_p x[m+p] * hb[p] (per branch), as P
    static shifted slices — a gather of (B, nout, P, M) would copy the
    capture P-fold through device memory before the reduce.
    """
    B, L = x.shape
    P = hb.shape[0]
    nframes = L // nchan
    xf = x[:, : nframes * nchan].reshape(B, nframes, nchan)
    nout = nframes - P + 1
    filtered = jnp.zeros((B, nout, nchan), x.dtype)
    for p in range(P):
        filtered = filtered + xf[:, p : p + nout, :] * hb[p][None, None, :]
    return filtered


@functools.partial(
    jax.jit, static_argnames=("nchan", "taps_per_branch", "oversample")
)
def channelize(
    x: jax.Array,
    nchan: int,
    taps_per_branch: int = 8,
    taps: jax.Array | None = None,
    oversample: int = 1,
) -> jax.Array:
    """Split a complex wideband stream into nchan complex basebands.

    Args:
      x: (L,) or (B, L) complex64 wideband samples at rate fs_in.
      nchan: number of channels M (output rate oversample·fs_in / M).
      taps: optional prototype filter (len M*taps_per_branch); default
        Kaiser sinc.
      oversample: 1 = critically sampled (output rate fs_in/M, signal
        energy past ±fs_in/2M aliases); 2 = 2× oversampled (hop M/2,
        output rate 2·fs_in/M) so a carrier near a channel *edge* stays
        unaliased and decodable — the reference has no channelizer at
        all, and a critically sampled bank cannot recover edge channels.

    Returns (B?, nchan, nout) complex64: channel k centered at
    +k·fs_in/M (wrap for negative).
    """
    if x.ndim == 1:
        x = x[None, :]
    B = x.shape[0]
    P = taps_per_branch
    if taps is None:
        scale = 1.2 if oversample == 2 else 1.0
        h = jnp.asarray(prototype_lowpass(nchan, P, cutoff_scale=scale))
    else:
        h = jnp.asarray(taps, jnp.float32)
    # polyphase branches: h reshaped (P, M); branch r filters frame col r
    hb = h.reshape(P, nchan)

    if oversample == 1:
        filtered = _pfb_frames(x, hb, nchan)
        # Channel transform: a tone at +k*fs_out gives branch r the
        # constant phase e^{+j2πkr/M}, so the forward DFT across branches
        # collects it into bin k.  Critically sampled → no per-frame
        # phase correction (e^{-j2πk(mM)/M} = 1).
        spect = jnp.fft.fft(filtered, axis=-1)  # (B, nout, M)
        return jnp.swapaxes(spect, 1, 2).astype(jnp.complex64)

    if oversample != 2:
        raise ValueError("oversample must be 1 or 2")
    if nchan % 2:
        raise ValueError("2x oversampling needs an even channel count")
    # Two interleaved hop-M streams: even output frames start at n=mM
    # (the critically sampled grid), odd frames at n=mM+M/2.  Frame m of
    # the interleaved stream starts at n=m·M/2, so bin k carries the
    # residual carrier phase e^{+j2πk(mM/2)/M} = (-1)^{km}; multiplying
    # odd frames' odd bins by -1 re-centers every channel at baseband
    # (the circular-rotation identity of the oversampled PFB).
    ev = jnp.fft.fft(_pfb_frames(x, hb, nchan), axis=-1)
    od = jnp.fft.fft(_pfb_frames(x[:, nchan // 2 :], hb, nchan), axis=-1)
    sign = jnp.where(jnp.arange(nchan) % 2 == 0, 1.0, -1.0).astype(x.dtype)
    od = od * sign[None, None, :]
    nout = min(ev.shape[1], od.shape[1])
    inter = jnp.stack([ev[:, :nout], od[:, :nout]], axis=2)  # (B,nout,2,M)
    spect = inter.reshape(B, 2 * nout, nchan)
    return jnp.swapaxes(spect, 1, 2).astype(jnp.complex64)


def channel_center(k: int, fs_in: float, nchan: int) -> float:
    """Center frequency of channel k in Hz (aliased to ±fs_in/2)."""
    f = k * fs_in / nchan
    if f > fs_in / 2:
        f -= fs_in
    return f
