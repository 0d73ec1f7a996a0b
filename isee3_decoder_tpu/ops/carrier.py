"""PM carrier acquisition / tracking / spin-down kernels.

Capability parity with the ``pmdemod`` stage (pmdemod.c:204-372): per
FFT-sized block — optional Doppler chirp de-rotation, FFT carrier search
(full passband when unlocked, windowed around the last lock when locked),
Quinn's second-estimator sub-bin interpolation, two-pass spin-down with
C/N0 estimation, and emission of the Q (data) axis as int16.

Batched design: one batched, jittable function processes a whole
``(channels, fftsize)`` block; the carrier loop state (search center,
C/N0) is an explicit carry pytree, and a ``lax.scan`` strings blocks
together (models/pmdemod.py).  The reference's iterative complex
oscillators (pmdemod.c:239-243, 330-335) become analytic phase ramps —
numerically cleaner and fully parallel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from isee3_decoder_tpu.ops.reductions import argmax_last


@dataclasses.dataclass(frozen=True)
class PMConfig:
    """Static pmdemod configuration (pmdemod.c:75-131 defaults)."""

    samprate: float = 250_000.0
    binsize: float = 4.0  # FFT bin size request, Hz
    search_width: float = 0.0  # ±Hz when locked; 0 disables windowing
    doppler_rate: float = 0.0  # Hz/s chirp
    cn0_threshold: float = 21.0  # dB-Hz lock threshold
    dtype: jnp.dtype = jnp.float32  # float64 for C-matching golden runs
    # windowed matmul-DFT search when every channel is locked (skips the
    # full FFT); False forces the reference's always-FFT behavior
    fast_locked_search: bool = True

    @property
    def fftsize(self) -> int:
        # Fftsize = 2^round(log2(samprate/binsize)) (pmdemod.c:129-131)
        return 1 << int(np.rint(np.log2(self.samprate / self.binsize)))

    @property
    def actual_binsize(self) -> float:
        return self.samprate / self.fftsize

    @property
    def cdtype(self) -> jnp.dtype:
        return jnp.complex128 if self.dtype == jnp.float64 else jnp.complex64


class PMCarry(NamedTuple):
    """Streaming carry: the reference's cross-block globals
    (Carrier_search_freq, cn0 — pmdemod.c:37,63)."""

    search_center: jax.Array  # (B,) Hz — recentered on lock
    cn0: jax.Array  # (B,) dB-Hz


class PMBlockOut(NamedTuple):
    baseband: jax.Array  # (B, fftsize) int16 — Q axis (data)
    carrier_freq: jax.Array  # (B,) Hz
    cn0: jax.Array  # (B,) dB-Hz
    locked: jax.Array  # (B,) bool


def init_carry(batch: int, cfg: PMConfig, start_freq: float = 0.0) -> PMCarry:
    return PMCarry(
        search_center=jnp.full((batch,), start_freq, cfg.dtype),
        cn0=jnp.full((batch,), -999.0, cfg.dtype),
    )


def _tau(x: jax.Array) -> jax.Array:
    """Quinn's second estimator helper (pmdemod.c:43-46)."""
    return 0.25 * jnp.log(3 * x * x + 6 * x + 1) - np.sqrt(6.0) / 24 * jnp.log(
        (x + 1 - np.sqrt(2 / 3.0)) / (x + 1 + np.sqrt(2 / 3.0))
    )


def doppler_chirp(iq: jax.Array, cfg: PMConfig) -> jax.Array:
    """De-rotate the per-block Doppler chirp (pmdemod.c:232-244).

    The reference restarts its doubly-integrated LO at every block, with
    instantaneous phase drate·i(i+1)/2 at sample i; this applies the same
    ramp analytically.
    """
    if cfg.doppler_rate == 0.0:
        return iq
    n = iq.shape[-1]
    drate = cfg.doppler_rate * 2 * np.pi / (cfg.samprate**2)
    i = jnp.arange(n, dtype=cfg.dtype)
    phase = drate * (i * (i + 1) / 2)
    return iq * jnp.exp(-1j * phase).astype(iq.dtype)


def _search_window(
    center: jax.Array, cn0: jax.Array, cfg: PMConfig
) -> tuple[jax.Array, jax.Array]:
    """(firstbin, lastbin) per channel (pmdemod.c:255-284).

    Faithfully replicates the reference's index arithmetic, including the
    complement-window quirk when the range straddles 0 Hz (after the
    negative-bin wraparound and swap, the searched interval is the
    midband between the two edges).
    """
    n = cfg.fftsize
    binsize = cfg.actual_binsize
    fs = cfg.samprate
    w = cfg.search_width

    locked = (w != 0) & (cn0 > cfg.cn0_threshold)

    lo = center - w
    hi = center + w
    # C int conversion truncates toward zero
    first = jnp.where(
        lo <= -fs / 2,
        jnp.zeros(center.shape, jnp.int32),
        jnp.trunc(lo / binsize).astype(jnp.int32),
    )
    first = jnp.where(first < 0, first + n, first)
    last = jnp.where(
        hi >= fs / 2,
        jnp.full(center.shape, n // 2 - 1, jnp.int32),
        jnp.trunc(hi / binsize).astype(jnp.int32),
    )
    last = jnp.where(last < 0, last + n, last)
    swap = first > last
    first, last = jnp.where(swap, last, first), jnp.where(swap, first, last)

    first = jnp.where(locked, first, 0)
    last = jnp.where(locked, last, n)
    return first, last


def find_carrier(
    spectrum: jax.Array, carry: PMCarry, cfg: PMConfig
) -> tuple[jax.Array, jax.Array]:
    """Peak-energy carrier search + Quinn interpolation
    (pmdemod.c:246-318) → (carrier_freq_hz, peak_bin)."""
    B, n = spectrum.shape
    energy = (spectrum.real**2 + spectrum.imag**2).astype(cfg.dtype)

    first, last = _search_window(carry.search_center, carry.cn0, cfg)
    idx = jnp.arange(n, dtype=jnp.int32)
    # exclusive upper bound, exactly like the reference's scan
    # `for(i=firstbin; i<lastbin; i++)` with lastbin clipped to
    # Fftsize/2 - 1 (pmdemod.c:266-292) — including its quirk that the
    # top window bin is never searched.  (A search_width below binsize/2
    # makes the window empty; the reference asserts on that config.)
    mask = (idx[None, :] >= first[:, None]) & (idx[None, :] < last[:, None])
    masked = jnp.where(mask, energy, -1.0)
    # ">=" update in the reference keeps the *last* maximal bin
    peak = argmax_last(masked, axis=1)
    maxenergy = jnp.take_along_axis(energy, peak[:, None], axis=1)[:, 0]

    nxt = (peak + 1) % n
    prv = (peak - 1 + n) % n
    sp = jnp.take_along_axis(spectrum, peak[:, None], axis=1)[:, 0]
    sn = jnp.take_along_axis(spectrum, nxt[:, None], axis=1)[:, 0]
    sm = jnp.take_along_axis(spectrum, prv[:, None], axis=1)[:, 0]
    freq = _quinn_freq(sp, sn, sm, maxenergy, peak.astype(cfg.dtype), cfg)
    return freq, peak


def _quinn_freq(
    sp: jax.Array,
    sn: jax.Array,
    sm: jax.Array,
    maxenergy: jax.Array,
    peak_bin: jax.Array,
    cfg: PMConfig,
) -> jax.Array:
    """Quinn's second estimator + Hz conversion (pmdemod.c:299-318) from
    the peak bin's spectrum value and its two neighbors."""
    safe = jnp.where(maxenergy > 0, maxenergy, 1.0)
    ap = (sn.real * sp.real + sn.imag * sp.imag) / safe
    dp = -ap / (1 - ap)
    am = (sm.real * sp.real + sm.imag * sp.imag) / safe
    dm = am / (1 - am)
    d = (dp + dm) / 2 + _tau(dp * dp) - _tau(dm * dm)
    d = jnp.where(maxenergy > 0, d, 0.0)

    freq = cfg.actual_binsize * (peak_bin + d)
    freq = jnp.where(freq > cfg.samprate / 2, freq - cfg.samprate, freq)
    return freq


def _window_bins(cfg: PMConfig) -> int:
    """Static bin count covering any locked search window plus the Quinn
    neighbors: last-first+1 <= trunc(2W/binsize)+2 in-window bins."""
    return int(2 * cfg.search_width / cfg.actual_binsize) + 3


def _fast_search_capable(cfg: PMConfig) -> bool:
    """Static gate for the windowed locked-path search."""
    n = cfg.fftsize
    return (
        cfg.search_width > 0
        and cfg.dtype == jnp.float32
        and n % 256 == 0
        and n >= 512
        and 256 * n < 2**31  # exact int32 phase arithmetic
        and (n // 256) ** 2 < 2**31
        and _window_bins(cfg) <= 2048
    )


def _fast_search_ok(carry: PMCarry, cfg: PMConfig) -> jax.Array:
    """Dynamic gate: every channel locked with a well-formed, strictly
    positive-frequency, non-wrapping window that fits the static K."""
    first, last = _search_window(carry.search_center, carry.cn0, cfg)
    locked = (carry.cn0 > cfg.cn0_threshold) & (cfg.search_width != 0)
    c, w = carry.search_center, cfg.search_width
    b, fs = cfg.actual_binsize, cfg.samprate
    ok = (
        locked
        & (c - w >= b)  # first >= 1, window never touches bin 0
        & (c + w < fs / 2 - b)  # last <= n/2-2: no top-edge clipping
        & (first >= 1)
        & (last > first)
        & (last - first <= _window_bins(cfg) - 2)
    )
    return jnp.all(ok)


def find_carrier_windowed(
    iq: jax.Array, carry: PMCarry, cfg: PMConfig
) -> tuple[jax.Array, jax.Array]:
    """Locked-path carrier search evaluating ONLY the K window bins
    (windowed_bins), then the reference's masked peak + Quinn step.
    Callers must guard with _fast_search_ok (all channels locked,
    positive non-wrapping windows).

    Returns (carrier_freq_hz, peak_bin) like find_carrier.
    """
    first, last = _search_window(carry.search_center, carry.cn0, cfg)
    first1 = first - 1  # evaluated bins: first-1 .. first+K-2
    S = windowed_bins(iq, first1, _window_bins(cfg), cfg)
    return _windowed_peak_from_s(S, first, last, first1, cfg)


def windowed_bins(
    iq: jax.Array, first1: jax.Array, K: int, cfg: PMConfig
) -> jax.Array:
    """(B, n) IQ → (B, K) spectrum bins S[b, k] = X_b[first1_b + k].

    Instead of the full n-point FFT (the reference recomputes it every
    block — pmdemod.c:253 — even though the locked search then looks at
    ~100 bins of it), this computes those bins directly by a mix-folded
    Cooley-Tukey split: with t = 256·h + l and absolute bin f,

        X[f] = Σ_h Σ_l x[h,l] · e^{-2πi h (f mod n/256)/(n/256)}
                             · e^{-2πi l f / n}

    The h-contraction is one small batched matmul and the per-channel
    window start folds into the two twiddle factors (exact integer phase
    arithmetic), so no (B, n) mix buffer and no (n, K) DFT matrix is ever
    stored.  Both contractions run at HIGHEST precision: a float32
    matmul may otherwise run in TF32 (~3 significant digits), and a
    wrong peak bin moves the whole carrier loop.
    """
    B, n = iq.shape
    nhi = n // 256
    kk = jnp.arange(K, dtype=jnp.int32)
    h = jnp.arange(nhi, dtype=jnp.int32)
    tl = jnp.arange(256, dtype=jnp.int32)

    # Twiddles split into per-channel mix vectors × shared tables so exp
    # runs on ~(B+K)·512 phases, not B·n·K/128.  All phases are exact
    # integer arithmetic (products < 2^31 by _fast_search_capable).
    def cexp(num: jax.Array, den: int) -> jax.Array:
        return jnp.exp((-2j * np.pi / den) * num.astype(jnp.float32)).astype(
            cfg.cdtype
        )

    mixh = cexp((h[None, :] * (first1 % nhi)[:, None]) % nhi, nhi)  # (B, nhi)
    hi0 = cexp((h[:, None] * kk[None, :]) % nhi, nhi)  # (nhi, K)
    mixl = cexp((tl[None, :] * (first1 % n)[:, None]) % n, n)  # (B, 256)
    lo0 = cexp((tl[:, None] * kk[None, :]) % n, n)  # (256, K)

    x3 = iq.astype(cfg.cdtype).reshape(B, nhi, 256)
    hib = mixh[:, :, None] * hi0[None, :, :]  # (B, nhi, K)
    hp = jax.lax.Precision.HIGHEST
    A = jnp.einsum("bht,bhk->btk", x3, hib, precision=hp)
    return jnp.einsum("btk,bt,tk->bk", A, mixl, lo0, precision=hp)


def _windowed_peak_from_s(
    S: jax.Array,
    first: jax.Array,
    last: jax.Array,
    first1: jax.Array,
    cfg: PMConfig,
) -> tuple[jax.Array, jax.Array]:
    """Masked peak search + Quinn interpolation over window spectrum bins
    S[b, k] = X[first1_b + k] (pmdemod.c:257-318).  Extra bins past the
    window (lane padding) are masked out."""
    kk = jnp.arange(S.shape[1], dtype=jnp.int32)
    energy = (S.real**2 + S.imag**2).astype(cfg.dtype)
    # in-window ⇔ first <= first1+k < last ⇔ 1 <= k < last-first+1,
    # reproducing the reference's exclusive-lastbin scan quirk
    mask = (kk[None, :] >= 1) & (kk[None, :] < (last - first)[:, None] + 1)
    masked = jnp.where(mask, energy, -1.0)
    pk = argmax_last(masked, axis=1)  # local; 1 <= pk <= K-2
    maxenergy = jnp.take_along_axis(energy, pk[:, None], axis=1)[:, 0]
    sp = jnp.take_along_axis(S, pk[:, None], axis=1)[:, 0]
    sn = jnp.take_along_axis(S, pk[:, None] + 1, axis=1)[:, 0]
    sm = jnp.take_along_axis(S, pk[:, None] - 1, axis=1)[:, 0]
    peak = first1 + pk
    freq = _quinn_freq(sp, sn, sm, maxenergy, peak.astype(cfg.dtype), cfg)
    return freq, peak


def _lo_ramp(carrier_freq: jax.Array, n: int, cfg: PMConfig) -> jax.Array:
    """(B,) Hz → (B, n) complex LO ``exp(-2πi f t / fs)``.

    Two-level range reduction keeps every phase argument small: a raw
    float32 cstep*i reaches ~2e5 rad at the end of a 65536-sample block,
    where the ulp is ~0.016 rad of per-sample phase jitter (the
    reference's double oscillator — pmdemod.c:330-335 — has none).
    Splitting i = 256*ihi + ilo and reducing the per-256-sample phase
    modulo one cycle keeps every intermediate below ~384 cycles
    (~3e-5-cycle ulp).
    """
    c = (carrier_freq / cfg.samprate).astype(cfg.dtype)  # cycles/sample
    if n % 256 != 0:  # tiny FFT sizes: direct reduced ramp
        i = jnp.arange(n, dtype=jnp.int32)
        cyc = jnp.mod(c[:, None] * i.astype(cfg.dtype)[None, :], 1.0)
        return jnp.exp((-2j * np.pi) * cyc).astype(cfg.cdtype)
    i = jnp.arange(n, dtype=jnp.int32)
    ihi = (i // 256).astype(cfg.dtype)
    ilo = (i % 256).astype(cfg.dtype)
    c256 = jnp.mod(c * 256.0, 1.0)
    cyc = c256[:, None] * ihi[None, :] + c[:, None] * ilo[None, :]
    return jnp.exp((-2j * np.pi) * cyc).astype(cfg.cdtype)


def spin_down(
    iq: jax.Array, carrier_freq: jax.Array, cfg: PMConfig
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Two-pass spin-down + C/N0 estimate (pmdemod.c:321-351).

    Returns (baseband complex with carrier on I axis, carrier_amplitude,
    cn0_db).
    """
    B, n = iq.shape
    lo = _lo_ramp(carrier_freq, n, cfg)
    spun = iq * lo

    if cfg.dtype == jnp.float32:
        # One-pass: the reference's second (variance) sweep
        # (pmdemod.c:341-351) re-reads the rotated block; the variance of
        # the rotated I axis is a quadratic form in five raw moments of
        # the un-rotated block, so everything reduces in a single pass
        # fused with the LO mix.  var = E[(x·û)²] - amp² loses ~f32-eps
        # relative precision, noticeable only above ~85 dB-Hz C/N0 —
        # clamped; float64 golden runs keep the exact two-pass form.
        _, amp, unit, cn0 = _moments_cn0(spun, cfg)
        rotated = spun * unit[:, None]
        return rotated, amp, cn0

    dc = spun.mean(axis=1)
    amp = jnp.abs(dc)
    unit = jnp.where(amp > 0, jnp.conj(dc) / jnp.where(amp > 0, amp, 1.0), 1.0)
    rotated = spun * unit[:, None]

    var = ((rotated.real - amp[:, None]) ** 2).mean(axis=1)
    cn0 = 10 * jnp.log10(cfg.samprate * amp * amp / (2 * var))
    return rotated, amp, cn0


def _moments_cn0(spun: jax.Array, cfg: PMConfig):
    """One-pass five-moment C/N0 estimate (see spin_down's f32 branch)
    → (dc, amp, unit, cn0)."""
    sr, si = spun.real, spun.imag
    m_r = sr.mean(axis=1)
    m_i = si.mean(axis=1)
    m_rr = (sr * sr).mean(axis=1)
    m_ii = (si * si).mean(axis=1)
    m_ri = (sr * si).mean(axis=1)
    amp2 = m_r * m_r + m_i * m_i
    amp = jnp.sqrt(amp2)
    safe2 = jnp.where(amp2 > 0, amp2, 1.0)
    e_rot2 = (m_rr * m_r * m_r + 2 * m_ri * m_r * m_i + m_ii * m_i * m_i) / safe2
    var = jnp.maximum(e_rot2 - amp2, amp2 * 3e-7 + 1e-30)
    dc = m_r + 1j * m_i
    unit = jnp.where(
        amp > 0, jnp.conj(dc) / jnp.where(amp > 0, amp, 1.0), 1.0
    ).astype(cfg.cdtype)
    cn0 = 10 * jnp.log10(cfg.samprate * amp2 / (2 * var))
    return dc, amp, unit, cn0


@functools.partial(jax.jit, static_argnames=("cfg",))
def pm_demod_block(
    carry: PMCarry, iq: jax.Array, cfg: PMConfig = PMConfig()
) -> tuple[PMCarry, PMBlockOut]:
    """One full pmdemod block step: (carry, (B, fftsize) complex IQ) →
    (carry', int16 baseband + status) — the body of pmdemod.c:204-372."""
    iq = iq.astype(cfg.cdtype)
    iq = doppler_chirp(iq, cfg)
    if cfg.fast_locked_search and _fast_search_capable(cfg):
        freq = jax.lax.cond(
            _fast_search_ok(carry, cfg),
            lambda x: find_carrier_windowed(x, carry, cfg)[0],
            lambda x: find_carrier(jnp.fft.fft(x, axis=-1), carry, cfg)[0],
            iq,
        )
    else:
        # full-passband FFT search (pmdemod.c:253)
        freq, _ = find_carrier(jnp.fft.fft(iq, axis=-1), carry, cfg)
    rotated, amp, cn0 = spin_down(iq, freq, cfg)

    locked = cn0 > cfg.cn0_threshold
    new_center = jnp.where(locked, freq.astype(cfg.dtype), carry.search_center)

    # Q axis, -3 dB headroom, C truncation toward zero (pmdemod.c:360-367)
    scaled = rotated.imag * np.sqrt(0.5)
    baseband = jnp.trunc(scaled).astype(jnp.int16)

    out = PMBlockOut(
        baseband=baseband,
        carrier_freq=freq.astype(cfg.dtype),
        cn0=cn0.astype(cfg.dtype),
        locked=locked,
    )
    return PMCarry(search_center=new_center, cn0=cn0.astype(cfg.dtype)), out


@functools.partial(jax.jit, static_argnames=("cfg", "flip"))
def pm_demod_scan(
    carry: PMCarry,
    iq_blocks: jax.Array,
    cfg: PMConfig = PMConfig(),
    flip: bool = False,
) -> tuple[PMCarry, PMBlockOut]:
    """Scan pm_demod_block over the time axis: (B, T, fftsize) complex —
    or (B, T, 2·fftsize) int16 interleaved I,Q exactly as recorded on
    disk (pmdemod.c:206-230) — → outputs stacked over T.  This is the
    streaming outer loop of pmdemod.c:204.

    Feeding raw int16 halves the device-memory read vs a pre-converted complex64
    stream (4 bytes/sample instead of 8); the int→complex conversion
    happens per block inside the scan, where it fuses into the first
    consumers."""
    raw = not jnp.issubdtype(iq_blocks.dtype, jnp.complexfloating)

    def step(c, blk):
        if raw:
            blk = iq_from_interleaved(blk, flip)
        return pm_demod_block(c, blk, cfg)

    return jax.lax.scan(step, carry, jnp.swapaxes(iq_blocks, 0, 1))


def iq_from_interleaved(raw: jax.Array, flip: bool = False) -> jax.Array:
    """int16 interleaved I,Q → complex (pmdemod.c:206-230; -f flips I/Q)."""
    raw = raw.reshape(*raw.shape[:-1], -1, 2).astype(jnp.float32)
    i, q = raw[..., 0], raw[..., 1]
    if flip:
        i, q = q, i
    return i + 1j * q
