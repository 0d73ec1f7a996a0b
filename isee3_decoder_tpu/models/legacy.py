"""Legacy-tool capabilities: vdecode / qdecode / framer / icesync / bitsync.

The reference keeps superseded single-purpose programs (README.txt:44,
Makefile:9-11); their capabilities are reproduced here as batched array
functions so nothing a reference user relies on is lost:

* ``qdecode_stream``   — quick-look-in decode (qdecode.c:129-134)
* ``auto_phase_flip``  — per-frame symbol-pair phasing via dual sync
                         correlators (vdecode.c:110-141, qdecode.c:95-128)
* ``vdecode_stream``   — streaming Viterbi with fixed decode delay and
                         re-encode symbol-error accounting (vdecode.c)
* ``frame_bits``       — syncword framer over a decoded bit stream
                         (framer.c:61-95)
* ``icesync_frames``   — waveform-domain FFT sync correlation + block
                         Viterbi with known boundary states (icesync.c)
* ``ebn0_from_symbol_errors`` — inverse-erfc Eb/N0 estimate
                         (icesync.c:393-402,414-443)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from isee3_decoder_tpu.config import (
    DEFAULT_CODE,
    FRAMEBITS,
    FRAMESYMBOLS,
    SYNCBITS,
    SYNCWORD,
    CodeSpec,
    sync_vector,
)
from isee3_decoder_tpu.ops import encode_bits, viterbi
from isee3_decoder_tpu.ops.encode import bits_to_bytes
from isee3_decoder_tpu.ops.syncword import framer_positions, phase_sync_peaks


def qdecode_stream(symbols: jax.Array, code: CodeSpec = DEFAULT_CODE) -> jax.Array:
    """Quick-look decode of a phased symbol stream: for each pair,
    bit = hard(s1) ^ hard(s2) ^ 1 (qdecode.c:129-134).  Output bits are
    the data stream delayed by one bit (poly1^poly2 == 0b10)."""
    if symbols.ndim == 1:
        symbols = symbols[None, :]
    s = symbols.astype(jnp.int32) > 128
    pairs = s[:, : (s.shape[1] // 2) * 2].reshape(s.shape[0], -1, 2)
    return (pairs[..., 0] ^ pairs[..., 1] ^ True).astype(jnp.uint8)


def auto_phase_flip(
    symbols: np.ndarray, code: CodeSpec = DEFAULT_CODE
) -> tuple[np.ndarray, np.ndarray]:
    """Determine symbol-pair phasing for each stream by comparing sync
    correlation peaks on even vs odd alignments over the first frame
    (vdecode.c:110-141): returns (aligned_symbols, phase (B,) int array).

    phase 1 means that stream started mid-pair; one symbol is dropped.
    Each channel is phased independently.  With mixed flips the common
    output length is L - max(flip): unflipped channels lose their final
    symbol(s) to keep the batch rectangular (a partial trailing pair
    carries no extra decodable bit).
    """
    if symbols.ndim == 1:
        symbols = symbols[None, :]
    symbols = np.asarray(symbols)
    head = symbols[:, : FRAMESYMBOLS + SYNCBITS]
    even, odd = phase_sync_peaks(jnp.asarray(head), code)
    # vdecode flips when the out-phase (even-ending) peak is stronger
    flips = (np.asarray(even) > np.asarray(odd)).astype(np.int64)
    maxf = int(flips.max()) if flips.size else 0
    L = symbols.shape[1] - maxf
    out = np.stack([symbols[b, f : f + L] for b, f in enumerate(flips)])
    return out, flips


class VdecodeResult(NamedTuple):
    bits: np.ndarray  # (B, nbits) decoded bits ('0'/'1' stream of vdecode)
    symbol_errors: np.ndarray  # (B,) re-encode hard-decision mismatches


def vdecode_stream(
    symbols: jax.Array,
    decode_delay: int = 200,
    code: CodeSpec = DEFAULT_CODE,
    backend: str = "jnp",
) -> VdecodeResult:
    """Streaming Viterbi decode of a phased soft-symbol stream.

    Capability parity with vdecode.c:142-185: per symbol pair the decoder
    updates once and a bit is chained back at fixed ``decode_delay``; the
    first ``decode_delay`` bits are suppressed.  Implemented as a block
    update (identical trellis) + chainback from state 0, then re-encode
    the decoded bits and count symbol errors against hard slices.

    Note the emitted stream equals the input data delayed by
    decode_delay + K - 2 trellis steps, exactly like the reference.

    backend: "jnp" (classic kernel) or "inplace" (rotating-layout
    kernel on its circular tape) — bit-identical.
    """
    if symbols.ndim == 1:
        symbols = symbols[None, :]
    B, L = symbols.shape
    nbits = L // 2
    syms = symbols[:, : nbits * 2]

    # Chunked update + vectorized fixed-delay chainbacks: identical
    # output to the per-pair update/decodebit loop of vdecode.c, but a
    # handful of device programs instead of nbits dispatches, and tape
    # memory bounded at (chunk + delay) planes so arbitrarily long
    # streams fit (the role of the reference's circular decision buffer,
    # vdecode.c:94).
    if backend not in ("jnp", "inplace"):
        raise ValueError(f"backend must be 'jnp' or 'inplace', got {backend!r}")
    bits_parts = []
    chunk = 4096
    tape_len = min(nbits, chunk) + decode_delay
    if backend == "inplace":
        from isee3_decoder_tpu.ops import viterbi_inplace as vip

        st = vip.stream_create(tape_len, B, code, 0)
    else:
        st = viterbi.create(tape_len, B, code, 0)
    done_bits = 0
    while done_bits < nbits:
        n = min(chunk, nbits - done_bits)
        part = jnp.asarray(syms[:, 2 * done_bits : 2 * (done_bits + n)])
        # all end-times whose full `delay` lookback is on the tape
        lo = decode_delay if done_bits == 0 else 0
        if backend == "inplace":
            st = vip.stream_update(st, part, code)
            out = vip.stream_decodebits(st, decode_delay, n - lo, code)
        else:
            st = viterbi.update_blk(st, part, code)
            out = viterbi.streaming_decodebits_window(
                st, decode_delay, n - lo, code
            )
        bits_parts.append(np.asarray(out))
        done_bits += n
    bits = (
        np.concatenate(bits_parts, axis=1)
        if bits_parts
        else np.zeros((B, 0), np.uint8)
    )

    # Re-encode self-check (vdecode.c:155-183): compare re-encoded symbols
    # against hard-sliced received symbols at the matching lag.
    lag = code.k - 2  # decodebit output lags the data by K-2 bits
    errs = np.zeros(B, np.int64)
    if bits.shape[1] > lag:
        data_bits = bits[:, lag:]
        re_syms, _ = encode_bits(jnp.asarray(data_bits), 0, code)
        re_syms = np.asarray(re_syms)
        hard = (syms[:, : re_syms.shape[1]] > 128).astype(np.uint8)
        errs = (re_syms[:, 2 * code.k :] != hard[:, 2 * code.k :]).sum(axis=1)
    return VdecodeResult(bits=bits, symbol_errors=errs)


class FramerResult(NamedTuple):
    frames: list[np.ndarray]  # decoded 128-byte frames per match
    positions: list[int]  # bit index of frame end (syncword last bit)


def frame_bits(bits: np.ndarray, channel: int = 0) -> FramerResult:
    """Frame a decoded bit stream on the 40-bit syncword (framer.c:61-95).

    A frame is emitted for every position whose preceding 1024 bits end
    in the syncword."""
    if bits.ndim == 1:
        bits = bits[None, :]
    pos = np.nonzero(np.asarray(framer_positions(jnp.asarray(bits)))[channel])[0]
    frames = []
    keep = []
    for p in pos:
        if p + 1 >= FRAMEBITS:
            frame = bits[channel, p + 1 - FRAMEBITS : p + 1]
            frames.append(np.asarray(bits_to_bytes(jnp.asarray(frame))))
            keep.append(int(p))
    return FramerResult(frames=frames, positions=keep)


# ---------------------------------------------------------------------------
# icesync: waveform-domain FFT frame sync + block Viterbi
# ---------------------------------------------------------------------------


def manchester_sync_template(
    symbolsamples: float, code: CodeSpec = DEFAULT_CODE
) -> np.ndarray:
    """Sample-rate ±1 sync template (generate_sync, icesync.c:55-141):
    the last SYNCBITS encoded sync symbols Manchester-expanded, symbol 1
    mapping to (-1, +1)."""
    sv = np.asarray(sync_vector(code))
    synclen = int(SYNCBITS * symbolsamples) + 1
    out = np.zeros(synclen)
    ind = 0
    for k in range(SYNCBITS):
        first = sv[k] == 1
        while ind < (k + 0.5) * symbolsamples:
            out[ind] = -1.0 if first else 1.0
            ind += 1
        while ind < (k + 1) * symbolsamples:
            out[ind] = 1.0 if first else -1.0
            ind += 1
    return out[:ind]


def fft_sync_search(
    samples: np.ndarray,
    template: np.ndarray,
    low: int,
    high: int,
    plot_path: str | None = None,
) -> int | None:
    """FFT cross-correlation sync search (fft_sync_search,
    icesync.c:145-208): returns the peak lag in [low, high) or None.

    When ``plot_path`` is set the full correlation array is dumped in
    the reference's plot format (icesync.c:173-186: ``signed double``
    header + one ``dot i value`` line per lag).  The reference only
    dumps ACQUISITION searches (icesync.c:296 passes the sample offset,
    the tracking search at :314 passes -1)."""
    n = len(samples)
    size = 1 << int(np.ceil(np.log2(n + len(template))))
    fa = np.fft.rfft(samples, size)
    fb = np.fft.rfft(template, size)
    corr = np.fft.irfft(fa * np.conj(fb), size)
    if plot_path is not None:
        with open(plot_path, "w") as plot:
            plot.write("signed double\n")
            # FFTW's inverse transform is unnormalized (factor Corr_size
            # vs numpy's normalized irfft) — scale for value parity
            for i, v in enumerate(corr * size):
                plot.write(f"dot {i} {v:f}\n")
    high = min(high, size)
    if not np.any(samples):
        return None
    seg = corr[low:high]
    if seg.size == 0 or seg.max() <= 0:
        return None
    return low + int(np.argmax(seg))


class IcesyncFrame(NamedTuple):
    start_sample: int
    data: np.ndarray  # 128 frame bytes
    symbol_errors: int
    ebn0_db: float | None
    min_metric: int
    max_metric: int


def icesync_frames(
    samples: np.ndarray,
    samprate: float = 250_000.0,
    symrate: float = 1024.475,
    clock_tolerance: float = 5.0,
    max_frames: int | None = None,
    code: CodeSpec = DEFAULT_CODE,
    plot_dir: str | None = None,
) -> list[IcesyncFrame]:
    """Whole-file frame sync + block Viterbi decode (icesync.c:211-411).

    Finds successive sync positions by FFT correlation (full-frame search
    to acquire, ±clock_tolerance to track), integrates Manchester symbols
    at fixed boundaries (int truncation, icesync.c:347-359), decodes with
    known 0x819fbe boundary states, and estimates Eb/N0 from re-encode
    symbol errors.

    ``plot_dir``: when set, each acquisition search dumps its full
    correlation as ``sync.<begin>.plot`` there, like the reference's
    unconditional cwd dumps (icesync.c:173-186).
    """
    import os
    samples = np.asarray(samples, np.int64)
    symbolsamples = samprate / symrate
    framesamples = symbolsamples * 2 * FRAMEBITS
    template = manchester_sync_template(symbolsamples, code)
    state = SYNCWORD & 0xFFFFFF

    out: list[IcesyncFrame] = []
    begin = 0
    startsync: int | None = None
    nsamples = len(samples)
    while begin + framesamples < nsamples and (
        max_frames is None or len(out) < max_frames
    ):
        if startsync is None:
            # the reference correlates exactly Framesamples of input
            # (icesync.c:153-161), zero-padding beyond — syncs whose
            # template run is clipped by that edge score accordingly
            s = fft_sync_search(
                samples[begin : begin + int(framesamples)], template,
                0, int(framesamples),
                plot_path=(
                    os.path.join(plot_dir, f"sync.{begin}.plot")
                    if plot_dir is not None
                    else None
                ),
            )
            if s is None:
                begin += int(framesamples)
                continue
            startsync = begin + s
        start = startsync + int(framesamples) // 2
        low = int(0.5 * framesamples - clock_tolerance)
        high = int(0.5 * framesamples + clock_tolerance)
        e = fft_sync_search(
            samples[start : start + int(framesamples)], template, low, high
        )
        if e is None:
            begin = startsync + int(framesamples)
            startsync = None
            continue
        endsync = start + e

        firstsample = int(SYNCBITS * symbolsamples + startsync)
        # Boundaries use C int truncation (icesync.c:351-353); segment
        # sums via a prefix sum.
        i = np.arange(2 * FRAMEBITS)
        ind = (firstsample + i * symbolsamples).astype(np.int64)
        mid = (firstsample + (i + 0.5) * symbolsamples).astype(np.int64)
        last = (firstsample + (i + 1.0) * symbolsamples).astype(np.int64)
        cs = np.concatenate([[0], np.cumsum(samples)])
        s = -(cs[mid] - cs[ind]) + (cs[last] - cs[mid])
        soft = np.clip(s + 128, 0, 255).astype(np.uint8)

        st = viterbi.create(FRAMEBITS, 1, code, state)
        st = viterbi.update_blk(st, jnp.asarray(soft), code)
        bits = np.asarray(viterbi.chainback(st, FRAMEBITS, state, code))[0]
        data = np.asarray(bits_to_bytes(jnp.asarray(bits)))

        re_syms, _ = encode_bits(jnp.asarray(bits), state, code)
        hard = (soft > 128).astype(np.uint8)
        symerrors = int((np.asarray(re_syms) != hard).sum())
        ebn0 = ebn0_from_symbol_errors(symerrors, 2 * FRAMEBITS)
        out.append(
            IcesyncFrame(
                start_sample=startsync,
                data=data,
                symbol_errors=symerrors,
                ebn0_db=ebn0,
                min_metric=int(viterbi.min_metric(st)[0]),
                max_metric=int(viterbi.max_metric(st)[0]),
            )
        )
        startsync = endsync
    return out


class BitsyncResult(NamedTuple):
    frames: list[np.ndarray]
    bits: np.ndarray
    infos: list[dict]


def bitsync_frames(
    samples: np.ndarray,
    samprate: float = 250_000.0,
    symrate: float = 1024.467,
    decode_delay: int = 200,
    code: CodeSpec = DEFAULT_CODE,
) -> BitsyncResult:
    """Whole-file symbol sync + streaming Viterbi + syncword framing —
    the capability of ``bitsync.c``: per-frame symbol phase search over
    ±half a symbol (bitsync.c:133-186), sync-driven Viterbi pair phasing
    (bitsync.c:208-226), fixed-delay streaming decode, and 40-bit
    syncword framing of the decoded bit stream (bitsync.c:256-270).

    Composed from the modern stage kernels (timesearch / integrate /
    vdecode / framer) rather than re-walking samples one at a time.
    """
    import jax.numpy as jnp

    from isee3_decoder_tpu.ops import symbols as sym_ops

    samples = np.asarray(samples, np.int16)
    symbolsamples = samprate / symrate
    halfclock = 0.5 * symbolsamples
    framesym = FRAMESYMBOLS
    infos = []
    soft_all = []
    firstsample = int(symbolsamples / 2)
    noff = 2 * int(symbolsamples / 2) + 1
    while firstsample + (framesym + 1) * symbolsamples < len(samples):
        ts = sym_ops.timesearch(
            jnp.asarray(samples), firstsample, halfclock, framesym, 1, noff
        )
        firstsample += int(ts.symphase[0])
        res = sym_ops.integrate_symbols(
            jnp.asarray(samples), firstsample, halfclock, framesym, 1, 0.0
        )
        integ = np.asarray(res.integrators)[0]
        energy = float(res.energy[0])
        gain = 75.0 / np.sqrt(energy)  # bitsync.c:228 "Hack"
        soft = np.clip(gain * integ + 128, 0, 255).astype(np.uint8)
        soft_all.append(soft)
        infos.append(
            dict(firstsample=firstsample, energy=energy, symrate=symrate)
        )
        firstsample = int(firstsample + framesym * symbolsamples)
    if not soft_all:
        return BitsyncResult(frames=[], bits=np.zeros(0, np.uint8), infos=[])
    stream = np.concatenate(soft_all)
    aligned, _ = auto_phase_flip(stream[None, :], code)
    dec = vdecode_stream(jnp.asarray(aligned), decode_delay, code)
    framed = frame_bits(dec.bits)
    return BitsyncResult(frames=framed.frames, bits=dec.bits[0], infos=infos)


def inverse_erf(z: float, terms: int = 100) -> float:
    """Series-expansion inverse error function (erf1, icesync.c:414-437)."""
    c = [1.0]
    for k in range(1, terms):
        s = 0.0
        for m in range(k):
            s += c[m] * c[k - 1 - m] / ((m + 1) * (2 * m + 1))
        c.append(s)
    x = z * np.sqrt(np.pi) / 2
    return float(sum(c[k] / (2 * k + 1) * x ** (2 * k + 1) for k in range(terms)))


def ebn0_from_symbol_errors(symerrors: int, nsymbols: int) -> float | None:
    """Eb/N0 estimate from the re-encode symbol error rate
    (icesync.c:392-402): esn0_amp = erfc^-1(2·SER), Eb/N0 = 2·esn0²."""
    if symerrors == 0:
        return None  # "> 10.5 dB" in the reference
    esn0 = inverse_erf(1 - 2.0 * symerrors / nsymbols)
    esn0 = esn0 * esn0
    return float(10 * np.log10(2 * esn0))
