"""symdemod stage model: windowed symbol-timing tracking over a stream.

The reference's main loop (symdemod.c:96-195) processes one `window`
seconds of baseband per iteration: full timing search, optional clock
hill-climb, then the real demodulation with gain = 100/sqrt(maxenergy).

Batched design: the whole loop is one jitted ``lax.scan`` over windows
— the prefix sum of the entire block is computed once, each window is
just a set of gathers at carry-dependent edges, and the carry is the
per-channel ``firstsample`` timing phase.  Clock tracking (-t) is a
host-driven variant (``symdemod_tracked``) because it mutates the static
samples-per-symbol value the edge tables are built from.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from isee3_decoder_tpu.ops import symbols as sym_ops
from isee3_decoder_tpu.ops.symbols import SymConfig


class SymWindowOut(NamedTuple):
    soft: jax.Array  # (B, nsymbols) uint8 soft decisions
    symphase: jax.Array  # (B,) timing adjustment chosen
    energy: jax.Array  # (B,) max mean energy per symbol
    firstsample: jax.Array  # (B,) absolute window start used


def initial_firstsample(cfg: SymConfig) -> int:
    """firstsample = Symbolsamples/2 (symdemod.c:94, int truncation)."""
    return int(cfg.symbolsamples / 2)


@functools.partial(jax.jit, static_argnames=("cfg", "nwindows"))
def symdemod_scan(
    samples: jax.Array,
    cfg: SymConfig,
    nwindows: int,
    firstsample0: jax.Array | int | None = None,
) -> tuple[jax.Array, SymWindowOut]:
    """Demodulate ``nwindows`` windows from (B, L) baseband samples.

    Returns (final_firstsample, outputs) with outputs stacked over the
    window axis: soft is (nwindows, B, nsymbols).

    The caller must provide enough samples: L >= firstsample0 +
    nwindows * window * samprate + a symbol of slack for the ± timing
    search (the streaming CLI driver handles buffering).
    """
    if samples.ndim == 1:
        samples = samples[None, :]
    nsym = cfg.nsymbols

    # The grouped timesearch reads a whole-stride span slightly past the
    # last edge; zero-pad the *samples* into the prefix sum (identical to
    # edge-padding csum, but fused into the cumsum pass) so the final
    # window never clamps its slice.
    span = sym_ops.timesearch_csum_span(
        cfg.halfclock, nsym, cfg.symbolclocks, cfg.noffsets
    )
    legacy = int(
        sym_ops.search_edges(cfg.halfclock, nsym, cfg.symbolclocks)[-1]
    ) + cfg.noffsets
    pad = max(span - legacy, 0) + 8
    csum = sym_ops.prefix_sum(samples, pad_to=samples.shape[1] + pad)
    return symdemod_scan_csum(csum, cfg, nwindows, firstsample0)


@functools.partial(jax.jit, static_argnames=("cfg", "nwindows"))
def symdemod_scan_csum(
    csum: jax.Array,
    cfg: SymConfig,
    nwindows: int,
    firstsample0: jax.Array | int | None = None,
) -> tuple[jax.Array, SymWindowOut]:
    """symdemod_scan against a precomputed (B, >=L) int32 exclusive
    prefix sum of the baseband.  The caller must guarantee every edge the
    last window reads lies strictly inside csum (symdemod_scan pads the
    samples for this)."""
    B = csum.shape[0]
    nsym = cfg.nsymbols
    if firstsample0 is None:
        firstsample0 = initial_firstsample(cfg)
    first = jnp.broadcast_to(jnp.asarray(firstsample0, jnp.int32), (B,))
    ffloat = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    def window_step(first, _):
        ts = sym_ops.timesearch_from_csum(
            csum, first, cfg.halfclock, nsym, cfg.symbolclocks, cfg.noffsets
        )
        first = first + ts.symphase
        integ = sym_ops.integrate_from_csum(
            csum, first, cfg.halfclock, nsym, cfg.symbolclocks
        )
        gain = 100.0 / jnp.sqrt(ts.maxenergy)  # symdemod.c:190 "Hack"
        soft, _ = sym_ops.finish_demod(integ, gain)
        out = SymWindowOut(
            soft=soft, symphase=ts.symphase, energy=ts.maxenergy, firstsample=first
        )
        # firstsample += nsymbols * Symbolsamples with C int truncation
        # of the sum (symdemod.c:192)
        first = jnp.trunc(
            first.astype(ffloat) + np.float64(nsym * cfg.symbolsamples).item()
        ).astype(jnp.int32)
        return first, out

    return jax.lax.scan(window_step, first, None, length=nwindows)


def window_samples(cfg: SymConfig) -> int:
    """Samples consumed per window."""
    return int(cfg.window * cfg.samprate)


def _track_channel(
    csum_row: jax.Array,
    cfg: SymConfig,
    nwindows: int,
) -> tuple[np.ndarray, list[dict]]:
    """One channel's clock-tracked demodulation (-t, symdemod.c:133-174).

    Hill-climbs (symbolsamples ± clock_incr, phase ± 1 sample) on mean
    demodulated energy until two consecutive no-improvements, updating the
    clock estimate across windows — the exact control flow of the
    reference's single-channel tracker.  Heavy math stays on device; the
    search control runs on host because symbolsamples parametrizes the
    edge tables.
    """
    import math

    symbolsamples = cfg.symbolsamples
    first = int(initial_firstsample(cfg))

    def energy_at(first_s, symsamp):
        nsym = int(cfg.window * cfg.samprate / symsamp)
        half = (0.5 / cfg.symbolclocks) * symsamp
        integ = sym_ops.integrate_from_csum(
            csum_row, jnp.asarray([first_s], jnp.int32), half, nsym, cfg.symbolclocks
        )
        return float((np.asarray(integ, np.float64) ** 2).mean())

    outs = []
    infos = []
    for w in range(nwindows):
        nsym = int(cfg.window * cfg.samprate / symbolsamples)
        half = (0.5 / cfg.symbolclocks) * symbolsamples
        # C offset range -trunc(s/2) .. ceil(s/2)-1 (symdemod.c:273,305)
        noff = int(symbolsamples / 2) + math.ceil(symbolsamples / 2)
        ts = sym_ops.timesearch_from_csum(
            csum_row,
            jnp.asarray([first], jnp.int32),
            half,
            nsym,
            cfg.symbolclocks,
            noff,
        )
        first = first + int(np.asarray(ts.symphase)[0])
        maxenergy = float(np.asarray(ts.maxenergy)[0])

        clock_incr = 0.5 * symbolsamples / (cfg.window * cfg.samprate)
        phase_incr = 1
        nochange = 0
        while nochange < 2:
            e = energy_at(first, symbolsamples + clock_incr)
            if e > maxenergy:
                maxenergy, symbolsamples, nochange = e, symbolsamples + clock_incr, 0
                continue
            e = energy_at(first, symbolsamples - clock_incr)
            if e > maxenergy:
                maxenergy, symbolsamples = e, symbolsamples - clock_incr
                clock_incr, nochange = -clock_incr, 0
                continue
            nochange += 1
            e = energy_at(first + phase_incr, symbolsamples)
            if e > maxenergy:
                maxenergy, first, nochange = e, first + phase_incr, 0
                continue
            e = energy_at(first - phase_incr, symbolsamples)
            if e > maxenergy:
                maxenergy, first = e, first - phase_incr
                phase_incr, nochange = -phase_incr, 0
                continue
            nochange += 1

        # C parity: nsymbols is recomputed AFTER the climb ("Update in
        # case Symrate has changed a lot, but defer until now" —
        # symdemod.c, end of the Clocktrack block), so the final demod
        # and the window advance use the post-climb clock's count.
        nsym = int(cfg.window * cfg.samprate / symbolsamples)
        half = (0.5 / cfg.symbolclocks) * symbolsamples
        integ = sym_ops.integrate_from_csum(
            csum_row, jnp.asarray([first], jnp.int32), half, nsym, cfg.symbolclocks
        )
        gain = 100.0 / np.sqrt(maxenergy)
        soft, _ = sym_ops.finish_demod(integ, jnp.asarray(gain))
        outs.append(np.asarray(soft)[0])
        infos.append(
            dict(
                window=w,
                symbolsamples=symbolsamples,
                symrate=cfg.samprate / symbolsamples,
                firstsample=first,
                energy=maxenergy,
            )
        )
        first = int(first + nsym * symbolsamples)
    return np.concatenate(outs), infos


def symdemod_tracked(
    samples: np.ndarray,
    cfg: SymConfig,
    nwindows: int,
    backend: str = "auto",
) -> tuple[np.ndarray, list[dict]]:
    """Clock-tracked demodulation (-t, symdemod.c:133-174).

    Each channel runs the reference's single-channel hill climb
    INDEPENDENTLY (its own symbolsamples / phase / maxenergy state), so a
    batch of channels with divergent clocks each converges like a lone
    reference run — a whole-batch accept test would let any one channel
    veto every other channel's step.

    backend: "auto" keeps the exact host tracker (golden byte-exact vs
    the compiled ``symdemod -t``) at B=1 and dispatches multi-channel
    batches to the device-batched quantized-grid tracker
    (models/symdemod_tracked.py — one device program per window for ALL
    channels instead of a ~B-fold host loop; measured 112x faster at
    B=3/CPU, and B-independent).  "host" / "batched" force a path.

    Returns (soft_symbols (B, total_symbols), per-window info dicts whose
    array-valued fields stack the channels).  Channels whose clocks
    diverge can emit different symbol counts per window; shorter rows are
    right-padded with 128 (zero soft confidence) to keep the batch
    rectangular.
    """
    samples = jnp.asarray(samples)
    if samples.ndim == 1:
        samples = samples[None, :]
    B = samples.shape[0]
    if backend == "batched" or (backend == "auto" and B > 1):
        from isee3_decoder_tpu.models.symdemod_tracked import (
            symdemod_tracked_batched,
        )

        return symdemod_tracked_batched(np.asarray(samples), cfg, nwindows)
    # slack for the grouped timesearch span (see symdemod_scan)
    csum = sym_ops.prefix_sum(
        samples,
        pad_to=samples.shape[1]
        + 16 * int(cfg.symbolsamples)
        + sym_ops.TRACK_DELTA
        + 576,
    )

    streams = []
    chan_infos = []
    for b in range(B):
        soft_b, infos_b = _track_channel(csum[b : b + 1], cfg, nwindows)
        streams.append(soft_b)
        chan_infos.append(infos_b)

    total = max(s.size for s in streams)
    out = np.full((B, total), 128, np.uint8)
    for b, s in enumerate(streams):
        out[b, : s.size] = s

    infos = []
    for w in range(nwindows):
        infos.append(
            dict(
                window=w,
                symbolsamples=np.array(
                    [chan_infos[b][w]["symbolsamples"] for b in range(B)]
                ),
                symrate=np.array([chan_infos[b][w]["symrate"] for b in range(B)]),
                firstsample=np.array(
                    [chan_infos[b][w]["firstsample"] for b in range(B)]
                ),
                energy=np.array([chan_infos[b][w]["energy"] for b in range(B)]),
            )
        )
    return out, infos
