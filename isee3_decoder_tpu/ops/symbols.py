"""Manchester symbol demodulation: timing search + integrate-and-dump.

Capability parity with the ``symdemod`` stage (symdemod.c:199-335): an
integrate-and-dump matched filter with fractional samples-per-symbol
(first half of each clock cycle negated, second half added), a full
symbol-phase search over ±half a symbol, and low-speed subcarrier modes
with N clocks of a 1024 Hz subcarrier per symbol.

Batched design: the reference integrates sample-by-sample with an
incremental per-offset update trick (symdemod.c:260-335, O(1) per offset).
Here a single prefix sum over the block turns every integration segment
into two gathers, so *all* symbols × *all* timing offsets evaluate as one
batched gather + reduction — flat, regular work.

Integer exactness: segment sums are differences of an int32 prefix sum.
Two's-complement wraparound in the cumsum cancels in the differences, so
results equal the reference's 64-bit accumulation as long as each
*segment* sum fits in int32 (a few hundred int16 samples — always true).

Rounding fidelity: ``trial_demod`` rounds *absolute* sample positions
(firstsample enters scount before nearbyint — symdemod.c:216-217), while
``timesearch`` rounds *relative* switchpoints and adds the offset
afterwards (symdemod.c:270-283).  These genuinely differ on exact-half
ties under round-to-nearest-even, so the two entry points here replicate
each behavior, and segment edges are generated by the same sequential
``scount += halfclock`` float accumulation as the C code (a multiplicative
``m * halfclock`` differs on round-half boundary cases).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from isee3_decoder_tpu.config import ACTUALCLOCK
from isee3_decoder_tpu.ops.reductions import argmax_first


@dataclasses.dataclass(frozen=True)
class SymConfig:
    """Static symdemod configuration (symdemod.c:50-94)."""

    samprate: float = 250_000.0
    symrate: float = ACTUALCLOCK  # measured spacecraft clock default
    symbolclocks: int = 1  # subcarrier clocks per symbol (-C)
    window: float = 1.0  # seconds per estimation window (-w)

    @property
    def symbolsamples(self) -> float:
        return self.samprate / self.symrate

    @property
    def halfclock(self) -> float:
        return (0.5 / self.symbolclocks) * self.symbolsamples

    @property
    def nsymbols(self) -> int:
        # nsymbols = window * Symrate, C int truncation (symdemod.c:93)
        return int(self.window * self.symrate)

    @property
    def noffsets(self) -> int:
        # Offsets -trunc(sym/2) .. ceil(sym/2)-1 (symdemod.c:273,305):
        # the C loop starts at (int)(-Symbolsamples/2) and runs while
        # offset < Symbolsamples/2, so an EVEN samples-per-symbol count
        # yields an even number of offsets (e.g. 32 → [-16, 15]), while a
        # fractional one yields the symmetric odd range (31.98 → [-15, 15]).
        import math

        s = self.symbolsamples
        return int(s / 2) + math.ceil(s / 2)


def prefix_sum(samples: jax.Array, pad_to: int | None = None) -> jax.Array:
    """(B, L) samples → (B, L+1) exclusive int32 prefix sum (wraparound in
    the int32 cumsum cancels in segment differences).

    Two-level: cumsum inside 2048-sample tiles plus an exclusive cumsum
    of tile totals — XLA's flat cumsum over a multi-megasample axis makes
    several full passes over device memory; the tiled form streams the
    data ~once.  Identical values
    (int32 addition is associative mod 2^32).

    ``pad_to`` (>= L) zero-extends the *samples* before summing, which is
    exactly an edge-extension of the prefix sum — callers that need
    trailing slack (the timesearch span) get it fused into the cumsum
    pass instead of paying a separate whole-array ``jnp.pad`` copy.
    """
    if samples.ndim == 1:
        samples = samples[None, :]
    B, L = samples.shape
    if pad_to is not None and pad_to > L:
        samples = jnp.pad(samples, ((0, 0), (0, pad_to - L)))
        L = pad_to
    x = samples.astype(jnp.int32)
    T = 2048
    if L < 4 * T:
        csum = jnp.cumsum(x, axis=-1)
        return jnp.concatenate([jnp.zeros((B, 1), jnp.int32), csum], axis=-1)
    nt = -(-L // T)
    xp = jnp.pad(x, ((0, 0), (0, nt * T - L))).reshape(B, nt, T)
    inner = jnp.cumsum(xp, axis=-1)
    tile_base = jnp.pad(jnp.cumsum(inner[:, :, -1], axis=-1)[:, :-1], ((0, 0), (1, 0)))
    csum = (inner + tile_base[:, :, None]).reshape(B, nt * T)[:, :L]
    return jnp.concatenate([jnp.zeros((B, 1), jnp.int32), csum], axis=-1)


def trial_edges(halfclock: float, nsymbols: int, symbolclocks: int) -> np.ndarray:
    """Float segment edges relative to firstsample for trial_demod-style
    absolute rounding; edge 0 is exactly 0."""
    nseg = 2 * symbolclocks * nsymbols
    return np.concatenate([[0.0], np.cumsum(np.full(nseg, halfclock))])


def search_edges(halfclock: float, nsymbols: int, symbolclocks: int) -> np.ndarray:
    """Integer switchpoints for timesearch-style relative rounding."""
    nseg = 2 * symbolclocks * nsymbols
    rel = np.rint(np.cumsum(np.full(nseg, halfclock))).astype(np.int64)
    return np.concatenate([[0], rel])


def integrate_from_csum(
    csum: jax.Array,
    firstsample: jax.Array,
    halfclock: float,
    nsymbols: int,
    symbolclocks: int,
) -> jax.Array:
    """(B, nsymbols) int32 integrators from a precomputed prefix sum,
    with trial_demod's absolute edge rounding.

    nearbyint(firstsample + rel) is evaluated EXACTLY in integers: the
    float64 edge table splits (host-side) into floor + {<.5, >.5, ==.5}
    classes, and half-to-even ties resolve from the runtime parity of
    firstsample + floor(rel).  Summing in device float32 instead loses
    edge precision once firstsample grows (wrong edges from ~2^23
    samples, i.e. half a minute at 250 ksps).

    Deliberately an elementwise gather: the edge table is only
    2·c·nsymbols+1 ≈ 2k entries per channel, so the gather is tiny.  A
    gather-free variant (parity-static edge tables + per-channel
    dynamic_slice base, mirroring the timesearch trick) reads more: the
    base slice materializes ~the whole window per
    channel (~256 MB traffic at 128 ch) and both parity tables must be
    evaluated, whereas the gather it replaces reads only the 2k edges.
    The timesearch won from that trick because its gather was ~245×
    larger (offsets × symbols)."""
    B = csum.shape[0]
    firstsample = jnp.broadcast_to(jnp.asarray(firstsample, jnp.int32), (B,))
    rel = trial_edges(halfclock, nsymbols, symbolclocks)  # float64, exact
    flo = np.floor(rel)
    frac = rel - flo
    flo_d = jnp.asarray(flo.astype(np.int32))
    up_d = jnp.asarray((frac > 0.5).astype(np.int32))
    tie_d = jnp.asarray((frac == 0.5).astype(np.int32))
    base = firstsample[:, None] + flo_d[None, :]
    abs_edges = base + up_d[None, :] + tie_d[None, :] * (base & 1)
    g = jnp.take_along_axis(csum, abs_edges, axis=-1)
    seg = (g[:, 1:] - g[:, :-1]).reshape(B, nsymbols, symbolclocks, 2)
    # dtype pinned to csum's: under x64 a plain .sum() would promote
    # int32 → int64 and change the result dtype seen by callers
    return (seg[..., 1] - seg[..., 0]).sum(axis=-1, dtype=csum.dtype)


def _framing_plan(rel: np.ndarray, noffsets: int) -> dict | None:
    """Gather-free framing plan for the timesearch offset sweep.

    Key observation: with frames of the prefix sum taken at a regular
    integer stride ``s ≈ k·halfclock``, edge ``j = k·m + r`` lands at
    in-frame offset ``d_j = rel_j − s·m``, and ``d`` changes slowly
    (the fractional drift of the symbol clock) — so runs of equal ``d``
    become a handful of *static contiguous block slices*, eliminating
    the 16M-element gather that would dominate symdemod.

    Returns None when no small ``k`` keeps the slice count and frame
    blow-up manageable (e.g. huge-offset subcarrier modes) — callers
    fall back to the elementwise gather path.
    """
    rel = np.asarray(rel, np.int64)
    nedges = rel.size
    if nedges < 3:
        return None
    for k in (1, 2, 4, 8):
        # floor stride keeps every in-frame offset d >= 0, so the frame
        # base never reads below firstsample - noffsets//2 (no clamping
        # hazards in the per-channel dynamic slice)
        s = max(int(float(rel[-1] - rel[0]) * k / (nedges - 1)), 1)
        nframes = -(-nedges // k)
        runs_all = []
        pieces = 0
        dmin, dmax = None, None
        for r in range(k):
            idx = np.arange(r, nedges, k)
            d = rel[idx] - s * np.arange(idx.size)
            lo, hi = int(d.min()), int(d.max())
            dmin = lo if dmin is None else min(dmin, lo)
            dmax = hi if dmax is None else max(dmax, hi)
            bounds = np.flatnonzero(np.diff(d)) + 1
            runs = [
                (int(a), int(b), int(d[a]))
                for a, b in zip(
                    np.concatenate([[0], bounds]),
                    np.concatenate([bounds, [d.size]]),
                )
            ]
            pieces += len(runs)
            runs_all.append(runs)
        framelen = dmax - dmin + noffsets
        if dmin >= 0 and pieces <= 1024 and framelen <= 8 * s:
            return dict(
                k=k, s=s, dmin=dmin, framelen=framelen,
                nframes=nframes, runs=runs_all,
            )
    return None


def _integrator_weights(symbolclocks: int) -> list[int]:
    """Edge weights of one symbol's integrator: I(m) = Σ_j w_j·csum[e_j]
    with e_j the symbol's 2·symbolclocks+1 edges (negate first half-cycle,
    add second — symdemod.c:226-235 telescoped against the prefix sum)."""
    # I = Σ_q (g[2q] - 2 g[2q+1] + g[2q+2]); interior even edges get +2
    return [1] + [-2, 2] * (symbolclocks - 1) + [-2, 1]


def _symbol_group_plan(
    rel: np.ndarray, noffsets: int, symbolclocks: int
) -> list[dict] | None:
    """Group symbols into maximal runs with identical local edge offsets.

    Edge j of symbol m sits at rel[2c·m + j].  Within a run of symbols
    whose anchor stride S = rel[2c(m+1)] - rel[2c·m] and local offsets
    c_j = rel[2c·m + j] - rel[2c·m] are all constant, the whole offset
    sweep evaluates from *static* slices of the csum window — the edge
    table's fractional drift only changes groups ~rel[-1]·frac times, so
    a 1-second window yields a few hundred groups instead of a
    2049×245-element gather or frame expansion.
    """
    c2 = 2 * symbolclocks
    nsym = (rel.size - 1) // c2
    if nsym < 1:
        return None
    anchors = rel[: nsym * c2 + 1 : c2]  # (nsym+1,) includes final edge
    groups = []
    m = 0
    while m < nsym:
        a = int(anchors[m])
        cj = tuple(int(rel[c2 * m + j] - a) for j in range(c2 + 1))
        s = int(anchors[m + 1] - anchors[m])
        m1 = m + 1
        while m1 < nsym:
            a1 = int(anchors[m1])
            if int(anchors[m1 + 1]) - a1 != s:
                break
            if tuple(int(rel[c2 * m1 + j] - a1) for j in range(c2 + 1)) != cj:
                break
            m1 += 1
        groups.append(dict(m0=m, m1=m1, anchor=a, stride=s, cj=cj))
        m = m1
    if len(groups) > 768 or any(g["stride"] <= 0 for g in groups):
        return None
    return groups


# Headroom on the widened offset axis for per-channel start spread: the
# channel-shared base slice plus this many extra evaluated offsets lets
# every channel extract its own ±half sweep without a per-channel
# dynamic slice (a vmap'ed dynamic_slice is a gather; the widened
# evaluation fuses into the same pass).
TRACK_DELTA = 384


def _grouped_span(groups, rel_np, nsymbols, symbolclocks, W: int) -> int:
    """csum span the grouped evaluation reads for a W-wide offset axis."""
    span = int(rel_np[2 * symbolclocks * nsymbols]) + W
    for g in groups:
        s = g["stride"]
        ni = g["m1"] - g["m0"]
        ncover = -(-(g["cj"][-1] + W) // s)
        span = max(span, g["anchor"] + s * (ni + ncover))
    return span


def _grouped_esum(base, W, nsymbols, symbolclocks, groups):
    """(B, span) base → (B, W) summed squared integrators, evaluating
    every group through static slices of base (see _symbol_group_plan).
    Offset o's integrator for symbol m reads base[s·i + c_j + o] — the
    whole weighted sum, square, and symbol reduction fuse into one pass
    over base (no window buffer in device memory)."""
    B = base.shape[0]
    ffloat = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    w = _integrator_weights(symbolclocks)
    esum = jnp.zeros((B, W), ffloat)
    for g in groups:
        s, ni, a = g["stride"], g["m1"] - g["m0"], g["anchor"]
        ncover = -(-(g["cj"][-1] + W) // s)
        r = base[:, a : a + s * (ni + ncover)].reshape(B, ni + ncover, s)
        # r[b, i+p, x] = base[b, a + s*i + p*s + x]: every edge-j read at
        # sweep offset o is r[:, i + (c_j+o)//s, (c_j+o)%s].  Cutting the
        # o axis wherever any (c_j+o) crosses a row boundary makes each
        # piece a pure static-slice expression.
        cuts = {0, W}
        for cjj in g["cj"]:
            first_cut = (-cjj) % s
            cuts.update(range(first_cut or s, W, s))
        bounds = sorted(cuts)
        pieces = []
        for o0, o1 in zip(bounds[:-1], bounds[1:]):
            wdt = o1 - o0
            d = None
            for wj, cjj in zip(w, g["cj"]):
                p, col = divmod(cjj + o0, s)
                t = wj * r[:, p : p + ni, col : col + wdt]
                d = t if d is None else d + t
            pieces.append((d.astype(ffloat) ** 2).sum(axis=1))
        esum = esum + jnp.concatenate(pieces, axis=-1)
    return esum


def _esum_gather(csum, firstsample, rel_np, nsymbols, symbolclocks, noffsets):
    """Elementwise-gather offset sweep → (B, noffsets) summed squared
    integrators.  General fallback: no structure assumed."""
    B = csum.shape[0]
    half = noffsets // 2
    ffloat = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    offsets = jnp.arange(-half, noffsets - half, dtype=jnp.int32)
    rel = jnp.asarray(rel_np, jnp.int32)
    abs_edges = (
        firstsample[:, None, None] + offsets[None, :, None] + rel[None, None, :]
    )
    g = jnp.take_along_axis(csum, abs_edges.reshape(B, -1), axis=-1).reshape(
        abs_edges.shape
    )
    seg = (g[..., 1:] - g[..., :-1]).reshape(
        B, noffsets, nsymbols, symbolclocks, 2
    )
    integ = (seg[..., 1] - seg[..., 0]).sum(axis=-1)
    return (integ.astype(ffloat) ** 2).sum(axis=-1)


def _timesearch_grouped(
    csum, firstsample, rel_np, nsymbols, symbolclocks, noffsets, groups
):
    """Offset-sweep energies via static slices of ONE channel-shared base
    slice: all channels' sweeps evaluate on a widened offset axis
    anchored at min(firstsample), and each channel extracts its own
    noffsets-wide sub-range.

    When the per-channel spread exceeds TRACK_DELTA (channels with
    genuinely dispersed timing), falls to a per-channel-base grouped
    evaluation — one dynamic slice per channel, same static group
    slices, ~2x the shared-base cost — rather than all the way to the
    elementwise gather (~35x at bench shapes).  The gather remains only
    for starts that would clamp (stream edges) or under-padded csum.

    Returns (B, noffsets) summed squared integrators (not yet /nsymbols).
    Reads the same csum entries as the gather path — energies agree to
    f32 summation order (grouped accumulates per group).
    """
    B = csum.shape[0]
    half = noffsets // 2
    W = noffsets + TRACK_DELTA
    span_w = _grouped_span(groups, rel_np, nsymbols, symbolclocks, W)
    limit = csum.shape[1] - span_w
    span_pc = _grouped_span(groups, rel_np, nsymbols, symbolclocks, noffsets)
    limit_pc = csum.shape[1] - span_pc

    def slow(c):
        return _esum_gather(
            c, firstsample, rel_np, nsymbols, symbolclocks, noffsets
        )

    if limit_pc < 0:  # under-padded even for per-channel spans
        return slow(csum)

    starts_pc = firstsample - half
    ok_pc = jnp.all((starts_pc >= 0) & (starts_pc <= limit_pc))

    def per_channel(c):
        st = jnp.clip(starts_pc, 0, limit_pc)
        base = jax.vmap(
            lambda v, s: jax.lax.dynamic_slice(v, (s,), (span_pc,))
        )(c, st)
        return _grouped_esum(base, noffsets, nsymbols, symbolclocks, groups)

    def mid(c):
        return jax.lax.cond(ok_pc, per_channel, slow, c)

    if limit < 0:  # widened shared-base reads would clamp; skip that tier
        return mid(csum)

    s0 = jnp.clip(jnp.min(firstsample) - half, 0, limit)
    delta = firstsample - half - s0
    ok = jnp.all((delta >= 0) & (delta <= TRACK_DELTA))

    def fast(c):
        base = jax.lax.dynamic_slice(
            c, (jnp.zeros((), jnp.int32), s0), (B, span_w)
        )
        esum_w = _grouped_esum(base, W, nsymbols, symbolclocks, groups)
        idx = delta[:, None] + jnp.arange(noffsets, dtype=jnp.int32)[None, :]
        return jnp.take_along_axis(esum_w, idx, axis=-1)

    return jax.lax.cond(ok, fast, mid, csum)


def timesearch_csum_span(
    halfclock: float, nsymbols: int, symbolclocks: int, noffsets: int
) -> int:
    """csum entries timesearch may read past (firstsample - noffsets//2).

    The grouped/framed fast paths read a whole-stride span (slightly
    beyond the last edge); callers that stream should pad csum to this
    span.
    """
    rel = search_edges(halfclock, nsymbols, symbolclocks)
    span = int(rel[-1]) + noffsets
    groups = _symbol_group_plan(rel, noffsets, symbolclocks)
    if groups is not None:
        return _grouped_span(
            groups, rel, nsymbols, symbolclocks, noffsets + TRACK_DELTA
        )
    plan = _framing_plan(rel, noffsets)
    if plan is None:
        return span
    ncopies = -(-plan["framelen"] // plan["s"])
    return plan["s"] * (plan["nframes"] + ncopies)


def _timesearch_framed(
    csum, firstsample, rel_np, nsymbols, symbolclocks, noffsets, plan
):
    """Offset-sweep integrators via static block slices (see
    _framing_plan).  Bit-identical g values to the gather path: the
    same csum entries are read, just addressed through regular-stride
    frames."""
    B = csum.shape[0]
    half = noffsets // 2
    k, s = plan["k"], plan["s"]
    dmin, framelen, nframes = plan["dmin"], plan["framelen"], plan["nframes"]
    nedges = rel_np.size

    ncopies = -(-framelen // s)
    nchunks = nframes + ncopies
    span = s * nchunks

    # Degenerate-short inputs (fewer samples than one frame span) are
    # edge-padded; the clamp mirrors gather clamping for callers that
    # under-provision slack (contract: provide enough samples).
    if csum.shape[1] < span + 1:
        csum = jnp.pad(
            csum, ((0, 0), (0, span + 1 - csum.shape[1])), mode="edge"
        )
    start = jnp.clip(firstsample - half + dmin, 0, csum.shape[1] - span)

    def slice_chan(v, st):
        return jax.lax.dynamic_slice(v, (st,), (span,))

    base = jax.vmap(slice_chan)(csum, start)
    chunks = base.reshape(B, nchunks, s)
    frames = jnp.concatenate(
        [chunks[:, i : i + nframes, :] for i in range(ncopies)], axis=2
    )  # (B, nframes, ncopies*s) — overlapping stride-s frames

    per_r = []
    for r in range(k):
        pieces = [
            frames[:, a:b, dd - dmin : dd - dmin + noffsets]
            for (a, b, dd) in plan["runs"][r]
        ]
        gr = jnp.concatenate(pieces, axis=1) if len(pieces) > 1 else pieces[0]
        if gr.shape[1] < nframes:  # padded below; values are trimmed away
            gr = jnp.concatenate(
                [gr, jnp.zeros((B, nframes - gr.shape[1], noffsets), gr.dtype)],
                axis=1,
            )
        per_r.append(gr)
    g = jnp.stack(per_r, axis=2).reshape(B, nframes * k, noffsets)[:, :nedges]

    seg = (g[:, 1:, :] - g[:, :-1, :]).reshape(
        B, nsymbols, symbolclocks, 2, noffsets
    )
    return (seg[:, :, :, 1] - seg[:, :, :, 0]).sum(axis=2)  # (B, nsym, noff)


def timesearch_from_csum(
    csum: jax.Array,
    firstsample: jax.Array,
    halfclock: float,
    nsymbols: int,
    symbolclocks: int,
    noffsets: int,
) -> "TimeSearchResult":
    """timesearch body against a precomputed prefix sum.

    Uses the gather-free symbol-grouped formulation when the edge table
    admits one (all practical modes), else the framed expansion, else
    the elementwise gather.  All read identical csum entries — energies
    agree to f32 summation order (grouped accumulates per group).
    """
    B = csum.shape[0]
    half = noffsets // 2
    offsets = jnp.arange(-half, noffsets - half, dtype=jnp.int32)
    firstsample = jnp.broadcast_to(jnp.asarray(firstsample, jnp.int32), (B,))
    rel_np = search_edges(halfclock, nsymbols, symbolclocks)
    ffloat = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    groups = _symbol_group_plan(rel_np, noffsets, symbolclocks)
    if groups is not None:
        esum = _timesearch_grouped(
            csum, firstsample, rel_np, nsymbols, symbolclocks, noffsets,
            groups,
        )
        energy = esum / nsymbols
        best = argmax_first(energy, axis=-1)
        return TimeSearchResult(
            symphase=offsets[best],
            maxenergy=jnp.take_along_axis(energy, best[:, None], axis=-1)[:, 0],
        )

    plan = _framing_plan(rel_np, noffsets)
    if plan is not None:
        integ = _timesearch_framed(
            csum, firstsample, rel_np, nsymbols, symbolclocks, noffsets, plan
        )
        energy = (integ.astype(ffloat) ** 2).mean(axis=1)  # (B, noff)
    else:
        energy = (
            _esum_gather(
                csum, firstsample, rel_np, nsymbols, symbolclocks, noffsets
            )
            / nsymbols
        )

    best = argmax_first(energy, axis=-1)  # strict '>' keeps the earliest
    return TimeSearchResult(
        symphase=offsets[best],
        maxenergy=jnp.take_along_axis(energy, best[:, None], axis=-1)[:, 0],
    )


class DemodResult(NamedTuple):
    soft: jax.Array  # (B, nsymbols) uint8 offset-128 soft decisions
    integrators: jax.Array  # (B, nsymbols) int32 raw integrator values
    energy: jax.Array  # (B,) mean energy per symbol


@functools.partial(
    jax.jit, static_argnames=("halfclock", "nsymbols", "symbolclocks")
)
def integrate_symbols(
    samples: jax.Array,
    firstsample: jax.Array,
    halfclock: float,
    nsymbols: int,
    symbolclocks: int,
    gain: jax.Array | float = 0.0,
) -> DemodResult:
    """Manchester integrate-and-dump at one timing hypothesis
    (trial_demod, symdemod.c:202-256).

    Segment edges are nearbyint(firstsample + m*halfclock) — the absolute
    rounding of the reference's trial_demod.

    Args:
      samples: (B, L) int16/int32 baseband samples.
      firstsample: (B,) or scalar int32 index of the start of symbol 0.
      halfclock: static samples per half clock cycle.
      gain: scale for the 8-bit output; 0 means energy-only trial.
    """
    csum = prefix_sum(samples)
    integ = integrate_from_csum(csum, firstsample, halfclock, nsymbols, symbolclocks)
    soft, energy = finish_demod(integ, gain)
    return DemodResult(soft=soft, integrators=integ, energy=energy)


def finish_demod(integ: jax.Array, gain: jax.Array | float) -> tuple[jax.Array, jax.Array]:
    """Scale integrators into offset-128 uint8 soft decisions and compute
    mean per-symbol energy (symdemod.c:240-255)."""
    ffloat = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    energy = (integ.astype(ffloat) ** 2).mean(axis=-1)
    gain = jnp.asarray(gain)
    if gain.ndim == 1:
        gain = gain[:, None]
    scaled = gain * integ.astype(ffloat) + 128.0
    soft = jnp.clip(scaled, 0.0, 255.0).astype(jnp.uint8)  # C cast truncation
    return soft, energy


class TimeSearchResult(NamedTuple):
    symphase: jax.Array  # (B,) best timing offset in samples
    maxenergy: jax.Array  # (B,) mean energy per symbol at that offset


@functools.partial(
    jax.jit,
    static_argnames=("halfclock", "nsymbols", "symbolclocks", "noffsets"),
)
def timesearch(
    samples: jax.Array,
    firstsample: jax.Array,
    halfclock: float,
    nsymbols: int,
    symbolclocks: int,
    noffsets: int,
) -> TimeSearchResult:
    """Full symbol-phase search over ±half a symbol
    (timesearch, symdemod.c:260-335).

    Edges are firstsample + offset + nearbyint(m*halfclock) — the
    *relative* rounding of the reference's timesearch.  A strict '>'
    energy comparison keeps the earliest maximal offset
    (symdemod.c:328-332).
    """
    span = timesearch_csum_span(halfclock, nsymbols, symbolclocks, noffsets)
    legacy = int(search_edges(halfclock, nsymbols, symbolclocks)[-1]) + noffsets
    pad = max(span - legacy, 0) + 8
    if samples.ndim == 1:
        samples = samples[None, :]
    csum = prefix_sum(samples, pad_to=samples.shape[1] + pad)
    return timesearch_from_csum(
        csum, firstsample, halfclock, nsymbols, symbolclocks, noffsets
    )
