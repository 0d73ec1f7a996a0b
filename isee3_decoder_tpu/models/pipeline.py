"""Full receive chain: pmdemod → symdemod → decode.

The reference composes its stages as a UNIX pipeline of byte streams
(README.txt:9).  Here the stages compose as typed array functions over a
``(channels, time)`` batch: a jitted device path produces soft symbols
from raw IQ, and the frame decoder walks them with the hybrid
Fano/Viterbi policy.  Channel parallelism comes from the leading batch
axis (shard it with parallel/sharding.py); time parallelism from the
block/window scans.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from isee3_decoder_tpu.models.decode import (
    DecodeConfig,
    DecodeStreamState,
    FrameRecord,
    decode_block_device,
    decode_stream,
    fano_tier2_inplace,
    unpack_block_buffer,
    viterbi_fallback_inplace,
)
from isee3_decoder_tpu.models.symdemod import (
    initial_firstsample,
    symdemod_scan,
    window_samples,
)
from isee3_decoder_tpu.ops.carrier import PMConfig, init_carry, pm_demod_scan
from isee3_decoder_tpu.ops.symbols import SymConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    pm: PMConfig = PMConfig()
    sym: SymConfig = SymConfig()
    decode: DecodeConfig = DecodeConfig()


class PipelineResult(NamedTuple):
    frames: list[FrameRecord]
    soft_symbols: np.ndarray  # (B, S)
    baseband: np.ndarray  # (B, L) int16
    carrier_freq: np.ndarray  # (T, B)
    cn0: np.ndarray  # (T, B)


def demod_to_symbols(
    iq: jax.Array, cfg: PipelineConfig
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Jitted device path: (B, L) complex IQ — or (B, 2L) raw int16
    interleaved I,Q pairs, the reference's recording format
    (pmdemod.c:206-230) — → (B, S) soft symbols.

    Carves the stream into FFT blocks for pmdemod and 1-second windows
    for symdemod; trailing partial blocks are dropped exactly as the
    reference's fread loops do (pmdemod.c:210-215, symdemod.c:124-125).
    Raw int16 input reads half the device-memory bytes of complex64.
    """
    if iq.ndim == 1:
        iq = iq[None, :]
    B = iq.shape[0]
    n = cfg.pm.fftsize
    if jnp.issubdtype(iq.dtype, jnp.complexfloating):
        L = iq.shape[1]
        nblocks = L // n
        blocks = iq[:, : nblocks * n].reshape(B, nblocks, n)
    else:  # interleaved int16 I,Q — one block is 2n values
        L = iq.shape[1] // 2
        nblocks = L // n
        blocks = iq[:, : nblocks * 2 * n].reshape(B, nblocks, 2 * n)

    wlen = window_samples(cfg.sym)
    first0 = initial_firstsample(cfg.sym)
    # one window of slack for the ± timing search and drift
    nwindows = max((nblocks * n - first0) // wlen - 1, 0)

    carry = init_carry(B, cfg.pm)
    carry, pm_out = pm_demod_scan(carry, blocks, cfg.pm)
    baseband = jnp.swapaxes(pm_out.baseband, 0, 1).reshape(B, nblocks * n)

    _, sym_out = symdemod_scan(baseband, cfg.sym, nwindows)
    soft = jnp.swapaxes(sym_out.soft, 0, 1).reshape(B, -1)
    return soft, baseband, pm_out.carrier_freq, pm_out.cn0


def run_wideband(
    iq_wide: np.ndarray,
    samprate: float,
    nchan: int,
    channels: list[int] | None = None,
    cfg: PipelineConfig | None = None,
    taps_per_branch: int = 8,
) -> PipelineResult:
    """Wideband capture → channelize → per-channel receive chain.

    Args:
      iq_wide: (L,) complex wideband samples at ``samprate``.
      nchan: polyphase channel count (per-channel rate samprate/nchan).
      channels: channel indices to demodulate (default: all).
      cfg: pipeline config for the *channel* rate; defaults to the
        standard 512 bps config at samprate/nchan.
    """
    import jax.numpy as jnp

    from isee3_decoder_tpu.ops.channelizer import channelize

    fs_out = samprate / nchan
    if cfg is None:
        cfg = PipelineConfig(
            pm=PMConfig(samprate=fs_out, binsize=4.0, search_width=200.0),
            sym=SymConfig(samprate=fs_out),
        )
    y = channelize(jnp.asarray(iq_wide), nchan, taps_per_branch)[0]
    if channels is not None:
        y = y[jnp.asarray(channels)]
    return run_pipeline(np.asarray(y), cfg)


@functools.partial(jax.jit, static_argnames=("nframes", "npos", "cfg"))
def receive_block_device(
    iq: jax.Array,
    nframes: int,
    npos: int,
    cfg: PipelineConfig = PipelineConfig(),
) -> jax.Array:
    """The ENTIRE receive chain as one device program: PM carrier demod →
    symbol demod → sync search → quicklook/Fano frame decode → packed
    result buffer (decode.decode_block_device layout).

    This is the one-program form of the reference's three-process pipe
    chain (README.txt:9): the byte streams become device-resident arrays
    flowing between fused stages, with one dispatch and one small fetch
    per block of channels×seconds.
    """
    soft, _, _, _ = demod_to_symbols(iq, cfg)
    return decode_block_device(soft, nframes, npos, cfg.decode)


@functools.partial(jax.jit, static_argnames=("nframes", "npos", "cfg"))
def receive_block_device_soft(
    iq: jax.Array,
    nframes: int,
    npos: int,
    cfg: PipelineConfig = PipelineConfig(),
) -> tuple[jax.Array, jax.Array]:
    """receive_block_device plus the (device-resident) soft symbols.

    Same single fused program — the soft stream is computed anyway; the
    extra output is one small device write and NO extra fetch.  The host
    wrappers keep it on device so the (rare) tier-2 Fano / Viterbi
    fallback can gather just the failed lanes' frame windows instead of
    re-running the whole demod (which used to double the block cost
    whenever any lane timed out at tier 1)."""
    soft, _, _, _ = demod_to_symbols(iq, cfg)
    return decode_block_device(soft, nframes, npos, cfg.decode), soft


def _finish_block(
    buf_dev, soft_dev, B: int, nframes: int, cfg: PipelineConfig
) -> tuple[FrameRecord, np.ndarray]:
    """Fetch a packed decode buffer and run the (rare) host-driven
    tier-2 Fano re-run + Viterbi fallback on failed lanes — the shared
    tail of every fused-chain host wrapper."""
    from isee3_decoder_tpu.config import FRAMESYMBOLS, SYNCBITS

    buf = np.asarray(buf_dev)
    data, good, decoder, ok, cycles, ss = unpack_block_buffer(buf, B, nframes)
    starts = ss[:, None] + SYNCBITS + FRAMESYMBOLS * np.arange(nframes)[None, :]
    if (~ok).any():
        fano_tier2_inplace(
            data, good, decoder, ok, cycles, starts, soft_dev, nframes,
            cfg.decode,
        )
        viterbi_fallback_inplace(
            data, good, decoder, ok, starts, soft_dev, nframes, cfg.decode
        )
    rec = FrameRecord(
        data=data,
        good=good,
        decoder=decoder,
        start_symbol=starts.reshape(-1),
        fano_cycles=cycles,
    )
    return rec, ss


def receive_block(
    iq,
    nframes: int,
    cfg: PipelineConfig = PipelineConfig(),
    npos: int | None = None,
) -> tuple[FrameRecord, np.ndarray]:
    """Host wrapper for the fused receive chain: one dispatch + one
    fetch; host-driven tier-2 Fano and Viterbi fallback only if a lane
    fails the device tiers (the soft symbols stay device-resident).

    Returns (FrameRecord with batch axis B*nframes, sync_start (B,)).
    """
    from isee3_decoder_tpu.config import FRAMESYMBOLS

    iq = jnp.asarray(iq)
    if iq.ndim == 1:
        iq = iq[None, :]
    B = iq.shape[0]
    if npos is None:
        npos = FRAMESYMBOLS
    buf_dev, soft_dev = receive_block_device_soft(iq, nframes, npos, cfg)
    return _finish_block(buf_dev, soft_dev, B, nframes, cfg)


@functools.partial(
    jax.jit,
    static_argnames=("nchan", "nframes", "npos", "cfg", "taps_per_branch"),
)
def receive_wideband_device_soft(
    wide: jax.Array,
    nchan: int,
    nframes: int,
    npos: int,
    cfg: PipelineConfig = PipelineConfig(),
    taps_per_branch: int = 8,
) -> tuple[jax.Array, jax.Array]:
    """ONE wideband capture → polyphase channelizer → the full fused
    per-channel receive chain, as a single jitted device program.

    Args:
      wide: the capture at rate M*samprate, as wideband_to_raw takes it.
      nchan: polyphase channel count M; per-channel rate = cfg.pm.samprate.

    Returns (packed decode buffer — decode_block_device layout for
    B=nchan — and the device-resident (nchan, S) soft symbols)."""
    raw = wideband_to_raw(wide, nchan, taps_per_branch)
    soft, _, _, _ = demod_to_symbols(raw, cfg)
    return decode_block_device(soft, nframes, npos, cfg.decode), soft


def wideband_to_raw(
    wide: jax.Array, nchan: int, taps_per_branch: int = 8
) -> jax.Array:
    """Wideband capture → (nchan, 2*nout) int16 interleaved I,Q per
    channel, the per-channel chain's recording format.

    ``wide`` is (M*L,) int32 PACKED IQ (I in bits 0..15, Q in bits
    16..31 of each word — byte-identical to the little-endian
    interleaved int16 recording), (2*M*L,) int16 interleaved I,Q, or
    (M*L,) complex64.  Channel outputs are truncated and clipped to
    int16 like a recording."""
    from isee3_decoder_tpu.ops.channelizer import channelize

    if wide.dtype == jnp.int32:
        i_part = ((wide << 16) >> 16).astype(jnp.float32)  # sign-extend
        q_part = (wide >> 16).astype(jnp.float32)
        wide = (i_part + 1j * q_part).astype(jnp.complex64)
    elif not jnp.issubdtype(wide.dtype, jnp.complexfloating):
        n = wide.shape[0] - wide.shape[0] % 2
        w = wide[:n].reshape(-1, 2).astype(jnp.float32)
        wide = (w[:, 0] + 1j * w[:, 1]).astype(jnp.complex64)
    chans = channelize(wide, nchan, taps_per_branch)[0]  # (M, nout)
    ri = jnp.stack([chans.real, chans.imag], axis=-1).reshape(nchan, -1)
    return jnp.trunc(jnp.clip(ri, -32767.0, 32767.0)).astype(jnp.int16)


def receive_block_wideband(
    wide,
    nchan: int,
    nframes: int,
    cfg: PipelineConfig = PipelineConfig(),
    npos: int | None = None,
    taps_per_branch: int = 8,
) -> tuple[FrameRecord, np.ndarray]:
    """Host wrapper for the wideband fused chain: one dispatch + one
    fetch + the shared host fallback tail (see receive_block)."""
    from isee3_decoder_tpu.config import FRAMESYMBOLS

    wide = jnp.asarray(wide)
    if npos is None:
        npos = FRAMESYMBOLS
    buf_dev, soft_dev = receive_wideband_device_soft(
        wide, nchan, nframes, npos, cfg, taps_per_branch
    )
    return _finish_block(buf_dev, soft_dev, nchan, nframes, cfg)


def receive_blocks_pipelined(
    iq_blocks,
    nframes: int,
    cfg: PipelineConfig = PipelineConfig(),
    npos: int | None = None,
    depth: int = 2,
):
    """Pipelined receive chain driver.

    Generator over an iterable of (B, L) IQ blocks.  Up to ``depth``
    blocks' fused device programs are DISPATCHED (async) ahead of the
    oldest block's packed-result fetch, so the host↔device round trip of
    one block and the host loop overlap the device compute of the
    following ones.

    Memory cost of depth: each unit of depth keeps one block's raw IQ
    AND its device-resident soft stream (plus the packed result buffer)
    resident at once.  When scaling the channel count, lower depth
    before lowering the block length.

    Yields (FrameRecord, sync_start) per block, in order.
    """
    from collections import deque

    from isee3_decoder_tpu.config import FRAMESYMBOLS, SYNCBITS

    if npos is None:
        npos = FRAMESYMBOLS

    def finish(buf_dev, soft_dev, B):
        return _finish_block(buf_dev, soft_dev, B, nframes, cfg)

    pending: deque = deque()
    for iq in iq_blocks:
        iq = jnp.asarray(iq)
        if iq.ndim == 1:
            iq = iq[None, :]
        # async dispatch; soft stays device-resident for the fallback tiers
        buf, soft = receive_block_device_soft(iq, nframes, npos, cfg)
        # start the D2H as soon as the program completes — it overlaps
        # the younger blocks' compute; finish()'s np.asarray then just
        # waits on the transfer
        if hasattr(buf, "copy_to_host_async"):
            buf.copy_to_host_async()
        pending.append((buf, soft, iq.shape[0]))
        if len(pending) > max(depth, 1):
            yield finish(*pending.popleft())
    while pending:
        yield finish(*pending.popleft())


class ChainCarry(NamedTuple):
    """Explicit cross-call carry for the streaming receive chain — the
    process-memory state of the reference's three while(1) loops
    (pmdemod.c:204, symdemod.c:96, decode.c:149) as one serializable
    pytree-of-arrays (SURVEY.md §5.4: this IS the checkpoint story).

    All host-side ndarrays/ints except ``pm`` (the jitted pm scan carry).
    """

    pm: object  # PMCarry pytree (carrier freq, lock, LO state)
    iq_rem: np.ndarray  # (B, r) unconsumed trailing IQ values (< 1 block)
    bb: np.ndarray  # (B, l) int16 residual baseband window
    bb_base: int  # absolute sample index of bb[:, 0]
    bb_total: int  # total baseband samples produced so far
    first: np.ndarray  # (B,) int64 absolute symbol-timing position
    windows_done: int  # symdemod windows emitted so far
    soft: np.ndarray  # (B, s) uint8 soft symbols not yet consumed
    soft_base: int  # absolute symbol index of soft[:, 0]
    dec: DecodeStreamState


def init_chain_carry(batch: int, cfg: PipelineConfig = PipelineConfig()) -> ChainCarry:
    return ChainCarry(
        pm=init_carry(batch, cfg.pm),
        iq_rem=np.zeros((batch, 0), np.int16),
        bb=np.zeros((batch, 0), np.int16),
        bb_base=0,
        bb_total=0,
        first=np.full((batch,), initial_firstsample(cfg.sym), np.int64),
        windows_done=0,
        soft=np.zeros((batch, 0), np.uint8),
        soft_base=0,
        dec=DecodeStreamState(batch),
    )


def receive_stream(
    iq: np.ndarray,
    cfg: PipelineConfig = PipelineConfig(),
    carry: ChainCarry | None = None,
    trim: bool = True,
) -> tuple[list[FrameRecord], ChainCarry]:
    """Process one chunk of a long recording, carrying acquisition state.

    The library-level form of the reference's unbounded stream semantics:
    consecutive calls on consecutive chunks produce byte-identical soft
    symbols and frames to ONE call on the concatenated recording — no
    re-acquisition transient at chunk boundaries (VERDICT r1 #4).  Frame
    ``start_symbol`` values are absolute stream symbol indices.

    Fixed-size chunks reuse one compiled program per stage; ragged chunks
    recompile per distinct (nblocks, nwindows) pair.
    """
    if carry is None:
        if iq.ndim == 1:
            iq = iq[None, :]
        carry = init_chain_carry(iq.shape[0], cfg)
    iq = np.asarray(iq)
    if iq.ndim == 1:
        iq = iq[None, :]
    B = iq.shape[0]
    n = cfg.pm.fftsize
    raw_in = not np.issubdtype(iq.dtype, np.complexfloating)
    blockvals = 2 * n if raw_in else n  # values per pm block

    # ---- pmdemod: whole FFT blocks; remainder carries over ----
    stream = np.concatenate([carry.iq_rem.astype(iq.dtype), iq], axis=1)
    nblocks = stream.shape[1] // blockvals
    iq_rem = stream[:, nblocks * blockvals :]
    pm_carry = carry.pm
    bb = carry.bb
    bb_total = carry.bb_total
    if nblocks:
        blocks = jnp.asarray(
            stream[:, : nblocks * blockvals].reshape(B, nblocks, blockvals)
        )
        pm_carry, pm_out = pm_demod_scan(pm_carry, blocks, cfg.pm)
        new_bb = np.asarray(
            jnp.swapaxes(pm_out.baseband, 0, 1).reshape(B, nblocks * n)
        )
        bb = np.concatenate([bb, new_bb], axis=1)
        bb_total += nblocks * n

    # ---- symdemod: the one-shot window-count rule applied to the
    # stream prefix (demod_to_symbols: (L - first0)//wlen - 1) ----
    wlen = window_samples(cfg.sym)
    first0 = initial_firstsample(cfg.sym)
    target = max((bb_total - first0) // wlen - 1, 0)
    nwin = target - carry.windows_done
    first = carry.first
    soft = carry.soft
    bb_base = carry.bb_base
    if nwin > 0:
        first_rel = (first - bb_base).astype(np.int64)
        assert (first_rel >= 0).all()
        _, sym_out = symdemod_scan(
            jnp.asarray(bb), cfg.sym, int(nwin), jnp.asarray(first_rel, jnp.int32)
        )
        new_soft = np.asarray(
            jnp.swapaxes(sym_out.soft, 0, 1).reshape(B, -1)
        )
        soft = np.concatenate([soft, new_soft], axis=1)
        # advance the carried firstsample with the C truncation walk
        last_first = np.asarray(sym_out.firstsample[-1], np.int64) + bb_base
        first = np.trunc(
            last_first.astype(np.float64) + cfg.sym.nsymbols * cfg.sym.symbolsamples
        ).astype(np.int64)
        # purge consumed baseband (symdemod.c:101-112 slide, with the
        # reference's 2-symbol lookback slop)
        keep_from = int(first.min()) - 2 * int(cfg.sym.symbolsamples) - 8
        slide = max(min(keep_from - bb_base, bb.shape[1]), 0)
        # round-half-to-even (nearbyint, symdemod.c:217) is translation
        # invariant only under EVEN integer shifts; keep bb_base even so
        # buffer-relative integration edges round exactly like absolute
        slide &= ~1
        bb = bb[:, slide:]
        bb_base += slide

    # ---- decode: stream walk with carried lock/pos ----
    dec = carry.dec
    records, dec = decode_stream(soft, cfg.decode, dec)
    records = [
        r._replace(start_symbol=r.start_symbol + carry.soft_base) for r in records
    ]
    soft_base = carry.soft_base
    if trim:
        cut = int(dec.pos.min())
        if cut > 0:
            soft = soft[:, cut:]
            dec.pos = dec.pos - cut
            soft_base += cut

    out = ChainCarry(
        pm=pm_carry,
        iq_rem=np.ascontiguousarray(iq_rem),
        bb=bb,
        bb_base=bb_base,
        bb_total=bb_total,
        first=first,
        windows_done=target if nwin > 0 else carry.windows_done,
        soft=soft,
        soft_base=soft_base,
        dec=dec,
    )
    return records, out


def run_pipeline(iq: np.ndarray, cfg: PipelineConfig = PipelineConfig()) -> PipelineResult:
    """End-to-end: IQ in, decoded frames out (the full
    ``pmdemod | symdemod | decode`` chain)."""
    soft, baseband, freq, cn0 = demod_to_symbols(jnp.asarray(iq), cfg)
    soft_np = np.asarray(soft)
    frames, _ = decode_stream(soft_np, cfg.decode)
    return PipelineResult(
        frames=frames,
        soft_symbols=soft_np,
        baseband=np.asarray(baseband),
        carrier_freq=np.asarray(freq),
        cn0=np.asarray(cn0),
    )
