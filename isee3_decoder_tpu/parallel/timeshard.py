"""Time-axis (sequence-parallel) sharding of the demod path.

SURVEY.md §2.5/§5.7: the reference handles unbounded streams with a
sliding window in one process; the batched equivalent shards the
*time axis* of a long recording across devices, giving each shard an
overlap-save halo of leading samples so its windows see the same data
the sequential pipeline would.

Semantics: the carrier/timing loop state is re-acquired inside each
shard's halo, so after the halo ramp-up the shard's windows match the
sequential pipeline's windows at the same absolute sample positions
(±1 symbol of timing-phase seam on noisy signals).  This trades a
bounded re-acquisition transient for linear scaling in recording
length — the domain's sequence parallelism, where exact carry handoff
would serialize the chain.  Frame sync downstream absorbs seams the
same way it absorbs any lock loss.

All shard arithmetic is in whole symdemod windows: chunk and halo are
multiples of window_samples so shard windows land exactly on sequential
window boundaries.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from isee3_decoder_tpu.models.pipeline import PipelineConfig, demod_to_symbols
from isee3_decoder_tpu.models.symdemod import window_samples


@dataclasses.dataclass(frozen=True)
class TimeShardPlan:
    """How a (B, L) recording splits into time shards (window units)."""

    nshards: int
    chunk_windows: int  # payload windows per shard
    halo_windows: int  # leading ramp-up windows per shard
    window_len: int  # samples per window

    @property
    def chunk(self) -> int:
        return self.chunk_windows * self.window_len

    @property
    def shard_len(self) -> int:
        # +2 windows of slack: demod_to_symbols drops one trailing
        # window for the timing-search margin
        return (self.chunk_windows + self.halo_windows + 2) * self.window_len


def plan_time_shards(
    total_samples: int, nshards: int, cfg: PipelineConfig
) -> TimeShardPlan:
    """Halo: enough windows to cover carrier + timing reacquisition
    (one FFT block + one full window), rounded up to whole windows."""
    wlen = window_samples(cfg.sym)
    assert wlen % cfg.pm.fftsize == 0, (
        "window length must be a whole number of FFT blocks for aligned "
        "time sharding"
    )
    halo_w = 1 + (cfg.pm.fftsize + wlen - 1) // wlen
    total_w = total_samples // wlen
    chunk_w = max((total_w - halo_w - 2) // nshards, 1)
    return TimeShardPlan(
        nshards=nshards,
        chunk_windows=chunk_w,
        halo_windows=halo_w,
        window_len=wlen,
    )


def shard_views(iq: np.ndarray, plan: TimeShardPlan) -> np.ndarray:
    """(B, L) → (nshards, B, shard_len) overlapping copies.

    Shard s>0 starts ``halo`` windows *before* its payload so its window
    h+j is absolute window s*chunk_windows + j; shard 0 starts at sample
    0 (its payload begins at window 0, no ramp-up needed)."""
    if iq.ndim == 1:
        iq = iq[None, :]
    B = iq.shape[0]
    halo = plan.halo_windows * plan.window_len
    assert plan.chunk >= halo or plan.nshards == 1, "chunk smaller than halo"
    out = np.zeros((plan.nshards, B, plan.shard_len), iq.dtype)
    for s in range(plan.nshards):
        start = max(s * plan.chunk - halo, 0)
        seg = iq[:, start : start + plan.shard_len]
        out[s, :, : seg.shape[1]] = seg
    return out


def demod_time_sharded(
    iq: np.ndarray,
    cfg: PipelineConfig,
    mesh: Mesh,
    nshards: int | None = None,
    axis: str = "ch",
) -> tuple[np.ndarray, TimeShardPlan]:
    """Demodulate a long recording with the time axis sharded over
    ``axis``.  Returns (soft (nshards, B, S_shard), plan): shard s's
    window w covers absolute samples s*chunk + w*window_len.
    """
    if iq.ndim == 1:
        iq = iq[None, :]
    n = mesh.shape[axis] if nshards is None else nshards
    plan = plan_time_shards(iq.shape[-1], n, cfg)
    shards = shard_views(iq, plan)

    spec = NamedSharding(mesh, P(axis, None, None))
    shards_dev = jax.device_put(jnp.asarray(shards), spec)
    fn = jax.jit(
        jax.vmap(lambda x: demod_to_symbols(x, cfg)[0]),
        out_shardings=NamedSharding(mesh, P(axis, None, None)),
    )
    soft = fn(shards_dev)
    return np.asarray(soft), plan


def stitch_shards(soft: np.ndarray, plan: TimeShardPlan, cfg: PipelineConfig) -> np.ndarray:
    """Concatenate shard payload windows: shard 0 contributes windows
    [0, chunk_windows + halo_windows); shard s>0 contributes windows
    [halo_windows, halo_windows + chunk_windows)."""
    nshards, B, S = soft.shape
    nsym = cfg.sym.nsymbols
    h, c = plan.halo_windows, plan.chunk_windows
    parts = [soft[0, :, : c * nsym]]
    for s in range(1, nshards):
        parts.append(soft[s, :, h * nsym : (h + c) * nsym])
    return np.concatenate(parts, axis=-1)
