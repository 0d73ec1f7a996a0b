"""Channel-axis sharding for the demod/decode pipeline.

The per-channel receive chain has no cross-channel data flow, so channel
parallelism is pure data parallelism: place the ``(channels, time)``
arrays with a ``ch``-sharded NamedSharding and jit the existing batched
stage functions — XLA partitions every op along the batch dimension with
zero collectives (the replacement for running one UNIX pipeline per
channel).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from isee3_decoder_tpu.models.pipeline import (
    PipelineConfig,
    demod_to_symbols,
    receive_block_device,
)


def shard_channels(arr: jax.Array, mesh: Mesh) -> jax.Array:
    """Place an array with its leading (channel) axis sharded over 'ch'."""
    spec = P("ch", *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def demod_to_symbols_sharded(
    iq: jax.Array, cfg: PipelineConfig, mesh: Mesh
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Channel-sharded demod path: same math as demod_to_symbols, with
    inputs/outputs constrained to the ch axis of the mesh."""
    iq = shard_channels(jnp.asarray(iq), mesh)
    out_sharding = (
        NamedSharding(mesh, P("ch", None)),  # soft
        NamedSharding(mesh, P("ch", None)),  # baseband
        NamedSharding(mesh, P(None, "ch")),  # carrier freq (T, B)
        NamedSharding(mesh, P(None, "ch")),  # cn0 (T, B)
    )
    fn = jax.jit(
        lambda x: demod_to_symbols(x, cfg),
        out_shardings=out_sharding,
    )
    return fn(iq)


def receive_block_sharded(
    iq: jax.Array,
    nframes: int,
    cfg: PipelineConfig,
    mesh: Mesh,
    npos: int | None = None,
) -> jax.Array:
    """Channel-sharded fused receive chain: the whole IQ→frames program
    (models/pipeline.receive_block_device) jitted over the mesh's 'ch'
    axis.  Demod/sync/decode are channel-independent, so the only
    collective XLA inserts is the lockstep Fano loop's all-lanes-done
    reduction.  Returns the packed result buffer
    (decode.unpack_block_buffer decodes it)."""
    from isee3_decoder_tpu.config import FRAMESYMBOLS

    if npos is None:
        npos = FRAMESYMBOLS
    iq = shard_channels(jnp.asarray(iq), mesh)
    fn = jax.jit(lambda x: receive_block_device(x, nframes, npos, cfg))
    return fn(iq)
