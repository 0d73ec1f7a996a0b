"""In-place (rotating-layout) Viterbi ACS.

The standard butterfly (ops/viterbi.py) interleaves survivors into new
state order every step — a permutation of the whole metric array that
can dominate runtime.  This module removes *all* data movement with a
rotating layout, the trellis analogue of an in-place FFT:

Keep metrics in *position space*, where the position of state ``s`` after
t trellis steps is ``P_t(s) = rotr^t(s)`` (bit-rotation of the W=K-1-bit
state).  Then for the step t butterfly (sources i, i+2^(W-1) → targets
2i, 2i+1):

    P_{t+1}(2i)   = P_t(i)
    P_{t+1}(2i+1) = P_t(i + 2^(W-1))

— the survivors land **exactly where their sources were read**, so the
update is elementwise over two strided half-views whose pair offset is
``o_t = 2^((W-1-t) mod W)``; the layout rotation is implicit and free.

Branch bits also become elementwise: with q = (poly >> 1) masked to W-1
bits, ``branch_bit(i) = flip ^ parity(i & q)`` and since rotation is a
bit permutation, at position p this is ``flip ^ parity(p & rotr^t(q))``
— one AND + popcount against a per-step constant mask, no branch-table
memory traffic at all.

Decisions are packed along the *sublane* direction (bit = row%32 of word
row//32*128 + lane for position p = row*128+lane) so packing is a plain
sublane reduction, not a lane shuffle; chainback just uses the matching
index arithmetic plus a ``rotr^{t+1}`` of the walked state.

Renormalization happens once per W-step cycle (metric growth is at most
510/step, far inside int16 headroom), costing ~1/W of a metric pass.

Everything is bit-identical to ops/viterbi.py (same SSE2 tie-breaking);
tests cross-validate decisions, metrics, and decoded bits.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from isee3_decoder_tpu.config import DEFAULT_CODE, CodeSpec
from isee3_decoder_tpu.ops import viterbi as vit


def _parity32(x):
    """Elementwise parity by XOR folding."""
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


def _rotr(x: int, t: int, w: int) -> int:
    t %= w
    mask = (1 << w) - 1
    return ((x >> t) | (x << (w - t))) & mask


def _rotl(x: int, t: int, w: int) -> int:
    return _rotr(x, w - (t % w), w)


def _branch_masks(code: CodeSpec) -> tuple[int, int]:
    """q such that branch_bit(i) = flip ^ parity(i & q) for butterfly i."""
    w = code.k - 1
    q1 = (code.poly1 >> 1) & ((1 << (w - 1)) - 1)
    q2 = (code.poly2 >> 1) & ((1 << (w - 1)) - 1)
    return q1, q2


def perm_t(t: int, code: CodeSpec) -> int:
    """Static rotation amount of the layout after t steps."""
    return t % (code.k - 1)


def state_position(s, t: int, code: CodeSpec):
    """P_t(s) = rotr^t(s) for scalars or arrays (jnp or numpy)."""
    w = code.k - 1
    r = perm_t(t, code)
    if r == 0:
        return s
    mask = (1 << w) - 1
    return ((s >> r) | (s << (w - r))) & mask


@functools.partial(jax.jit, static_argnames=("t", "code"))
def _step_inplace(metrics, syms, t: int, code: CodeSpec):
    """One in-place ACS step at layout time t.

    metrics: (B, 2^W) int16 in P_t position space.
    syms: (B, 2) int32.
    Returns (new_metrics in P_{t+1} space — same positions,
             packed decisions (B, 2^W//32) uint32 in position space).
    """
    B, n = metrics.shape
    w = code.k - 1
    r = perm_t(t, code)
    o = 1 << ((w - 1 - r) % w)
    q1, q2 = _branch_masks(code)
    m1 = _rotr(q1, r, w)
    m2 = _rotr(q2, r, w)

    nh = n // (2 * o)
    v = metrics.reshape(B, nh, 2, o)
    lo = v[:, :, 0, :]
    hi = v[:, :, 1, :]

    # position value of each low-source element: p = q*(2o) + row_r
    pq = jax.lax.broadcasted_iota(jnp.int32, (nh, o), 0) * (2 * o)
    pr = jax.lax.broadcasted_iota(jnp.int32, (nh, o), 1)
    p = pq + pr
    b0 = _parity32(p & m1) ^ code.g1flip
    b1 = _parity32(p & m2) ^ code.g2flip

    s0 = syms[:, 0:1, None]
    s1 = syms[:, 1:2, None]
    metric = ((s0 + b0 * (255 - 2 * s0)) + (s1 + b1 * (255 - 2 * s1))).astype(
        metrics.dtype
    )
    m_metric = jnp.asarray(510, metrics.dtype) - metric

    a0 = lo + metric
    a1 = hi + m_metric
    a2 = lo + m_metric
    a3 = hi + metric
    d0 = a0 > a1
    d1 = a2 > a3
    new_lo = jnp.minimum(a0, a1)  # state 2i stays at p
    new_hi = jnp.minimum(a2, a3)  # state 2i+1 stays at p+o

    new = jnp.stack([new_lo, new_hi], axis=2).reshape(B, n)
    dec = jnp.stack([d0, d1], axis=2).reshape(B, n)

    # Sublane packing: rows of 128 lanes; word g*128+lane collects rows
    # 32g..32g+31, bit j = row 32g+j.
    rows = n // 128
    dd = dec.reshape(B, rows // 32, 32, 128).astype(jnp.int32)
    shifts = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 32, 1), 2)
    words = (dd << shifts).sum(axis=2, dtype=jnp.int32)
    packed = words.reshape(B, n // 32).astype(jnp.uint32)
    return new, packed


def _pos_bit(packed_t, p):
    """Decision bit for position p from a sublane-packed word plane.

    packed_t: (B, n//32) uint32; p: (B,) int32 positions.
    """
    row = p >> 7
    lane = p & 127
    word = (row >> 5) * 128 + lane
    bitpos = (row & 31).astype(jnp.uint32)
    B = packed_t.shape[0]
    wv = packed_t[jnp.arange(B), word]
    return ((wv >> bitpos) & 1).astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("nbits", "code"))
def update_frame_inplace(
    metrics0: jax.Array,
    syms: jax.Array,
    nbits: int,
    code: CodeSpec = DEFAULT_CODE,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Run nbits in-place ACS steps from identity layout.

    metrics0: (B, 2^W) int16, standard state order (layout t=0).
    syms: (B, 2*nbits) uint8.
    Returns (final metrics in P_nbits layout, decisions (nbits, B, n//32),
             renorm (B,) int32 total subtracted).

    The W-step layout cycle is unrolled inside a scan over cycles; a
    static remainder handles nbits % W.  Renormalization (global-min
    subtraction) runs once per cycle — growth per cycle is ~W*510,
    comfortably inside int16 range.
    """
    B, n = metrics0.shape
    w = code.k - 1
    if syms.ndim == 1:
        syms = syms[None, :]
    syms = jnp.broadcast_to(
        syms.astype(jnp.int32).reshape(-1, nbits, 2), (B, nbits, 2)
    )
    syms_t = jnp.swapaxes(syms, 0, 1)  # (nbits, B, 2)

    ncycles = nbits // w
    rem = nbits - ncycles * w

    def renorm(m, total):
        gmin = m.min(axis=1, keepdims=True)
        return m - gmin, total + gmin[:, 0].astype(jnp.int32)

    def cycle(carry, sym_block):
        m, total = carry
        outs = []
        for t in range(w):
            m, packed = _step_inplace(m, sym_block[t], t, code)
            outs.append(packed)
        m, total = renorm(m, total)
        return (m, total), jnp.stack(outs)

    total0 = jnp.zeros((B,), jnp.int32)
    if ncycles > 0:
        blocks = syms_t[: ncycles * w].reshape(ncycles, w, B, 2)
        (m, total), decs = jax.lax.scan(cycle, (metrics0, total0), blocks)
        decs = decs.reshape(ncycles * w, B, n // 32)
    else:
        m, total = metrics0, total0
        decs = jnp.zeros((0, B, n // 32), jnp.uint32)

    rem_out = []
    for t in range(rem):
        m, packed = _step_inplace(m, syms_t[ncycles * w + t], t, code)
        rem_out.append(packed)
    if rem:
        m, total = renorm(m, total)
        decs = jnp.concatenate([decs, jnp.stack(rem_out)], axis=0)
    return m, decs, total


@functools.partial(jax.jit, static_argnames=("nbits", "code"))
def chainback_inplace(
    decisions: jax.Array,
    nbits: int,
    endstate: int | jax.Array,
    code: CodeSpec = DEFAULT_CODE,
) -> jax.Array:
    """Trace back through position-space decision planes.

    decisions: (nbits, B, n//32) uint32 from update_frame_inplace (plane
    t is in P_{t+1} layout).
    """
    B = decisions.shape[1]
    w = code.k - 1
    k = code.k
    end = jnp.broadcast_to(
        jnp.asarray(endstate, jnp.uint32) & code.state_mask, (B,)
    ).astype(jnp.int32)

    def step(endstate, t):
        # layout rotation of plane t is (t+1) mod w
        r = jnp.mod(t + 1, w)
        s = endstate
        p = ((s >> r) | (s << (w - r))) & (2**w - 1)
        out_bit = (s & 1).astype(jnp.uint8)
        bit = _pos_bit(decisions[t], p).astype(jnp.int32)
        endstate = (bit << (k - 2)) | (s >> 1)
        return endstate, out_bit

    ts = jnp.arange(nbits - 1, -1, -1, dtype=jnp.int32)
    _, bits = jax.lax.scan(step, end, ts)
    return jnp.flip(bits.T, axis=-1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StreamState:
    """Streaming decoder state for the rotating-layout kernel: the fast
    kernel's version of the circular decision memory that makes
    unbounded decoding possible (viterbi224_sse2.c:379-380)."""

    metrics: jax.Array  # (B, 2^W) in layout P_{total mod W}
    decisions: jax.Array  # (L, B, n//32) circular tape of packed planes
    dp: jax.Array  # () int32 next write slot
    total: jax.Array  # () int32 absolute trellis steps so far
    renorm: jax.Array  # (B,) int32


def stream_create(
    tape_len: int,
    batch: int = 1,
    code: CodeSpec = DEFAULT_CODE,
    start_state: int | jax.Array = 0,
    dtype: jnp.dtype = jnp.int16,
) -> StreamState:
    n = code.nstates
    start = jnp.broadcast_to(
        jnp.asarray(start_state, jnp.int32) & code.state_mask, (batch,)
    )
    metrics = jnp.full((batch, n), vit.START_BIAS, dtype)
    metrics = metrics.at[jnp.arange(batch), start].set(0)
    return StreamState(
        metrics=metrics,
        decisions=jnp.zeros((tape_len, batch, n // 32), jnp.uint32),
        dp=jnp.zeros((), jnp.int32),
        total=jnp.zeros((), jnp.int32),
        renorm=jnp.zeros((batch,), jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("code",), donate_argnums=(0,))
def stream_update(
    state: StreamState,
    syms: jax.Array,
    code: CodeSpec = DEFAULT_CODE,
) -> StreamState:
    """Advance the streaming decoder by the given symbol pairs.

    The per-step layout rotation depends on the absolute step count, so
    the scan body switches between the W static step variants.
    Renormalization runs every step (decision-invariant).
    """
    w = code.k - 1
    B = state.metrics.shape[0]
    if syms.ndim == 1:
        syms = syms[None, :]
    nbits = syms.shape[-1] // 2
    syms3 = jnp.broadcast_to(
        syms.astype(jnp.int32).reshape(-1, nbits, 2), (B, nbits, 2)
    )
    syms3 = jnp.swapaxes(syms3, 0, 1)
    L = state.decisions.shape[0]

    branches = [
        (lambda m, s, t=t: _step_inplace(m, s, t, code)) for t in range(w)
    ]

    def body(carry, sym_t):
        m, tape, dp, total, renorm = carry
        m, packed = jax.lax.switch(jnp.mod(total, w), branches, m, sym_t)
        gmin = m.min(axis=1, keepdims=True)
        m = m - gmin
        renorm = renorm + gmin[:, 0].astype(jnp.int32)
        tape = jax.lax.dynamic_update_index_in_dim(tape, packed, dp, axis=0)
        dp = jax.lax.rem(dp + 1, jnp.int32(L))
        return (m, tape, dp, total + 1, renorm), None

    (m, tape, dp, total, renorm), _ = jax.lax.scan(
        body,
        (state.metrics, state.decisions, state.dp, state.total, state.renorm),
        syms3,
    )
    return StreamState(
        metrics=m, decisions=tape, dp=dp, total=total, renorm=renorm
    )


@functools.partial(jax.jit, static_argnames=("delay", "count", "code", "skip"))
def stream_decodebits(
    state: StreamState,
    delay: int,
    count: int,
    code: CodeSpec = DEFAULT_CODE,
    skip: int = 0,
) -> jax.Array:
    """Fixed-delay outputs for ``count`` steps ending ``skip`` steps
    before the newest plane (vdecode mode on the fast kernel).  Requires
    tape_len >= skip + count + delay.  ``skip`` lets a caller ignore
    erasure-padded steps appended by a cycle-aligned update."""
    w = code.k - 1
    k = code.k
    B = state.metrics.shape[0]
    L = jnp.int32(state.decisions.shape[0])
    mask = jnp.int32(2**w - 1)
    nw = state.decisions.shape[2]
    # One flat word gather per traceback step: indexing the tape as
    # decisions[slot] would materialize whole (B, n//32) planes per
    # offset lane (plane-sized traffic × count lanes × delay steps);
    # flat (count*B,) gathers keep each step's traffic to a few words.
    flat = state.decisions.reshape(-1)
    bidx = jnp.arange(B, dtype=jnp.int32)[None, :]

    def step(endstate, d):
        # endstate: (count, B) uint32; plane for absolute step
        # T = total-1-offset-d has layout rotation (T+1) % w
        T = state.total - 1 - offsets[:, None] - d
        slot = jax.lax.rem(state.dp - 1 - offsets[:, None] - d + 4 * L, L)
        r = jnp.mod(T + 1, w)
        s = endstate.astype(jnp.int32)
        p = ((s >> r) | (s << (w - r))) & mask
        row = p >> 7
        lane = p & 127
        word = (row >> 5) * 128 + lane
        wv = flat[(slot * B + bidx) * nw + word]
        bit = ((wv >> (row & 31).astype(jnp.uint32)) & 1).astype(jnp.int32)
        endstate = ((bit << (k - 2)) | (s >> 1)).astype(jnp.uint32)
        return endstate, bit

    offsets = jnp.arange(skip + count - 1, skip - 1, -1, dtype=jnp.int32)
    _, bits = jax.lax.scan(
        step,
        jnp.zeros((count, B), jnp.uint32),
        jnp.arange(delay, dtype=jnp.int32),
    )
    return bits[-1].astype(jnp.uint8).T


@functools.partial(jax.jit, static_argnames=("nbits", "code", "dtype"))
def decode_frame_inplace(
    syms: jax.Array,
    nbits: int,
    start_state: int | jax.Array = 0,
    end_state: int | jax.Array = 0,
    code: CodeSpec = DEFAULT_CODE,
    dtype: jnp.dtype = jnp.int16,
) -> jax.Array:
    """Full frame decode with the in-place kernel."""
    if syms.ndim == 1:
        syms = syms[None, :]
    B = syms.shape[0]
    n = code.nstates
    start = jnp.broadcast_to(
        jnp.asarray(start_state, jnp.int32) & code.state_mask, (B,)
    )
    metrics = jnp.full((B, n), vit.START_BIAS, dtype)
    metrics = metrics.at[jnp.arange(B), start].set(0)
    _, decs, _ = update_frame_inplace(metrics, syms, nbits, code)
    return chainback_inplace(decs, nbits, end_state, code)
