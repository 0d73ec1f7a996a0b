"""Viterbi decoder for rate-1/2 convolutional codes (K up to 24+).

Batched rebuild of the reference's flagship kernel
(``viterbi224_sse2.c`` / ``viterbi224_port.c``): a 2**(K-1)-state
add-compare-select over soft offset-binary symbols with packed survivor
decisions and a serial chainback.

Design (vs the reference):

* The SSE2 kernel processes 8 states per ``__m128i``
  (viterbi224_sse2.c:277-328).  Here the whole state dimension is one
  vector op: metrics live as a ``(batch, 2**(K-1))`` array, the butterfly
  is a reshape (low/high halves in, interleave out), and XLA maps it onto
  the VPU.  A ``lax.scan`` carries metrics across trellis steps.
* Branch metrics: the reference XORs a 0/255 branch table with the
  offset-binary symbols (viterbi224_sse2.c:292-293).  Because the table
  only takes values {0,255}, ``bt ^ s == s + bit*(255 - 2*s)`` — an
  elementwise multiply-add on precomputed 0/1 branch *bits*, with no
  gather.
* Decisions are bit-packed little-endian into uint32 words, one bit per
  state (1 MB per trellis step at K=24), identical layout to
  ``decision_t`` (viterbi224_sse2.c:20: bit ``state & 31`` of word
  ``state >> 5``), so chainback logic matches the reference
  (viterbi224_sse2.c:128-144).
* Renormalization: subtracting any constant from all path metrics never
  changes a compare, so instead of the reference's lazy threshold
  renormalization (viterbi224_sse2.c:347-377) the kernel subtracts the
  per-step minimum unconditionally and accumulates it into ``renorm``
  (the running total the reference keeps in ``vp->renormals``).  Decision
  bits are bit-identical either way.
* Tie-breaking matches the shipped SSE2 build: ``decision = m_0branch >
  m_1branch`` (viterbi224_sse2.c:316-317; the portable kernel instead
  uses >=, viterbi224_port.c:178-179 — a documented discrepancy in the
  reference itself).

Batch axis: every function takes/returns a leading batch dimension so
many channels/frames decode in lockstep — the batched replacement for the
reference's single-stream kernel (SURVEY.md §2.5).
"""

from __future__ import annotations

import dataclasses
import functools
import jax
import jax.numpy as jnp
import numpy as np

from isee3_decoder_tpu.config import DEFAULT_CODE, CodeSpec

#: Starting-state bias: unknown states start this much worse than the known
#: start state (viterbi224_sse2.c:44-50 uses SHRT_MIN+5000 vs SHRT_MIN).
START_BIAS = 5000


def _parity_u32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x ^= x >> 32
    x ^= x >> 16
    x ^= x >> 8
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return (x & 1).astype(np.uint8)


@functools.lru_cache(maxsize=8)
def branch_bits(code: CodeSpec = DEFAULT_CODE) -> tuple[np.ndarray, np.ndarray]:
    """0/1 branch bits for each butterfly index i in [0, 2**(K-2)).

    ``Branchtab224[p][i] = GFLIP ^ parity((2i) & POLY) ? 255 : 0``
    (viterbi224_sse2.c:74-77); we store the bit, not the 0/255 byte.
    """
    i = np.arange(1 << (code.k - 2), dtype=np.uint64)
    b0 = code.g1flip ^ _parity_u32((2 * i) & code.poly1)
    b1 = code.g2flip ^ _parity_u32((2 * i) & code.poly2)
    return b0.astype(np.uint8), b1.astype(np.uint8)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ViterbiState:
    """Decoder carry state — the explicit pytree version of ``struct v224``
    (viterbi224_sse2.c:26-34).

    Unlike the reference's malloc'd buffers, this is a value: checkpoint /
    restore and multi-chip sharding of a live streaming decode fall out of
    it being an ordinary pytree.
    """

    metrics: jax.Array  # (B, 2**(K-1)) int32 path metrics
    decisions: jax.Array  # (len, B, 2**(K-1)/32) uint32 circular tape
    dp: jax.Array  # () int32 — next write slot in the tape
    renorm: jax.Array  # (B,) int32 — accumulated renormalizations

    @property
    def tape_len(self) -> int:
        return self.decisions.shape[0]


def create(
    tape_len: int,
    batch: int = 1,
    code: CodeSpec = DEFAULT_CODE,
    start_state: int | jax.Array = 0,
    dtype: jnp.dtype = jnp.int32,
) -> ViterbiState:
    """Allocate decision tape + metrics (create_viterbi224, sse2.c:56-80).

    dtype: metric dtype.  int16 matches the SSE2 kernel's storage and
    halves metric traffic; the per-step renormalization keeps values
    far from saturation so decisions are identical to int32.
    """
    nstates = code.nstates
    words = nstates // 32
    decisions = jnp.zeros((tape_len, batch, words), dtype=jnp.uint32)
    st = ViterbiState(
        metrics=jnp.zeros((batch, nstates), dtype),
        decisions=decisions,
        dp=jnp.zeros((), jnp.int32),
        renorm=jnp.zeros((batch,), jnp.int32),
    )
    return init(st, start_state, code)


def init(
    state: ViterbiState,
    start_state: int | jax.Array = 0,
    code: CodeSpec = DEFAULT_CODE,
) -> ViterbiState:
    """Re-bias metrics for a new frame (init_viterbi224, sse2.c:37-53).

    All states start at START_BIAS except the known starting state at 0.
    """
    batch, nstates = state.metrics.shape
    start = jnp.broadcast_to(jnp.asarray(start_state, jnp.int32) & code.state_mask, (batch,))
    metrics = jnp.full((batch, nstates), START_BIAS, state.metrics.dtype)
    metrics = metrics.at[jnp.arange(batch), start].set(0)
    return dataclasses.replace(
        state,
        metrics=metrics,
        dp=jnp.zeros((), jnp.int32),
        renorm=jnp.zeros((batch,), jnp.int32),
    )


def _acs_step(
    metrics: jax.Array,
    syms: jax.Array,
    b0: jax.Array,
    b1: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """One add-compare-select trellis step.

    Args:
      metrics: (B, 2**(K-1)) int32.
      syms: (B, 2) int32 offset-binary soft symbols.
      b0, b1: (2**(K-2),) int32 0/1 branch bits.

    Returns:
      (new_metrics, packed_decisions, renorm_delta):
      new_metrics (B, 2**(K-1)), packed (B, 2**(K-1)//32) uint32,
      renorm_delta (B,) the subtracted per-step minimum.
    """
    B, nstates = metrics.shape
    half = nstates // 2
    mdt = metrics.dtype
    s0 = syms[:, 0:1]
    s1 = syms[:, 1:2]
    # bt ^ s for bt in {0,255}:  s + bit * (255 - 2 s)
    metric = ((s0 + b0 * (255 - 2 * s0)) + (s1 + b1 * (255 - 2 * s1))).astype(mdt)
    m_metric = jnp.asarray(510, mdt) - metric

    low = metrics[:, :half]
    high = metrics[:, half:]
    m0 = low + metric
    m3 = high + metric
    m1 = high + m_metric
    m2 = low + m_metric

    decision0 = m0 > m1  # ties → 0-branch survivor (sse2.c:316)
    decision1 = m2 > m3
    survivor0 = jnp.minimum(m0, m1)
    survivor1 = jnp.minimum(m2, m3)

    # Interleave: new state 2i ← survivor0[i], 2i+1 ← survivor1[i]
    new_metrics = jnp.stack([survivor0, survivor1], axis=-1).reshape(B, nstates)
    decisions = jnp.stack([decision0, decision1], axis=-1).reshape(B, nstates)

    # Unconditional renorm (see module docstring).
    dmin = new_metrics.min(axis=1, keepdims=True)
    new_metrics = new_metrics - dmin
    dmin = dmin.astype(jnp.int32)

    # Pack decision bits little-endian into uint32 words (decision_t layout).
    packed = (
        decisions.reshape(B, nstates // 32, 32).astype(jnp.uint32)
        << jnp.arange(32, dtype=jnp.uint32)
    ).sum(axis=-1, dtype=jnp.uint32)
    return new_metrics, packed, dmin[:, 0]


@functools.partial(jax.jit, static_argnames=("code",), donate_argnums=(0,))
def update_blk(
    state: ViterbiState,
    syms: jax.Array,
    code: CodeSpec = DEFAULT_CODE,
) -> ViterbiState:
    """Run nbits ACS steps (update_viterbi224_blk, sse2.c:259-389).

    Args:
      state: decoder state (donated — buffers are reused).
      syms: (B, 2*nbits) or (2*nbits,) uint8 offset-binary soft symbols.

    Decision words are written into the circular tape starting at slot
    ``state.dp`` (wrap-around streaming, sse2.c:379-380).
    """
    b0_np, b1_np = branch_bits(code)
    b0 = jnp.asarray(b0_np, jnp.int32)
    b1 = jnp.asarray(b1_np, jnp.int32)
    if syms.ndim == 1:
        syms = syms[None, :]
    B = state.metrics.shape[0]
    nbits = syms.shape[-1] // 2
    syms = jnp.broadcast_to(syms.astype(jnp.int32).reshape(-1, nbits, 2), (B, nbits, 2))
    syms = jnp.swapaxes(syms, 0, 1)  # (nbits, B, 2)

    tape_len = state.tape_len

    def step(carry, sym_t):
        metrics, tape, dp, renorm = carry
        new_metrics, packed, delta = _acs_step(metrics, sym_t, b0, b1)
        tape = jax.lax.dynamic_update_index_in_dim(tape, packed, dp, axis=0)
        dp = jax.lax.rem(dp + 1, jnp.int32(tape_len))
        return (new_metrics, tape, dp, renorm + delta), None

    (metrics, tape, dp, renorm), _ = jax.lax.scan(
        step, (state.metrics, state.decisions, state.dp, state.renorm), syms
    )
    return ViterbiState(metrics=metrics, decisions=tape, dp=dp, renorm=renorm)


def _tape_bit(tape: jax.Array, slot: jax.Array, endstate: jax.Array) -> jax.Array:
    """Decision bit for ``endstate`` at tape slot (sse2.c:141)."""
    word = tape[slot, jnp.arange(tape.shape[1]), endstate >> 5]
    return (word >> (endstate.astype(jnp.uint32) & 31)) & 1


@functools.partial(jax.jit, static_argnames=("nbits", "code"))
def chainback(
    state: ViterbiState,
    nbits: int,
    endstate: int | jax.Array,
    code: CodeSpec = DEFAULT_CODE,
) -> jax.Array:
    """Trace back nbits decisions from a known end state
    (chainback_viterbi224, sse2.c:113-161).

    Assumes the tape's last written slot holds the final trellis step
    (i.e. ``update_blk`` just consumed ``nbits`` bits; slots wrap as in
    the reference's ``nbits % vp->len`` indexing).

    Returns (B, nbits) uint8 decoded bits, transmitted order.
    """
    B = state.metrics.shape[0]
    k = code.k
    end = jnp.broadcast_to(jnp.asarray(endstate, jnp.uint32) & code.state_mask, (B,))
    tape_len = state.tape_len
    # Slot holding trellis step t (t in [0, nbits)): the reference indexes
    # decisions[t % len] for a fresh frame; for a wrapped stream the last
    # written slot is dp-1 == step nbits-1.
    last = jax.lax.rem(state.dp - 1 + tape_len, jnp.int32(tape_len))

    def step(endstate, t):
        slot = jax.lax.rem(last - t + tape_len * 2, jnp.int32(tape_len))
        out_bit = (endstate & 1).astype(jnp.uint8)
        bit = _tape_bit(state.decisions, slot, endstate)
        endstate = (bit << (k - 2)) | (endstate >> 1)
        return endstate, out_bit

    _, bits_rev = jax.lax.scan(step, end, jnp.arange(nbits, dtype=jnp.int32))
    # bits fall off the right end of endstate newest-first (sse2.c:137)
    return jnp.flip(bits_rev.T, axis=-1)


@functools.partial(jax.jit, static_argnames=("delay", "code"))
def decodebit(
    state: ViterbiState,
    delay: int,
    endstate: int | jax.Array = 0,
    code: CodeSpec = DEFAULT_CODE,
) -> jax.Array:
    """Chain back ``delay`` steps from ``endstate`` and return one decoded
    bit per batch element (decodebit_viterbi224, sse2.c:164-203).

    The fixed-delay streaming decode mode used by vdecode.c:145-152.
    """
    B = state.metrics.shape[0]
    k = code.k
    end = jnp.broadcast_to(jnp.asarray(endstate, jnp.uint32) & code.state_mask, (B,))
    tape_len = state.tape_len

    def step(carry, t):
        endstate, bit = carry
        slot = jax.lax.rem(state.dp - 1 - t + 2 * tape_len, jnp.int32(tape_len))
        bit = _tape_bit(state.decisions, slot, endstate)
        endstate = (bit << (k - 2)) | (endstate >> 1)
        return (endstate, bit), None

    (_, bit), _ = jax.lax.scan(
        step,
        (end, jnp.zeros((B,), jnp.uint32)),
        jnp.arange(delay, dtype=jnp.int32),
    )
    return bit.astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("delay", "code"))
def streaming_decodebits(
    state: ViterbiState,
    delay: int,
    code: CodeSpec = DEFAULT_CODE,
) -> jax.Array:
    """All fixed-delay streaming decode outputs at once.

    Equivalent to running ``decodebit(state_t, delay, 0)`` after every
    trellis step t >= delay of a full-tape update (the vdecode.c:142-154
    per-symbol-pair loop), but vectorized: every end time chains back
    independently.  Requires tape_len >= nbits (fresh full-frame tape).

    Returns (B, nbits-delay) uint8; output j corresponds to end time
    t = delay + j and equals input bit b_{t - delay - (K-2)}.
    """
    nbits = state.tape_len
    B = state.metrics.shape[0]
    k = code.k

    def one_end_time(t):
        def step(endstate, d):
            bit = _tape_bit(state.decisions, t - d, endstate)
            endstate = (bit << (k - 2)) | (endstate >> 1)
            return endstate, bit

        _, bits = jax.lax.scan(
            step,
            jnp.zeros((B,), jnp.uint32),
            jnp.arange(delay, dtype=jnp.int32),
        )
        return bits[-1].astype(jnp.uint8)

    ts = jnp.arange(delay, nbits, dtype=jnp.int32)
    out = jax.vmap(one_end_time)(ts)  # (nbits-delay, B)
    return out.T


@functools.partial(jax.jit, static_argnames=("delay", "count", "code"))
def streaming_decodebits_window(
    state: ViterbiState,
    delay: int,
    count: int,
    code: CodeSpec = DEFAULT_CODE,
) -> jax.Array:
    """Fixed-delay streaming outputs for the last ``count`` trellis steps
    on a circular tape.

    Output j corresponds to end time dp-count+j (i.e. the j-th of the
    last ``count`` updates) and equals decodebit(delay) as issued right
    after that update.  Requires tape_len >= count + delay.
    """
    B = state.metrics.shape[0]
    k = code.k
    tape_len = jnp.int32(state.tape_len)

    def one_end_time(offset):
        # end slot for this output: last written slot minus offset
        def step(endstate, d):
            slot = jax.lax.rem(
                state.dp - 1 - offset - d + 4 * tape_len, tape_len
            )
            bit = _tape_bit(state.decisions, slot, endstate)
            endstate = (bit << (k - 2)) | (endstate >> 1)
            return endstate, bit

        _, bits = jax.lax.scan(
            step,
            jnp.zeros((B,), jnp.uint32),
            jnp.arange(delay, dtype=jnp.int32),
        )
        return bits[-1].astype(jnp.uint8)

    offsets = jnp.arange(count - 1, -1, -1, dtype=jnp.int32)
    out = jax.vmap(one_end_time)(offsets)  # (count, B)
    return out.T


@functools.partial(jax.jit, static_argnames=("delay", "code"))
def decodeword(
    state: ViterbiState,
    delay: int,
    endstate: int | jax.Array = 0,
    code: CodeSpec = DEFAULT_CODE,
) -> jax.Array:
    """Chain back ``delay`` steps and return the last 64 decoded bits as
    (B, 64) — decodeword_viterbi224 (sse2.c:206-243).

    Bits are ordered oldest-first (the reference packs newest at bit 63
    and shifts right; this returns the equivalent bit array).
    """
    B = state.metrics.shape[0]
    k = code.k
    end = jnp.broadcast_to(jnp.asarray(endstate, jnp.uint32) & code.state_mask, (B,))
    tape_len = state.tape_len

    def step(endstate, t):
        slot = jax.lax.rem(state.dp - 1 - t + 2 * tape_len, jnp.int32(tape_len))
        bit = _tape_bit(state.decisions, slot, endstate)
        endstate = (bit << (k - 2)) | (endstate >> 1)
        return endstate, bit.astype(jnp.uint8)

    _, bits = jax.lax.scan(step, end, jnp.arange(delay, dtype=jnp.int32))
    # bits[t] is the bit delay-t steps back; last 64 oldest-first:
    return jnp.flip(bits.T[:, -64:] if delay >= 64 else bits.T, axis=-1)


@jax.jit
def best_state(state: ViterbiState) -> jax.Array:
    """argmin of the path metrics — the 'find best path' mode of
    decodebit/decodeword (sse2.c:173-182)."""
    from isee3_decoder_tpu.ops.reductions import argmin_first

    return argmin_first(state.metrics, axis=1).astype(jnp.uint32)


def min_metric(state: ViterbiState) -> jax.Array:
    """(B,) smallest path metric incl. renorm (min_metric_viterbi224)."""
    return state.metrics.min(axis=1) + state.renorm


def max_metric(state: ViterbiState) -> jax.Array:
    """(B,) largest path metric incl. renorm (max_metric_viterbi224)."""
    return state.metrics.max(axis=1) + state.renorm


# ---------------------------------------------------------------------------
# One-shot frame decode (the decode.c:216-230 usage pattern)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("nbits", "code", "dtype"))
def decode_frame(
    syms: jax.Array,
    nbits: int,
    start_state: int | jax.Array = 0,
    end_state: int | jax.Array = 0,
    code: CodeSpec = DEFAULT_CODE,
    dtype: jnp.dtype = jnp.int32,
) -> jax.Array:
    """init → update → chainback for (B, 2*nbits) symbols → (B, nbits) bits."""
    if syms.ndim == 1:
        syms = syms[None, :]
    st = create(nbits, syms.shape[0], code, start_state, dtype)
    st = update_blk(st, syms, code)
    return chainback(st, nbits, end_state, code)
