"""Batched soft-decision Fano sequential decoder.

Capability parity with ``fano.c`` (the 1994/2014 KA9Q Fano decoder):
per-node precomputed 4-way branch metrics (fano.c:70-80), the
threshold-walk search with delta tightening/relaxation (fano.c:110-189),
known tail-bit forcing (fano.c:141-147), and a cycles-per-bit timeout
(fano.c:106,110).

Batched reformulation: the reference's data-dependent walk (forward
look, then an inner multi-step backtrack loop) is flattened into a
``lax.while_loop`` of *micro-steps*.  Every active batch element makes
one forward look per micro-step (costing one cycle, matching the
reference's outer-loop cycle count); an element whose look violates the
threshold resolves its ENTIRE backtrack inner loop in the same
micro-step (costing nothing, as in the reference).  All frames in the
batch advance in lockstep until every one has finished or timed out —
Fano's wildly variable per-frame cost (CHANGES:21) is absorbed by the
batch dimension instead of a single CPU core.

The pop-run collapse (round 5): the reference's inner backtrack loop
(fano.c:169-188) scans DOWN the path — pop while the previous node's
metric stays >= the threshold, stopping at the first node whose second
branch is still untried (toggle and resume forward) or, failing that,
where the path metric dips below the threshold (relax the threshold).
During the run nothing it reads changes, so the stop point is a pure
function of the tape: with jr = max j < np where gamma[j] < t and
jt = max j < np where (ibr[j] == 0 and j < tail_start),

  toggle at node jt        iff jt > jr,
  relax  at node jr + 1    otherwise (jr = -1 ⇒ relax at node 0).

Both are one masked max-reduction over a dense per-node array — the
whole data-dependent pop-run becomes two vector reductions + one
record fetch, instead of one micro-step per pop (the step-by-step walk
spent ~17 micro-steps per forward look near the Fano cliff; the
collapsed walk spends exactly one).

The per-node state (cumulative metric, sorted branch metrics, branch
index, encoder-state hypothesis — the array-of-structs ``struct node``
of fano.c:13-19) splits into the CURRENT node's record carried in
per-lane scan registers, a stride-8 push-down tape (with the static
4-way branch metrics interleaved into each record), and a dense
(B, N+1) mirror D = (gamma << 1) | ibr that feeds the collapse
reductions (gamma < t ⟺ D < t << 1 since ibr ∈ {0,1}).  Each
micro-step costs ONE mode-selected 4-wide gather — advancing lanes
read the next node's metrics, collapsing lanes read the target node's
record — two masked reductions over D, and ONE 4-wide + ONE 1-wide
push scatter.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from isee3_decoder_tpu import backends
from isee3_decoder_tpu.config import DEFAULT_CODE, CodeSpec


class FanoResult(NamedTuple):
    bits: jax.Array  # (B, nbits) uint8 decoded bits (valid up to goodbits)
    goodbits: jax.Array  # (B,) int32 — == nbits on success (fano.c:195)
    metric: jax.Array  # (B,) int32 final path metric (fano.c:190)
    cycles: jax.Array  # (B,) int32 forward-look count (fano.c:191)

    @property
    def success(self) -> jax.Array:
        return self.goodbits == self.bits.shape[-1]


def _parity(x: jax.Array) -> jax.Array:
    """Parity of the set bits (encode.c:4-6) via XOR folding."""
    x = x.astype(jnp.int32)
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


def _makesyms(enc: jax.Array, code: CodeSpec) -> jax.Array:
    """Symbol pair for an encoder state: POLY1 in bit 1, POLY2 in bit 0.

    Faithful to ``makesyms`` (fano.c:28-34) including its quirk of XORing
    G1FLIP into bit 0 after the shift (harmless since every catalogued
    code has G1FLIP == 0).
    """
    s1 = (_parity(enc & code.poly1) << 1) ^ code.g1flip
    s2 = _parity(enc & code.poly2) ^ code.g2flip
    return s1 | s2


@dataclasses.dataclass(frozen=True)
class FanoParams:
    """Static search parameters (decode.c:66-73 defaults)."""

    delta: int = 32  # threshold step (Fano_delta = 4 * Fano_scale)
    maxcycles: int = 100  # forward-looks per bit before giving up
    #: micro-steps per while_loop iteration: purely a performance knob
    #: (identical walk).  None = the platform's default
    #: (backends.defaults().fano_unroll).
    unroll: int | None = None

    def resolved_unroll(self) -> int:
        if self.unroll is not None:
            return max(self.unroll, 1)
        return backends.defaults().fano_unroll


def fano_decode(
    symbols: jax.Array,
    mettab: jax.Array,
    nbits: int,
    encstate: int | jax.Array = 0,
    tailbits: int | jax.Array = 0,
    code: CodeSpec = DEFAULT_CODE,
    params: FanoParams = FanoParams(),
    skip: jax.Array | None = None,
) -> FanoResult:
    """Decode (B, 2*nbits) soft symbols with the Fano algorithm.

    Args:
      symbols: (B, 2*nbits) or (2*nbits,) uint8 offset-binary symbols.
      mettab: (2, 256) int32 metric table from gen_met.
      nbits: frame length including the K-1 tail.
      encstate: starting encoder state (decode.c passes SYNCWORD & 0xffffff).
      tailbits: known tail sequence forced at the last K-1 nodes.
      code: static code spec.
      params: delta / maxcycles.
      skip: optional (B,) bool — lanes already decoded by a cheaper tier;
        they start as done (their FanoResult rows are meaningless) so a
        fully-skipped batch exits the walk immediately.

    Returns a FanoResult; ``goodbits == nbits`` signals success exactly as
    the reference's return value does (fano.c:38,204).

    Unjitted dispatch wrapper: the split between the packed fast walk
    (effective width < 30 state bits, e.g. MCQLI-24) and the split-word
    wide walk (MCQLI32 … J60) must happen BEFORE jit — a wide code's
    host-int encstate/tailbits would be truncated by jit's int32 scalar
    conversion.  Both cores are jitted.
    """
    if code.kbits + 1 >= 31:

        def pair(v):
            if isinstance(v, (int, np.integer)):
                lo, hi = _split64(int(v))
                return jnp.int32(lo), jnp.int32(hi)
            # device arrays carry at most the LOW word (no in-repo caller
            # passes device arrays for a wide code)
            return jnp.asarray(v, jnp.int32), jnp.zeros((), jnp.int32)

        return _fano_decode_wide(
            symbols, mettab, nbits, pair(encstate), pair(tailbits),
            code, params, skip,
        )
    return _fano_decode_packed(
        symbols, mettab, nbits, encstate, tailbits, code, params, skip
    )


def _metrics4(symbols: jax.Array, mettab: jax.Array, nbits: int) -> jax.Array:
    """(B, nbits, 4) branch metrics per node (fano.c:70-80)."""
    B = symbols.shape[0]
    mettab = jnp.asarray(mettab, jnp.int32)
    syms = symbols.astype(jnp.int32).reshape(B, nbits, 2)
    m_s0 = mettab[:, syms[..., 0]]  # (2, B, nbits)
    m_s1 = mettab[:, syms[..., 1]]
    return jnp.stack(
        [
            m_s0[0] + m_s1[0],
            m_s0[0] + m_s1[1],
            m_s0[1] + m_s1[0],
            m_s0[1] + m_s1[1],
        ],
        axis=-1,
    )


@functools.partial(jax.jit, static_argnames=("nbits", "code", "params"))
def _fano_decode_packed(
    symbols: jax.Array,
    mettab: jax.Array,
    nbits: int,
    encstate: int | jax.Array = 0,
    tailbits: int | jax.Array = 0,
    code: CodeSpec = DEFAULT_CODE,
    params: FanoParams = FanoParams(),
    skip: jax.Array | None = None,
) -> FanoResult:
    """The packed single-word walk (see fano_decode)."""
    if symbols.ndim == 1:
        symbols = symbols[None, :]
    B = symbols.shape[0]
    N = nbits
    k = code.k
    kb = code.kbits  # EFFECTIVE state width: unmasked-64-bit-state parity
    tail_start = N - (k - 1)  # first node of the tail zone (fano.c:66)
    delta = jnp.int32(params.delta)
    max_total = jnp.int32(params.maxcycles * nbits)
    metrics4 = _metrics4(symbols, mettab, N)

    start_enc = jnp.broadcast_to(jnp.asarray(encstate, jnp.int32), (B,))
    tailbits = jnp.broadcast_to(jnp.asarray(tailbits, jnp.int32), (B,))

    bidx = jnp.arange(B)

    def sort_branches(node_metrics, lsym):
        """Order the 0/1 branch metrics best-first (fano.c:95-104)."""
        m0 = node_metrics[bidx, lsym]
        m1 = node_metrics[bidx, 3 ^ lsym]
        better1 = m1 >= m0  # reference: m0 > m1 selects 0-branch first
        tm0 = jnp.where(better1, m1, m0)
        tm1 = jnp.where(better1, m0, m1)
        return tm0, tm1, better1.astype(jnp.int32)

    # ----- root node setup (fano.c:81-107) -----
    # The encoder-state hypothesis only matters mod 2^k: _makesyms masks
    # with the k-bit polynomials, branch toggles flip bit 0, and the
    # decoded output reads bit 0 per node.  Masking lets the 1-bit
    # branch index (ibr, always 0 or 1 — fano.c:182-186 increments only
    # from 0) pack into bit kb of the same word.  kb = CodeSpec.kbits,
    # the EFFECTIVE width: the reference's state is unmasked 64-bit, so
    # a polynomial longer than K still taps those bits (J50).
    encmask = jnp.int32((1 << kb) - 1)
    enc0 = (start_enc << 1) & encmask
    lsym0 = _makesyms(enc0, code)
    tm0_r, tm1_r, bit_r = sort_branches(metrics4[:, 0], lsym0)

    # The CURRENT node's record (gamma, sorted branch metrics, encoder
    # hypothesis, branch index) rides in per-lane REGISTERS in the scan
    # carry; the stride-8 array S is the PUSH-DOWN TAPE of the nodes
    # below it, with the STATIC 4-way branch metrics interleaved
    # alongside each record:
    #   S[:, 8i+0] = gamma_i   cumulative path metric   (written on push)
    #   S[:, 8i+1] = tm0_i     best branch metric       (written on push)
    #   S[:, 8i+2] = tm1_i     second branch metric     (written on push)
    #   S[:, 8i+3] = (ibr_i << k) | enc_i               (written on push)
    #   S[:, 8i+4..7] = metrics4[i]  (never written by the walk)
    # plus one trailing DUMP node (index N) so masked-off lanes scatter
    # there unconditionally — no read-modify-write.  A forward look only
    # needs the next node's metrics (4 lanes), a pop-run collapse only
    # the target node's record (4 lanes) — one mode-selected 4-wide
    # gather serves both.  D is the dense (B, N+1) collapse mirror (module docstring):
    # D[:, i] = (gamma_i << 1) | ibr_i, maintained by a second (1-wide)
    # push scatter and consumed by the two masked max-reductions that
    # resolve a whole backtrack inner loop at once.
    m4pad = jnp.concatenate(
        [metrics4.astype(jnp.int32), jnp.zeros((B, 1, 4), jnp.int32)], axis=1
    )
    S = jnp.concatenate(
        [jnp.zeros((B, N + 1, 4), jnp.int32), m4pad], axis=-1
    ).reshape(B, 8 * N + 8)
    D = jnp.zeros((B, N + 1), jnp.int32)
    node_j = jnp.arange(N + 1, dtype=jnp.int32)[None, :]

    def sel4(m4, s):
        """m4[b, s[b]] for s in {0..3} via selects instead of a
        per-row gather."""
        lo = jnp.where((s & 1) == 1, m4[:, 1], m4[:, 0])
        hi = jnp.where((s & 1) == 1, m4[:, 3], m4[:, 2])
        return jnp.where((s >> 1) & 1 == 1, hi, lo)

    class Carry(NamedTuple):
        np_idx: jax.Array
        t: jax.Array
        cycles: jax.Array
        done: jax.Array
        g: jax.Array  # current node's cumulative path metric
        tm0: jax.Array  # current node's best branch metric
        tm1: jax.Array  # current node's second branch metric
        enc: jax.Array  # current node's encoder-state hypothesis
        ibr: jax.Array  # current node's branch index (0 or 1)
        S: jax.Array  # (B, 8N+8) push-down tape + interleaved metrics
        D: jax.Array  # (B, N+1) dense (gamma << 1) | ibr collapse mirror

    zero = jnp.zeros((B,), jnp.int32)
    init = Carry(
        np_idx=zero,
        t=zero,
        cycles=zero,
        done=(
            jnp.zeros((B,), bool)
            if skip is None
            else jnp.broadcast_to(jnp.asarray(skip, bool), (B,))
        ),
        g=zero,
        tm0=tm0_r,
        tm1=tm1_r,
        enc=enc0 | bit_r,
        ibr=zero,
        S=S,
        D=D,
    )

    def cond(c: Carry):
        return ~jnp.all(c.done)

    def body(c: Carry) -> Carry:
        np_idx, t = c.np_idx, c.t
        active = ~c.done
        new_np = np_idx + 1

        # ---------- forward look (fano.c:117-166) ----------
        # Every active lane looks forward; register math only.
        tm_np = jnp.where(c.ibr == 0, c.tm0, c.tm1)
        ngamma = c.g + tm_np
        ok = ngamma >= t
        # threshold tightening on first visit (fano.c:121-130)
        tighten = ok & (c.g < t + delta)
        t_fwd = jnp.where(
            tighten, t + delta * ((ngamma - t) // delta), t
        )
        at_last = np_idx == (N - 1)
        newly_done = active & ok & at_last
        advance = active & ok & ~at_last
        violate = active & ~ok  # resolve the whole pop-run this step

        # ---------- pop-run collapse (fano.c:169-188) ----------
        # jr: deepest-from-top relax stop; jt: deepest-from-top toggle
        # candidate.  gamma[j] < t ⟺ D[j] < t<<1 (ibr is the LSB).
        below = node_j < np_idx[:, None]
        jr = jnp.max(
            jnp.where(below & (c.D < (t << 1)[:, None]), node_j, -1), axis=1
        )
        jt = jnp.max(
            jnp.where(
                below & (node_j < tail_start) & ((c.D & 1) == 0), node_j, -1
            ),
            axis=1,
        )
        do_toggle = violate & (jt > jr)
        do_relax = violate & ~(jt > jr)
        target = jnp.where(do_toggle, jt, jr + 1)  # node to resume at
        # relax at the current node (no pops): registers already hold it
        from_regs = do_relax & (target == np_idx)

        # ONE mode-selected 4-wide gather: advancing lanes fetch the
        # next node's interleaved branch metrics, collapsing lanes fetch
        # the resume target's tape record.
        gbase = jnp.where(
            advance,
            8 * jnp.clip(new_np, 0, N - 1) + 4,
            8 * jnp.clip(target, 0, N - 1),
        )
        gidx = gbase[:, None] + jnp.arange(4, dtype=jnp.int32)[None, :]
        g4 = jnp.take_along_axis(c.S, gidx, axis=1)
        # collapse-lane view of the gather (resume node's record)
        e_rec = g4[:, 3]
        base_g = jnp.where(from_regs, c.g, g4[:, 0])
        base_tm0 = jnp.where(from_regs, c.tm0, g4[:, 1])
        base_tm1 = jnp.where(from_regs, c.tm1, g4[:, 2])
        base_enc = jnp.where(from_regs, c.enc, e_rec & encmask)
        base_ibr = jnp.where(from_regs, c.ibr, e_rec >> kb)
        # advance-lane view
        m4 = g4

        adv_enc = (c.enc << 1) & encmask
        lsym = _makesyms(adv_enc, code)

        # tail zone (fano.c:141-147)
        in_tail = new_np >= tail_start
        tbit = (tailbits >> jnp.clip(N - new_np - 1, 0, 31)) & 1
        tail_tm0 = sel4(m4, (tbit * 3) ^ lsym)

        m0 = sel4(m4, lsym)
        m1 = sel4(m4, 3 ^ lsym)
        better1 = m1 >= m0
        sort_tm0 = jnp.where(better1, m1, m0)
        sort_tm1 = jnp.where(better1, m0, m1)
        sort_bit = jnp.where(better1, 1, 0)

        adv_tm0 = jnp.where(in_tail, tail_tm0, sort_tm0)
        adv_tm1 = jnp.where(in_tail, tail_tm0, sort_tm1)
        adv_bit = jnp.where(in_tail, tbit, sort_bit)

        # ---------- merge updates ----------
        np_next = jnp.where(advance, new_np, jnp.where(violate, target, np_idx))
        t_next = jnp.where(
            active & ok, t_fwd, jnp.where(do_relax, t - delta, t)
        )
        done_next = c.done | newly_done
        # Timeout parity with fano.c:110: the budget counts forward looks
        # (backtrack steps ride inside the same C loop iteration), and
        # the i<=maxcycles check happens at the TOP of the loop — a lane
        # whose last look violated still resolves its pop-run (this very
        # micro-step) before stopping, so its final state matches the
        # reference's forward-ready state exactly.
        cycles_next = c.cycles + active.astype(jnp.int32)
        timeout = ~done_next & active & (cycles_next >= max_total)
        done_next = done_next | timeout

        # ---------- register updates ----------
        # advance: registers become the new node's freshly sorted record;
        # toggle: the resume node's record switched to its 2nd branch;
        # relax: the resume node's record reset to its best branch (enc
        # LSB flips only if it sat on branch 1).
        g_next = jnp.where(advance, ngamma, jnp.where(violate, base_g, c.g))
        tm0_next = jnp.where(
            advance, adv_tm0, jnp.where(violate, base_tm0, c.tm0)
        )
        tm1_next = jnp.where(
            advance, adv_tm1, jnp.where(violate, base_tm1, c.tm1)
        )
        enc_next = jnp.where(
            advance,
            adv_enc | adv_bit,
            jnp.where(
                do_toggle,
                base_enc ^ 1,
                jnp.where(
                    do_relax,
                    base_enc ^ (base_ibr != 0).astype(jnp.int32),
                    c.enc,
                ),
            ),
        )
        ibr_next = jnp.where(
            advance,
            0,
            jnp.where(
                do_toggle,
                base_ibr + 1,
                jnp.where(do_relax, 0, c.ibr),
            ),
        )

        # push scatters: advancing lanes PUSH the current node's record
        # onto the tape (4-wide into S, 1-wide into the dense mirror D);
        # everyone else writes their dump slot.  Only fields 0..3 of a
        # stride-8 S record are written (the interleaved metrics at
        # 8i+4..7 stay static).
        w8 = jnp.where(advance, 8 * np_idx, 8 * N)
        sidx = w8[:, None] + jnp.arange(4, dtype=jnp.int32)[None, :]
        svals = jnp.stack(
            [c.g, c.tm0, c.tm1, (c.ibr << kb) | c.enc], axis=1
        )
        S_next = c.S.at[bidx[:, None], sidx].set(svals)
        D_next = c.D.at[
            bidx, jnp.where(advance, np_idx, N)
        ].set((c.g << 1) | c.ibr)

        return Carry(
            np_idx=np_next,
            t=t_next,
            cycles=cycles_next,
            done=done_next,
            g=g_next,
            tm0=tm0_next,
            tm1=tm1_next,
            enc=enc_next,
            ibr=ibr_next,
            S=S_next,
            D=D_next,
        )

    def body_unrolled(c: Carry) -> Carry:
        for _ in range(params.resolved_unroll()):
            c = body(c)
        return c

    final = jax.lax.while_loop(cond, body_unrolled, init)

    # tape records cover nodes 0..np-1; the current node's bit comes
    # from the enc register
    node_ids = jnp.arange(N, dtype=jnp.int32)[None, :]
    bits = jnp.where(
        node_ids == final.np_idx[:, None],
        (final.enc & 1)[:, None],
        final.S[:, 3 : 8 * N : 8] & 1,
    ).astype(jnp.uint8)
    goodbits = final.np_idx + 1
    # Partial-decode convention of fano.c:193-202 as used by decode.c:201:
    # only the first goodbits/8 FULL bytes of the path are copied out; the
    # caller's zero-filled buffer supplies the rest.  Zero everything past
    # that boundary so failed frames print exactly like the reference's.
    valid = jnp.arange(N, dtype=jnp.int32)[None, :] < ((goodbits // 8) * 8)[:, None]
    bits = jnp.where(valid, bits, 0).astype(jnp.uint8)
    metric = final.g  # the current node's path metric rides in registers
    return FanoResult(bits=bits, goodbits=goodbits, metric=metric, cycles=final.cycles)


def _split64(v) -> tuple[int, int]:
    """Host split of an arbitrary-precision int into two SIGNED int32
    words (lo = bits 0..31, hi = bits 32..63) for device bitwise math."""
    v = int(v) & ((1 << 64) - 1)

    def signed(x):
        return x - (1 << 32) if x >= (1 << 31) else x

    return signed(v & 0xFFFFFFFF), signed(v >> 32)


@functools.partial(jax.jit, static_argnames=("nbits", "code", "params"))
def _fano_decode_wide(
    symbols: jax.Array,
    mettab: jax.Array,
    nbits: int,
    enc_pair: tuple[jax.Array, jax.Array],
    tail_pair: tuple[jax.Array, jax.Array],
    code: CodeSpec,
    params: FanoParams,
    skip: jax.Array | None,
) -> FanoResult:
    """The register-carried Fano walk for K>30 codes (MCQLI32 … J60).

    Identical control flow to the packed fast path, but the encoder-state
    hypothesis is carried as TWO int32 words (lo = bits 0..31, hi = bits
    32..63) — the split-word form of fano.c's ``unsigned long long``
    state (fano.c:13-19) — and ibr gets its own tape field.  Tape records
    are stride 10: [gamma, tm0, tm1, enc_lo, enc_hi, ibr, metrics4[0..3]];
    each micro-step costs one mode-selected 6-wide gather and one 6-wide
    push scatter (vs 4-wide on the packed path — the price of 30 more
    state bits).  Not the perf path: the mission code is MCQLI-24.

    enc_pair / tail_pair are (lo, hi) int32 scalar-array pairs split
    host-side by the fano_decode wrapper (jit would truncate wide ints).
    """
    if symbols.ndim == 1:
        symbols = symbols[None, :]
    B = symbols.shape[0]
    metrics4 = _metrics4(symbols, mettab, nbits)
    N = nbits
    k = code.k
    kb = code.kbits
    assert kb <= 60, "split-word walk carries at most 60 encoder bits"
    tail_start = N - (k - 1)
    delta = jnp.int32(params.delta)
    max_total = jnp.int32(params.maxcycles * nbits)
    bidx = jnp.arange(B)

    # masks and polynomial words (host-side splits of k-bit constants)
    mask_lo, mask_hi = _split64((1 << kb) - 1)
    p1lo, p1hi = _split64(code.poly1)
    p2lo, p2hi = _split64(code.poly2)

    def makesyms2(lo, hi):
        s1 = ((_parity(lo & p1lo) ^ _parity(hi & p1hi)) << 1) ^ code.g1flip
        s2 = _parity(lo & p2lo) ^ _parity(hi & p2hi) ^ code.g2flip
        return s1 | s2

    def shl1(lo, hi):
        carry = (lo >> 31) & 1
        return (lo << 1) & mask_lo, ((hi << 1) | carry) & mask_hi

    def as_pair(v):
        lo, hi = v
        return (
            jnp.broadcast_to(jnp.asarray(lo, jnp.int32), (B,)),
            jnp.broadcast_to(jnp.asarray(hi, jnp.int32), (B,)),
        )

    start_lo, start_hi = as_pair(enc_pair)
    tail_lo, tail_hi = as_pair(tail_pair)

    def sort_branches(node_metrics, lsym):
        m0 = node_metrics[bidx, lsym]
        m1 = node_metrics[bidx, 3 ^ lsym]
        better1 = m1 >= m0
        tm0 = jnp.where(better1, m1, m0)
        tm1 = jnp.where(better1, m0, m1)
        return tm0, tm1, better1.astype(jnp.int32)

    def sel4(m4, s):
        lo = jnp.where((s & 1) == 1, m4[:, 1], m4[:, 0])
        hi = jnp.where((s & 1) == 1, m4[:, 3], m4[:, 2])
        return jnp.where((s >> 1) & 1 == 1, hi, lo)

    enc0_lo, enc0_hi = shl1(start_lo, start_hi)
    lsym0 = makesyms2(enc0_lo, enc0_hi)
    tm0_r, tm1_r, bit_r = sort_branches(metrics4[:, 0], lsym0)

    STRIDE = 10
    m4pad = jnp.concatenate(
        [metrics4.astype(jnp.int32), jnp.zeros((B, 1, 4), jnp.int32)], axis=1
    )
    S = jnp.concatenate(
        [jnp.zeros((B, N + 1, 6), jnp.int32), m4pad], axis=-1
    ).reshape(B, STRIDE * (N + 1))

    class CarryW(NamedTuple):
        np_idx: jax.Array
        t: jax.Array
        cycles: jax.Array
        mode: jax.Array
        done: jax.Array
        g: jax.Array
        tm0: jax.Array
        tm1: jax.Array
        enc_lo: jax.Array
        enc_hi: jax.Array
        ibr: jax.Array
        S: jax.Array

    zero = jnp.zeros((B,), jnp.int32)
    init = CarryW(
        np_idx=zero,
        t=zero,
        cycles=zero,
        mode=zero,
        done=(
            jnp.zeros((B,), bool)
            if skip is None
            else jnp.broadcast_to(jnp.asarray(skip, bool), (B,))
        ),
        g=zero,
        tm0=tm0_r,
        tm1=tm1_r,
        enc_lo=enc0_lo | bit_r,
        enc_hi=enc0_hi,
        ibr=zero,
        S=S,
    )

    def cond(c: CarryW):
        return ~jnp.all(c.done)

    def body(c: CarryW) -> CarryW:
        np_idx, t = c.np_idx, c.t
        fwd = (c.mode == 0) & ~c.done
        bwd = (c.mode == 1) & ~c.done

        back_np = np_idx - 1
        back_np_c = jnp.maximum(back_np, 0)
        new_np = np_idx + 1
        # mode-selected 6-wide gather: forward lanes read fields 4..9 of
        # the next node (hi, ibr, metrics4), backtrack lanes fields 0..5
        # of the back record (g, tm0, tm1, lo, hi, ibr)
        gbase = jnp.where(
            fwd, STRIDE * jnp.clip(new_np, 0, N - 1) + 4, STRIDE * back_np_c
        )
        gidx = gbase[:, None] + jnp.arange(6, dtype=jnp.int32)[None, :]
        g6 = jnp.take_along_axis(c.S, gidx, axis=1)
        # backtrack-lane view
        g_prev = g6[:, 0]
        tm0_b, tm1_b = g6[:, 1], g6[:, 2]
        lo_back, hi_back, back_ibr = g6[:, 3], g6[:, 4], g6[:, 5]
        # forward-lane view
        m4 = g6[:, 2:6]

        # ---------- forward look (fano.c:117-166) ----------
        tm_np = jnp.where(c.ibr == 0, c.tm0, c.tm1)
        ngamma = c.g + tm_np
        ok = ngamma >= t
        tighten = ok & (c.g < t + delta)
        t_fwd = jnp.where(tighten, t + delta * ((ngamma - t) // delta), t)
        at_last = np_idx == (N - 1)
        newly_done = fwd & ok & at_last
        advance = fwd & ok & ~at_last

        adv_lo, adv_hi = shl1(c.enc_lo, c.enc_hi)
        lsym = makesyms2(adv_lo, adv_hi)

        # tail zone (fano.c:141-147) — tail bit j may live in either word
        in_tail = new_np >= tail_start
        j = jnp.clip(N - new_np - 1, 0, 63)
        tbit = jnp.where(
            j < 32,
            (tail_lo >> jnp.clip(j, 0, 31)) & 1,
            (tail_hi >> jnp.clip(j - 32, 0, 31)) & 1,
        )
        tail_tm0 = sel4(m4, (tbit * 3) ^ lsym)

        m0 = sel4(m4, lsym)
        m1 = sel4(m4, 3 ^ lsym)
        better1 = m1 >= m0
        sort_tm0 = jnp.where(better1, m1, m0)
        sort_tm1 = jnp.where(better1, m0, m1)
        sort_bit = jnp.where(better1, 1, 0)

        adv_tm0 = jnp.where(in_tail, tail_tm0, sort_tm0)
        adv_tm1 = jnp.where(in_tail, tail_tm0, sort_tm1)
        adv_bit = jnp.where(in_tail, tbit, sort_bit)

        to_bwd = fwd & ~ok

        # ---------- one backtrack step (fano.c:169-188) ----------
        cant_back = (np_idx == 0) | (g_prev < t)
        relax = bwd & cant_back
        stepback = bwd & ~cant_back
        can_try = (back_np < tail_start) & (back_ibr != 1)
        toggle_next = stepback & can_try
        relax_flip = relax & (c.ibr != 0)

        # ---------- merge updates ----------
        np_next = jnp.where(advance, new_np, jnp.where(stepback, back_np, np_idx))
        t_next = jnp.where(fwd & ok, t_fwd, jnp.where(relax, t - delta, t))
        mode_next = jnp.where(to_bwd, 1, jnp.where(relax | toggle_next, 0, c.mode))
        done_next = c.done | newly_done
        cycles_next = c.cycles + fwd.astype(jnp.int32)
        timeout = ~done_next & (cycles_next >= max_total) & (mode_next == 0)
        done_next = done_next | timeout

        # ---------- register updates ----------
        g_next = jnp.where(advance, ngamma, jnp.where(stepback, g_prev, c.g))
        tm0_next = jnp.where(advance, adv_tm0, jnp.where(stepback, tm0_b, c.tm0))
        tm1_next = jnp.where(advance, adv_tm1, jnp.where(stepback, tm1_b, c.tm1))
        lo_next = jnp.where(
            advance,
            adv_lo | adv_bit,
            jnp.where(
                toggle_next,
                lo_back ^ 1,
                jnp.where(
                    stepback, lo_back, jnp.where(relax_flip, c.enc_lo ^ 1, c.enc_lo)
                ),
            ),
        )
        hi_next = jnp.where(
            advance, adv_hi, jnp.where(stepback, hi_back, c.enc_hi)
        )
        ibr_next = jnp.where(
            advance,
            0,
            jnp.where(
                toggle_next,
                back_ibr + 1,
                jnp.where(stepback, back_ibr, jnp.where(relax, 0, c.ibr)),
            ),
        )

        # 6-wide push scatter (advancing lanes write their slot, everyone
        # else the dump node)
        w = jnp.where(advance, STRIDE * np_idx, STRIDE * N)
        sidx = w[:, None] + jnp.arange(6, dtype=jnp.int32)[None, :]
        svals = jnp.stack(
            [c.g, c.tm0, c.tm1, c.enc_lo, c.enc_hi, c.ibr], axis=1
        )
        S_next = c.S.at[bidx[:, None], sidx].set(svals)

        return CarryW(
            np_idx=np_next,
            t=t_next,
            cycles=cycles_next,
            mode=mode_next,
            done=done_next,
            g=g_next,
            tm0=tm0_next,
            tm1=tm1_next,
            enc_lo=lo_next,
            enc_hi=hi_next,
            ibr=ibr_next,
            S=S_next,
        )

    def body_unrolled(c: CarryW) -> CarryW:
        for _ in range(params.resolved_unroll()):
            c = body(c)
        return c

    final = jax.lax.while_loop(cond, body_unrolled, init)

    node_ids = jnp.arange(N, dtype=jnp.int32)[None, :]
    bits = jnp.where(
        node_ids == final.np_idx[:, None],
        (final.enc_lo & 1)[:, None],
        final.S[:, 3 : STRIDE * N : STRIDE] & 1,
    ).astype(jnp.uint8)
    goodbits = final.np_idx + 1
    valid = jnp.arange(N, dtype=jnp.int32)[None, :] < ((goodbits // 8) * 8)[:, None]
    bits = jnp.where(valid, bits, 0).astype(jnp.uint8)
    return FanoResult(
        bits=bits, goodbits=goodbits, metric=final.g, cycles=final.cycles
    )
