"""In-place (rotating layout) Viterbi kernel vs the reference kernel."""

import numpy as np
import jax.numpy as jnp
import pytest

from isee3_decoder_tpu.config import MCQLI24, CodeSpec
from isee3_decoder_tpu.ops import encode_bits, viterbi
from isee3_decoder_tpu.ops import viterbi_inplace as vip

K15 = CodeSpec("TESTK15", 0o46321, 0o51445, 15, 0, 1)


def noisy_frame(rng, code, nbits):
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    bits[-(code.k - 1):] = 0
    syms, _ = encode_bits(jnp.asarray(bits), 0, code)
    noisy = np.clip(
        np.where(np.asarray(syms) > 0, 170, 86).astype(np.int32)
        + rng.integers(-80, 80, 2 * nbits),
        0, 255,
    ).astype(np.uint8)
    return bits, noisy


@pytest.mark.parametrize("nbits", [9, 14, 16, 28, 32, 37, 42, 64, 96])
def test_inplace_matches_reference_k15(nbits):
    """Sub-cycle, cycle-aligned and remainder lengths, noisy symbols."""
    rng = np.random.default_rng(nbits)
    bits, noisy = noisy_frame(rng, K15, nbits)
    want = np.asarray(viterbi.decode_frame(jnp.asarray(noisy), nbits, 0, 0, K15))
    got = np.asarray(vip.decode_frame_inplace(jnp.asarray(noisy), nbits, 0, 0, K15))
    np.testing.assert_array_equal(got, want)


def test_inplace_batched_k15():
    rng = np.random.default_rng(0)
    B, nbits = 3, 60
    streams, bits_all = [], []
    for _ in range(B):
        bits, noisy = noisy_frame(rng, K15, nbits)
        streams.append(noisy)
        bits_all.append(bits)
    noisy = jnp.asarray(np.stack(streams))
    want = np.asarray(viterbi.decode_frame(noisy, nbits, 0, 0, K15))
    got = np.asarray(vip.decode_frame_inplace(noisy, nbits, 0, 0, K15))
    np.testing.assert_array_equal(got, want)


def test_inplace_nonzero_boundary_states():
    rng = np.random.default_rng(5)
    nbits = 46
    start = 0x1ABC & K15.state_mask
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    syms, endstate = encode_bits(jnp.asarray(bits), start, K15)
    end = int(endstate) & K15.state_mask
    soft = np.where(np.asarray(syms) > 0, 200, 56).astype(np.uint8)
    got = np.asarray(
        vip.decode_frame_inplace(jnp.asarray(soft), nbits, start, end, K15)
    )
    np.testing.assert_array_equal(got[0], bits)


def test_inplace_mcqli24_smoke():
    rng = np.random.default_rng(7)
    nbits = 48
    bits, noisy = noisy_frame(rng, MCQLI24, nbits)
    got = np.asarray(
        vip.decode_frame_inplace(jnp.asarray(noisy), nbits, 0, 0, MCQLI24)
    )
    want = np.asarray(
        viterbi.decode_frame(jnp.asarray(noisy), nbits, 0, 0, MCQLI24)
    )
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], bits)


def test_final_metrics_match_after_unpermute():
    rng = np.random.default_rng(9)
    nbits = 45  # non-multiple of W=14
    _, noisy = noisy_frame(rng, K15, nbits)
    st = viterbi.create(nbits, 1, K15, 0, jnp.int16)
    st = viterbi.update_blk(st, jnp.asarray(noisy), K15)
    ref_m = np.asarray(st.metrics)[0]
    ref_m = ref_m - ref_m.min()

    metrics0 = jnp.full((1, K15.nstates), viterbi.START_BIAS, jnp.int16)
    metrics0 = metrics0.at[0, 0].set(0)
    m, decs, total = vip.update_frame_inplace(metrics0, jnp.asarray(noisy), nbits, K15)
    m = np.asarray(m)[0]
    m = m - m.min()
    # position of state s: rotr^(nbits mod W)
    s = np.arange(K15.nstates)
    pos = np.asarray(vip.state_position(s, nbits, K15))
    np.testing.assert_array_equal(m[pos], ref_m)


def test_streaming_fast_kernel_matches_classic():
    """Rotating-layout streaming mode (bounded circular tape, chunked
    feeding) reproduces the classic kernel's fixed-delay outputs."""
    rng = np.random.default_rng(21)
    nbits, delay = 300, 60
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    syms, _ = encode_bits(jnp.asarray(bits), 0, K15)
    soft = np.where(np.asarray(syms) > 0, 200, 56).astype(np.uint8)

    st = vip.stream_create(163 + delay + 1, 1, K15, 0)
    outs, done = [], 0
    for chunk in (37, 100, 163):
        st = vip.stream_update(st, jnp.asarray(soft[2 * done : 2 * (done + chunk)]), K15)
        done += chunk
        lo = max(delay - (done - chunk), 0)
        if chunk - lo > 0:
            outs.append(np.asarray(vip.stream_decodebits(st, delay, chunk - lo, K15)))
    got = np.concatenate(outs, axis=1)

    st2 = viterbi.create(nbits, 1, K15, 0)
    st2 = viterbi.update_blk(st2, jnp.asarray(soft), K15)
    want = np.asarray(viterbi.streaming_decodebits(st2, delay, K15))
    np.testing.assert_array_equal(got, want)


def test_inplace_batched_nonzero_states():
    """A batch of noisy frames with a nonzero start state decodes like
    the reference kernel."""
    rng = np.random.default_rng(1)
    B, nbits = 2, 30
    rx = jnp.asarray(np.stack([noisy_frame(rng, K15, nbits)[1] for _ in range(B)]))
    start, end = 0x0AAA & K15.state_mask, 0
    want = np.asarray(viterbi.decode_frame(rx, nbits, start, end, K15))
    got = np.asarray(vip.decode_frame_inplace(rx, nbits, start, end, K15))
    np.testing.assert_array_equal(got, want)


def test_inplace_batched_metrics_match():
    """Per-row final path metrics of a batch, unpermuted, equal the
    reference kernel's up to each row's normalization."""
    rng = np.random.default_rng(7)
    B, nbits = 3, 48
    rx = jnp.asarray(np.stack([noisy_frame(rng, K15, nbits)[1] for _ in range(B)]))
    st = viterbi.create(nbits, B, K15, 0, jnp.int16)
    st = viterbi.update_blk(st, rx, K15)
    ref = np.asarray(st.metrics).astype(np.int64)
    metrics0 = jnp.full((B, K15.nstates), viterbi.START_BIAS, jnp.int16)
    metrics0 = metrics0.at[:, 0].set(0)
    m, _, _ = vip.update_frame_inplace(metrics0, rx, nbits, K15)
    m = np.asarray(m).astype(np.int64)
    pos = np.asarray(vip.state_position(np.arange(K15.nstates), nbits, K15))
    for b in range(B):
        np.testing.assert_array_equal(
            m[b, pos] - m[b].min(), ref[b] - ref[b].min()
        )


def test_streaming_cycle_aligned_erasure_padded():
    """Streaming with cycle-aligned chunks and an erasure-padded final
    chunk (skipped by stream_decodebits) reproduces the classic
    kernel's fixed-delay outputs."""
    rng = np.random.default_rng(22)
    w = K15.k - 1  # 14
    nbits, delay = 300, 60
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    syms, _ = encode_bits(jnp.asarray(bits), 0, K15)
    soft = np.where(np.asarray(syms) > 0, 200, 56).astype(np.uint8)

    chunk = 10 * w  # 140
    st = vip.stream_create(2 * chunk, 1, K15, 0)
    outs, done = [], 0
    while done < nbits:
        n = min(chunk, nbits - done)
        npad = -(-n // w) * w
        block = np.full((1, 2 * npad), 128, np.uint8)
        block[0, : 2 * n] = soft[2 * done : 2 * (done + n)]
        st = vip.stream_update(st, jnp.asarray(block), K15)
        lo = max(delay - done, 0)
        if n - lo > 0:
            outs.append(np.asarray(
                vip.stream_decodebits(st, delay, n - lo, K15, skip=npad - n)
            ))
        done += n
    got = np.concatenate(outs, axis=1)

    st2 = viterbi.create(nbits, 1, K15, 0)
    st2 = viterbi.update_blk(st2, jnp.asarray(soft), K15)
    want = np.asarray(viterbi.streaming_decodebits(st2, delay, K15))
    np.testing.assert_array_equal(got, want)
