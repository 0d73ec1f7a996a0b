"""Checkpoint/resume, decodeword, bitsync, and streaming-state tests."""

import numpy as np
import jax.numpy as jnp

from isee3_decoder_tpu.config import CodeSpec
from isee3_decoder_tpu.models import legacy
from isee3_decoder_tpu.ops import encode_bits, viterbi
from isee3_decoder_tpu.ops.carrier import PMConfig, init_carry, pm_demod_block
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu.utils.checkpoint import restore_pytree, save_pytree

K7 = CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0)


def test_viterbi_state_checkpoint_roundtrip(tmp_path):
    """A streaming decode interrupted mid-frame and restored from disk
    produces identical output — the checkpoint story the reference lacks
    (SURVEY.md §5.4)."""
    rng = np.random.default_rng(0)
    nbits = 120
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    bits[-(K7.k - 1):] = 0
    syms, _ = encode_bits(jnp.asarray(bits), 0, K7)
    soft = np.where(np.asarray(syms) > 0, 200, 56).astype(np.uint8)

    st = viterbi.create(nbits, 1, K7, 0)
    st = viterbi.update_blk(st, jnp.asarray(soft[:nbits]), K7)  # half the frame

    path = tmp_path / "vit_state.npz"
    save_pytree(path, st)
    st2 = restore_pytree(path, viterbi.create(nbits, 1, K7, 0))
    st2 = viterbi.ViterbiState(
        metrics=jnp.asarray(st2.metrics),
        decisions=jnp.asarray(st2.decisions),
        dp=jnp.asarray(st2.dp),
        renorm=jnp.asarray(st2.renorm),
    )
    st2 = viterbi.update_blk(st2, jnp.asarray(soft[nbits:]), K7)
    got = np.asarray(viterbi.chainback(st2, nbits, 0, K7))[0]
    np.testing.assert_array_equal(got, bits)


def test_pm_carry_checkpoint(tmp_path):
    cfg = PMConfig(samprate=32768.0, binsize=8.0, search_width=100.0)
    n = cfg.fftsize
    t = np.arange(2 * n)
    iq = 9000 * np.exp(1j * 2 * np.pi * 1500.0 * t / cfg.samprate)
    c = init_carry(1, cfg)
    c, _ = pm_demod_block(c, jnp.asarray(iq[:n])[None], cfg)
    save_pytree(tmp_path / "pm.npz", c)
    c2 = restore_pytree(tmp_path / "pm.npz", init_carry(1, cfg))
    _, out_a = pm_demod_block(c, jnp.asarray(iq[n:])[None], cfg)
    _, out_b = pm_demod_block(
        type(c)(*[jnp.asarray(x) for x in c2]), jnp.asarray(iq[n:])[None], cfg
    )
    np.testing.assert_array_equal(
        np.asarray(out_a.baseband), np.asarray(out_b.baseband)
    )


def test_decodeword():
    rng = np.random.default_rng(1)
    nbits = 150
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    bits[-(K7.k - 1):] = 0
    syms, _ = encode_bits(jnp.asarray(bits), 0, K7)
    soft = np.where(np.asarray(syms) > 0, 200, 56).astype(np.uint8)
    st = viterbi.create(nbits, 1, K7, 0)
    st = viterbi.update_blk(st, jnp.asarray(soft), K7)
    delay = 100
    w = np.asarray(viterbi.decodeword(st, delay, 0, K7))[0]
    # oldest-first: the deepest decision (delay steps back from trellis
    # step nbits-1) is input bit (nbits-1-(delay-1)) - (K-1)
    start = nbits - delay - K7.k + 1
    np.testing.assert_array_equal(w, bits[start : start + 64])


def test_bitsync_frames():
    # Uses the small K7 code so the CPU-side Viterbi stays fast; the
    # bitsync capability (timing search + phasing + streaming decode +
    # framing) is code-independent.
    rng = np.random.default_rng(2)
    # 4 frames: the first framed window includes Viterbi warm-up garbage
    # (as with the real vdecode startup), so require a *clean* later
    # frame to match.
    frames = testsignal.random_frames(rng, 4)
    syms = testsignal.frames_to_symbols(frames, K7)
    samprate, symrate = 16384.0, 1024.0
    wave = testsignal.manchester_waveform(syms, samprate / symrate)
    samples = (900.0 * wave + rng.normal(0, 60, len(wave))).astype(np.int16)
    res = legacy.bitsync_frames(samples, samprate, symrate, decode_delay=100, code=K7)
    assert len(res.frames) >= 2
    matched = sum(
        1 for fr in res.frames if any(np.array_equal(fr, f) for f in frames)
    )
    assert matched >= 1


def test_inplace_stream_state_checkpoint_roundtrip(tmp_path):
    """The rotating-layout streaming decoder's circular-tape state survives
    a save/restore mid-stream: the resumed decoder emits the same
    fixed-delay bits as an uninterrupted run."""
    from isee3_decoder_tpu.config import CodeSpec
    from isee3_decoder_tpu.ops import viterbi_inplace as vip

    K15 = CodeSpec("TESTK15", 0o46321, 0o51445, 15, 0, 1)
    w = K15.k - 1
    rng = np.random.default_rng(9)
    nbits, delay, chunk = 280, 40, 10 * w  # two cycle-aligned chunks
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    syms, _ = encode_bits(jnp.asarray(bits), 0, K15)
    soft = np.where(np.asarray(syms) > 0, 200, 56).astype(np.uint8)

    def run(st, start):
        outs = []
        done = start
        while done < nbits:
            n = min(chunk, nbits - done)
            st = vip.stream_update(
                st, jnp.asarray(soft[2 * done : 2 * (done + n)]), K15
            )
            lo = max(delay - done, 0)
            if n - lo > 0:
                outs.append(np.asarray(vip.stream_decodebits(st, delay, n - lo, K15)))
            done += n
        return st, outs

    # uninterrupted
    st_ref, outs_ref = run(vip.stream_create(2 * chunk, 1, K15, 0), 0)
    want = np.concatenate(outs_ref, axis=1)

    # interrupted after the first chunk, checkpointed, resumed
    st1, outs1 = run(vip.stream_create(2 * chunk, 1, K15, 0), 0)
    st_half = vip.stream_create(2 * chunk, 1, K15, 0)
    st_half = vip.stream_update(st_half, jnp.asarray(soft[: 2 * chunk]), K15)
    path = tmp_path / "inplace_stream.npz"
    save_pytree(path, st_half)
    restored = restore_pytree(path, vip.stream_create(2 * chunk, 1, K15, 0))
    restored = type(st_half)(**{
        k: jnp.asarray(getattr(restored, k))
        for k in ("metrics", "decisions", "dp", "total", "renorm")
    })
    _, outs_resumed = run(restored, chunk)
    got = np.concatenate(
        [np.asarray(vip.stream_decodebits(st_half, delay, chunk - delay, K15))]
        + outs_resumed,
        axis=1,
    )
    np.testing.assert_array_equal(got, want)


def test_checkpoint_manifest_validation(tmp_path):
    """The versioned manifest (format 2) rejects structure/shape/dtype
    drift instead of silently unflattening wrong state."""
    import pytest

    from isee3_decoder_tpu.utils.checkpoint import load_manifest

    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"c": np.ones(4, np.float32)}}
    p = tmp_path / "state.npz"
    save_pytree(p, tree)

    man = load_manifest(p)
    assert man["format_version"] == 2
    assert man["nleaves"] == 2
    assert man["leaves"][0]["dtype"] == "int32"
    assert man["leaves"][0]["shape"] == [2, 3]

    # happy path round-trips
    out = restore_pytree(p, {"a": np.zeros((2, 3), np.int32),
                             "b": {"c": np.zeros(4, np.float32)}})
    np.testing.assert_array_equal(out["a"], tree["a"])

    # wrong shape
    with pytest.raises(ValueError, match="shape"):
        restore_pytree(p, {"a": np.zeros((3, 2), np.int32),
                           "b": {"c": np.zeros(4, np.float32)}})
    # wrong dtype
    with pytest.raises(ValueError, match="dtype"):
        restore_pytree(p, {"a": np.zeros((2, 3), np.int64),
                           "b": {"c": np.zeros(4, np.float32)}})
    # wrong structure (renamed key -> different keypath)
    with pytest.raises(ValueError, match="path"):
        restore_pytree(p, {"a": np.zeros((2, 3), np.int32),
                           "z": {"c": np.zeros(4, np.float32)}})
    # wrong leaf count
    with pytest.raises(ValueError, match="leaves"):
        restore_pytree(p, {"a": np.zeros((2, 3), np.int32)})
