"""Frame-batched throughput decode mode."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from isee3_decoder_tpu.models.decode import (
    DECODER_FANO,
    DECODER_QUICKLOOK,
    DecodeConfig,
    decode_block,
    decode_frames_batch,
)
from isee3_decoder_tpu.ops.syncword import find_sync
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu.utils.sim import simulate


def test_decode_frames_batch_multichannel():
    rng = np.random.default_rng(0)
    nframes = 3
    frames = testsignal.random_frames(rng, nframes + 1)
    syms = testsignal.frames_to_symbols(frames)
    sig, noise = 81.65, 40.0
    B = 3
    streams = []
    offs = [5, 20, 33]  # keep off+2014 within the 2048-position search
    key = jax.random.PRNGKey(0)
    for b in range(B):
        key, sub = jax.random.split(key)
        soft = np.asarray(simulate(sub, jnp.asarray(syms), sig, noise))
        streams.append(np.concatenate([np.full(offs[b], 128, np.uint8), soft]))
    maxlen = max(len(s) for s in streams)
    stream = np.stack([np.pad(s, (0, maxlen - len(s)), constant_values=128) for s in streams])

    # acquire sync: first full sync is at off + 2048-34 (end of frame 1)
    ss, _ = find_sync(jnp.asarray(stream[:, :4096]), 2048)
    ss = np.asarray(ss, np.int64)
    want_ss = np.array(offs) + 2048 - 34
    np.testing.assert_array_equal(ss, want_ss)

    # qlec off: this test pins the FANO path (with the default config the
    # scattered ~6 dB errors would be absorbed by the quicklook-EC tier)
    rec = decode_frames_batch(stream, ss, nframes, DecodeConfig(qlec=False))
    assert rec.good.all()
    data = rec.data.reshape(B, nframes, 128)
    for b in range(B):
        for f in range(nframes):
            # frame 0 of the batch is tx frame 1 (frame 0 precedes sync)
            np.testing.assert_array_equal(data[b, f], frames[f + 1])
    # at ~6 dB every frame has hard-decision symbol errors, so the
    # quicklook tier must reject and the Fano walk must decode
    assert (rec.decoder == DECODER_FANO).all()


def _synth_streams(rng, key, nframes, B, offs, sig, noise):
    frames = testsignal.random_frames(rng, nframes + 1)
    syms = testsignal.frames_to_symbols(frames)
    streams = []
    for b in range(B):
        key, sub = jax.random.split(key)
        soft = np.asarray(simulate(sub, jnp.asarray(syms), sig, noise))
        streams.append(np.concatenate([np.full(offs[b], 128, np.uint8), soft]))
    maxlen = max(len(s) for s in streams)
    stream = np.stack(
        [np.pad(s, (0, maxlen - len(s)), constant_values=128) for s in streams]
    )
    return frames, stream


def test_quicklook_tier_decodes_clean_frames():
    """Error-free lanes take the quicklook fast path; its bits match the
    transmitted frames exactly (so Fano would have produced the same)."""
    rng = np.random.default_rng(4)
    nframes = 2
    frames = testsignal.random_frames(rng, nframes + 1)
    syms = np.asarray(testsignal.frames_to_symbols(frames))
    soft = np.where(syms > 0, 228, 28).astype(np.uint8)  # clean, amp 100
    stream = soft[None, :]
    ss, _ = find_sync(jnp.asarray(stream[:, :4096]), 2048)
    rec = decode_frames_batch(stream, np.asarray(ss, np.int64), nframes)
    assert rec.good.all()
    assert (rec.decoder == DECODER_QUICKLOOK).all()
    assert (rec.fano_cycles == 0).all()
    data = rec.data.reshape(nframes, 128)
    for f in range(nframes):
        np.testing.assert_array_equal(data[f], frames[f + 1])

    # same input with quicklook disabled must agree bit-for-bit via Fano
    rec2 = decode_frames_batch(
        stream, np.asarray(ss, np.int64), nframes, DecodeConfig(quicklook=False)
    )
    assert (rec2.decoder == DECODER_FANO).all()
    np.testing.assert_array_equal(rec2.data, rec.data)


def test_decode_block_fused_matches_batch():
    """The single-dispatch fused block decode (sync search + tiered decode
    + packed fetch) returns the same frames as the two-step path."""
    rng = np.random.default_rng(5)
    nframes = 2
    frames, stream = _synth_streams(
        rng, jax.random.PRNGKey(7), nframes, 2, [11, 29], 81.65, 40.0
    )
    ss_ref, _ = find_sync(jnp.asarray(stream[:, : 2048 + 34]), 2048)
    rec_ref = decode_frames_batch(
        stream, np.asarray(ss_ref, np.int64), nframes
    )
    rec, ss = decode_block(stream, nframes)
    np.testing.assert_array_equal(ss, np.asarray(ss_ref, np.int64))
    np.testing.assert_array_equal(rec.data, rec_ref.data)
    np.testing.assert_array_equal(rec.good, rec_ref.good)
    np.testing.assert_array_equal(rec.decoder, rec_ref.decoder)
    np.testing.assert_array_equal(rec.fano_cycles, rec_ref.fano_cycles)
    np.testing.assert_array_equal(rec.start_symbol, rec_ref.start_symbol)
    assert rec.good.all()
    data = rec.data.reshape(2, nframes, 128)
    for b in range(2):
        for f in range(nframes):
            np.testing.assert_array_equal(data[b, f], frames[f + 1])


def test_batch_shape_bounded_chunking():
    """The dynamic-subset chunker only ever invokes the decode fn at
    batch sizes {1, 2, chunk}, pads tails by repetition, and reassembles
    results in order."""
    from isee3_decoder_tpu.models.decode import batch_shape_bounded

    calls = []

    def fn(part):
        calls.append(int(part.shape[0]))
        return part * 2

    for B in (1, 2, 3, 4, 5, 6, 7, 9):
        calls.clear()
        x = jnp.arange(B * 3, dtype=jnp.int32).reshape(B, 3)
        out = np.asarray(batch_shape_bounded(fn, x, chunk=4))
        np.testing.assert_array_equal(out, np.asarray(x) * 2)
        assert set(calls) <= {1, 2, 4}, f"B={B}: calls {calls}"


def _crush(stream, ss, ch, frame, rng, sigma=30.0):
    """Re-noise the middle of one frame so Fano times out (tail left
    intact so later sync positions stay correlatable)."""
    lo = int(ss[ch]) + 34 + frame * 2048 + 180
    hi = lo + 1400
    stream[ch, lo:hi] = np.clip(
        rng.normal(128, sigma, hi - lo), 0, 255
    ).astype(np.uint8)


@pytest.mark.slow
def test_viterbi_prev_frame_gating_on_batch_path():
    """decode.c:209-214 previous-frame gating on the batch path
    (VERDICT r1 #6): frame f falls back to Viterbi only when frame f-1 of
    the same channel decoded; -p removes the gate."""
    from isee3_decoder_tpu.models.decode import DECODER_VITERBI

    rng = np.random.default_rng(17)
    nframes = 3
    frames, stream = _synth_streams(
        rng, jax.random.PRNGKey(21), nframes, 2, [7, 7], 81.65, 18.0
    )
    ss = np.array([7 + 2048 - 34, 7 + 2048 - 34], np.int64)
    _crush(stream, ss, 0, 1, rng)  # ch0: good, CRUSHED, good
    _crush(stream, ss, 1, 0, rng)  # ch1: CRUSHED, good, good

    cfg = DecodeConfig(quicklook=False)
    assert not cfg.persistent
    rec = decode_frames_batch(stream, ss, nframes, cfg)
    dec = rec.decoder.reshape(2, nframes)
    good = rec.good.reshape(2, nframes)
    # ch0 frame1: previous frame decoded → Viterbi fallback ran
    assert dec[0].tolist() == [DECODER_FANO, DECODER_VITERBI, DECODER_FANO]
    assert good[0, 0] and good[0, 2]
    # ch1 frame0: no previous lock → Viterbi DENIED, frame stays bad Fano
    assert dec[1].tolist() == [DECODER_FANO, DECODER_FANO, DECODER_FANO]
    assert not good[1, 0] and good[1, 1] and good[1, 2]

    # -p persistent: the denied lane now gets its Viterbi attempt
    rec_p = decode_frames_batch(
        stream, ss, nframes, dataclasses_replace(cfg, persistent=True)
    )
    dec_p = rec_p.decoder.reshape(2, nframes)
    assert dec_p[1, 0] == DECODER_VITERBI
    assert dec_p[0, 1] == DECODER_VITERBI
    # the persistent and gated runs agree wherever both ran the same
    # decoders
    same = rec.decoder == rec_p.decoder
    np.testing.assert_array_equal(rec.data[same], rec_p.data[same])


def dataclasses_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


def test_fano_two_tier_matches_single_budget():
    """Two-tier Fano scheduling (low lockstep cap + full-budget re-run of
    stragglers) produces the same frames/goodness as one full-budget
    pass; a dead (pure noise) channel exercises the tier-2 path."""
    import dataclasses

    rng = np.random.default_rng(11)
    nframes = 2
    frames = testsignal.random_frames(rng, nframes + 1)
    syms = testsignal.frames_to_symbols(frames)
    key = jax.random.PRNGKey(3)
    soft = np.asarray(simulate(key, jnp.asarray(syms), 81.65, 47.0))  # ~4.5 dB
    # marginal channel: noisy enough that the walk outlives the tier-1
    # cap on at least one frame yet still decodes within the full budget
    soft_marginal = np.asarray(
        simulate(jax.random.PRNGKey(13), jnp.asarray(syms), 81.65, 66.0)
    )
    noise = rng.integers(0, 256, soft.shape[0], dtype=np.uint8)
    stream = np.stack([soft, noise, soft_marginal])
    ss = np.array([2048 - 34, 0, 2048 - 34], np.int64)

    cfg_tier = DecodeConfig(viterbi_enabled=False, quicklook=False)
    assert cfg_tier.fano_tier1_maxcycles is not None
    cfg_flat = dataclasses.replace(cfg_tier, fano_tier1_maxcycles=None)

    from isee3_decoder_tpu.config import FRAMEBITS

    rec_t = decode_frames_batch(stream, ss, nframes, cfg_tier)
    rec_f = decode_frames_batch(stream, ss, nframes, cfg_flat)
    np.testing.assert_array_equal(rec_t.good, rec_f.good)
    np.testing.assert_array_equal(rec_t.data, rec_f.data)
    np.testing.assert_array_equal(rec_t.decoder, rec_f.decoder)
    np.testing.assert_array_equal(rec_t.fano_cycles, rec_f.fano_cycles)
    # channel 0's frames decode, channel 1 (noise) fails in both schedules
    good2 = rec_t.good.reshape(3, nframes)
    assert good2[0].all() and not good2[1].any()
    # the straggler re-ran at the full budget: its cycle count reflects
    # the fano_maxcycles timeout, not the tier-1 cap
    cyc2 = rec_t.fano_cycles.reshape(3, nframes)
    assert (cyc2[1] >= cfg_tier.fano_maxcycles * FRAMEBITS).all()
    # the marginal channel proves the interesting tier-2 contract: at
    # least one frame exceeds the tier-1 cap but SUCCEEDS at full budget
    t1_cap = cfg_tier.fano_tier1_maxcycles * FRAMEBITS
    rescued = (cyc2[2] > t1_cap) & good2[2]
    assert rescued.any(), f"tune noise: cycles {cyc2[2]}, good {good2[2]}"


def test_qlec_tier_matches_fano_on_scattered_errors():
    """The middle (quicklook-EC) tier corrects scattered symbol errors
    and its accepted frames are bit-identical to the Fano decode of the
    same symbols (VERDICT r3 next #3)."""
    from isee3_decoder_tpu.models.decode import DECODER_QLEC

    rng = np.random.default_rng(11)
    nframes = 2
    frames = testsignal.random_frames(rng, nframes + 1)
    syms = np.asarray(testsignal.frames_to_symbols(frames))
    soft = np.where(syms > 0, 228, 28).astype(np.uint8)
    # scatter a few well-separated symbol errors inside each frame
    # (> K pairs apart so every burst is isolated)
    for pos in (2500, 2700, 3100, 3900, 4700, 5600):
        soft[pos] = 255 - soft[pos]
    stream = soft[None, :]
    ss, _ = find_sync(jnp.asarray(stream[:, :4096]), 2048)

    cfg_ec = DecodeConfig(qlec=True)
    rec = decode_frames_batch(stream, np.asarray(ss, np.int64), nframes, cfg_ec)
    assert rec.good.all()
    assert (rec.decoder == DECODER_QLEC).any(), "no lane took the EC tier"
    assert (rec.fano_cycles == 0).all()

    # oracle: the full Fano walk on the same stream
    rec_f = decode_frames_batch(
        stream, np.asarray(ss, np.int64), nframes,
        DecodeConfig(quicklook=False),
    )
    np.testing.assert_array_equal(rec.data, rec_f.data)
    data = rec.data.reshape(nframes, 128)
    for f in range(nframes):
        np.testing.assert_array_equal(data[f], frames[f + 1])


def test_qlec_rejects_unexplained_residuals():
    """Dense/bursty corruption must NOT be accepted by the EC tier —
    those lanes fall through to the Fano walk unchanged."""
    from isee3_decoder_tpu.models.decode import DECODER_QLEC

    rng = np.random.default_rng(12)
    nframes = 1
    frames = testsignal.random_frames(rng, nframes + 1)
    syms = np.asarray(testsignal.frames_to_symbols(frames))
    soft = np.where(syms > 0, 228, 28).astype(np.uint8)
    # a dense error clump (several errors inside one constraint length)
    for pos in range(3000, 3030, 3):
        soft[pos] = 255 - soft[pos]
    stream = soft[None, :]
    ss, _ = find_sync(jnp.asarray(stream[:, :4096]), 2048)
    cfg_ec = DecodeConfig(qlec=True)
    rec = decode_frames_batch(stream, np.asarray(ss, np.int64), nframes, cfg_ec)
    # Fano (or its tiers) must still decode it correctly; the EC label
    # must not appear with a clump it cannot exactly explain
    rec_f = decode_frames_batch(
        stream, np.asarray(ss, np.int64), nframes, DecodeConfig(quicklook=False)
    )
    np.testing.assert_array_equal(rec.data, rec_f.data)


def test_qlec_device_block_matches_batch_path():
    """The fused device decode (decode_block) with qlec enabled returns
    the same frames/labels as the host-orchestrated batch path."""
    from isee3_decoder_tpu.models.decode import decode_block

    rng = np.random.default_rng(13)
    nframes = 2
    frames = testsignal.random_frames(rng, nframes + 1)
    syms = np.asarray(testsignal.frames_to_symbols(frames))
    soft = np.where(syms > 0, 228, 28).astype(np.uint8)
    for pos in (2600, 3300, 4100, 5200):
        soft[pos] = 255 - soft[pos]
    stream = soft[None, :]
    ss, _ = find_sync(jnp.asarray(stream[:, :4096]), 2048)
    cfg_ec = DecodeConfig(qlec=True)

    rec_b = decode_frames_batch(stream, np.asarray(ss, np.int64), nframes, cfg_ec)
    rec_d, _ss = decode_block(jnp.asarray(stream), nframes, cfg_ec)
    np.testing.assert_array_equal(rec_d.data, rec_b.data)
    np.testing.assert_array_equal(rec_d.decoder, rec_b.decoder)
    np.testing.assert_array_equal(rec_d.good, rec_b.good)


def test_viterbi_backend_is_checked():
    """Only the XLA Viterbi kernels can be selected."""
    from isee3_decoder_tpu.models.decode import DecodeConfig, _viterbi_decode

    cfg = DecodeConfig(viterbi_backend="fused")
    with pytest.raises(ValueError, match="viterbi_backend"):
        _viterbi_decode(jnp.zeros((1, 2 * 1024), jnp.uint8), cfg)
