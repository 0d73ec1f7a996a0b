"""Benchmark: full receive-chain throughput, reported as 250 ksps
channels decodable in real time per card.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Baseline: the reference C chain processes (optimistically) one 250 ksps
channel in real time on a CPU core when Fano succeeds, and falls behind
real time whenever the Viterbi fallback engages (CHANGES:9).  We
normalize vs_baseline against 1.0 channel.

IQ is synthesized on the device (frame bytes are the only upload).  The
benchmark measures the GPU only: it exits non-zero when JAX finds none.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def main() -> None:
    import jax

    from isee3_decoder_tpu.backends import (
        card_name_and_power,
        enable_compile_cache,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {dev.platform}")
    enable_compile_cache()
    import jax.numpy as jnp

    from isee3_decoder_tpu.models import decode as _dec_mod
    from isee3_decoder_tpu.models.decode import DecodeConfig
    from isee3_decoder_tpu.models.pipeline import PipelineConfig, demod_to_symbols
    from isee3_decoder_tpu.ops.carrier import PMConfig
    from isee3_decoder_tpu.ops.symbols import SymConfig
    from isee3_decoder_tpu.utils import testsignal
    from isee3_decoder_tpu.utils.devicesignal import synthesize_iq_device

    small = os.environ.get("BENCH_SMALL", "") == "1"
    samprate = 250_000.0
    symrate = 1024.0
    # Override with BENCH_NCHAN.
    nchan = 4 if small else int(os.environ.get("BENCH_NCHAN", "128"))
    nframes = 3 if small else int(os.environ.get("BENCH_NFRAMES", "4"))
    seconds = (nframes * 2048 + 400) / symrate  # frames + slack
    nsamples = int(seconds * samprate)

    rng = np.random.default_rng(0)
    frames = testsignal.random_frames(rng, nframes)
    frames_dev = jnp.asarray(np.broadcast_to(frames, (nchan, *frames.shape)))
    carriers = jnp.asarray(20_000.0 + 137.0 * np.arange(nchan), jnp.float32)

    cfg = PipelineConfig(
        pm=PMConfig(samprate=samprate, binsize=4.0, search_width=200.0),
        sym=SymConfig(samprate=samprate, symrate=symrate),
        decode=DecodeConfig(
            # middle tier: algebraic correction of scattered errors on
            # the quicklook candidate — near-clean mid-SNR frames skip
            # the serial Fano walk.  This is also the DecodeConfig
            # default, so the headline measures the configuration users
            # get out of the box
            qlec=os.environ.get("BENCH_QLEC", "1") == "1",
            # tier-1 lockstep cycle cap (cycles/bit); the lockstep walk
            # spins until its slowest lane finishes, so this bounds the
            # straggler cost (stragglers re-run compacted at full budget)
            fano_tier1_maxcycles=int(os.environ.get("BENCH_TIER1", "12")),
        ),
    )

    def prewarm_fallback_shapes():
        """Compile every decode-fallback program shape BEFORE any timed
        region: tier-2 Fano / Viterbi variants compiling inside the
        timed loops made the threshold number unstable.

        Shapes: the tier-2 Fano walk at every pow2 straggler batch,
        warmed with instantly-decodable clean codewords, and the Viterbi
        kernel at its chunk sizes.
        """
        from isee3_decoder_tpu.config import FRAMEBITS, SYNC_STATE, SYNCWORD
        from isee3_decoder_tpu.models.decode import _viterbi_decode
        from isee3_decoder_tpu.ops.fano import fano_decode

        prng = np.random.default_rng(7)
        wframes = testsignal.random_frames(prng, 1)
        syms = np.asarray(testsignal.frames_to_symbols(wframes))[: 2 * FRAMEBITS]
        soft1 = np.where(syms > 0, 228, 28).astype(np.uint8)
        tail = SYNCWORD & ((1 << (cfg.decode.code.k - 1)) - 1)
        mettab = jnp.asarray(cfg.decode.mettab())
        vbatch = jnp.asarray(
            np.broadcast_to(soft1, (8, soft1.size))
        )
        from isee3_decoder_tpu.models.decode import (
            _finish_frames as _ff,
        )

        for chunk in (1, 2, 4):
            vb = _viterbi_decode(vbatch[:chunk], cfg.decode)
            jax.block_until_ready(_ff(jnp.asarray(vb)))
        # every pow2 batch of the tier-2 entry path (the unjitted pad
        # wrappers trace a tiny program per distinct caller batch) and
        # of the failed-lane device gather — otherwise the first block
        # with a novel straggler count compiles INSIDE the timed loop
        from isee3_decoder_tpu.models.decode import (
            _finish_frames,
            _gather_failed_lanes,
        )

        starts_fake = np.zeros((nchan * 8,), np.int64)
        for k in range(9):
            b = 1 << k
            sub = np.arange(b) % (nchan * 8)
            _gather_failed_lanes(starts_fake, soft, sub, 8)
            if b <= 256:
                r = fano_decode(
                    jnp.asarray(np.broadcast_to(soft1, (b, soft1.size))),
                    mettab, FRAMEBITS, SYNC_STATE, tail,
                    cfg.decode.code, cfg.decode.fano_params(),
                )
                # the patch paths' device-side finish (byte pack +
                # verify) at every pow2 straggler batch
                jax.block_until_ready(_finish_frames(r.bits))

    key = jax.random.PRNGKey(0)
    noise_clean = float(os.environ.get("BENCH_NOISE_STD", "2500"))
    # mid-SNR regime (C/N0 ≈ 31 dB-Hz): quicklook rejects and the REAL
    # Fano walks run — the honest decode-tier cost
    noise_mid = float(os.environ.get("BENCH_NOISE_STD2", "50000"))
    # Fano-threshold regime (C/N0 ≈ 21.6 dB-Hz): some Fano walks time
    # out and the Viterbi fallback ENGAGES — the reference's worst case
    # (CHANGES:9,21).
    noise_thr = float(os.environ.get("BENCH_NOISE_STD3", "110000"))

    def synth(frames_dev, key, noise_std):
        # noise_std is a static arg of the jitted synthesizer: one
        # compile per regime (clean + mid-SNR), both off the clock
        return synthesize_iq_device(
            frames_dev, carriers, key, nsamples,
            samprate=samprate, symrate=symrate,
            noise_std=noise_std,
        )

    @jax.jit
    def to_raw(iq):
        # int16 interleaved I,Q — the reference's recording format
        # (pmdemod.c:206-230); the chain ingests this directly (half the
        # device-memory bytes of complex64).
        ri = jnp.stack([iq.real, iq.imag], axis=-1).reshape(iq.shape[0], -1)
        return jnp.trunc(jnp.clip(ri, -32767.0, 32767.0)).astype(jnp.int16)

    @jax.jit
    def demod_sum(iq):
        soft, bb, freq, cn0 = demod_to_symbols(iq, cfg)
        return soft, soft.sum(dtype=jnp.int32), cn0[-1].min()

    # Warmup / compile
    iq = to_raw(synth(frames_dev, key, noise_clean))
    soft, chk, cn0_min = jax.block_until_ready(demod_sum(iq))
    t0 = time.perf_counter()
    prewarm_fallback_shapes()
    t_prewarm = time.perf_counter() - t0

    # Time synth alone
    t0 = time.perf_counter()
    iq = jax.block_until_ready(to_raw(synth(frames_dev, key, noise_clean)))
    t_synth = time.perf_counter() - t0

    # Time demod directly on the device-resident IQ
    t0 = time.perf_counter()
    soft, chk, cn0_min = jax.block_until_ready(demod_sum(iq))
    t_demod = max(time.perf_counter() - t0, 1e-9)

    t0 = time.perf_counter()
    soft_np = np.asarray(soft)
    t_fetch = time.perf_counter() - t0

    # Decode in throughput mode: ONE fused device program does the sync
    # search, the quicklook tier, the lockstep Fano over channels×frames,
    # verify and byte packing; the host pays a single packed fetch, plus
    # the (rare) batched Viterbi fallback (models/decode.decode_block).
    from isee3_decoder_tpu.config import FRAMESYMBOLS, SYNCBITS
    from isee3_decoder_tpu.models.decode import (
        DECODER_FANO,
        DECODER_QLEC,
        DECODER_QUICKLOOK,
        DECODER_VITERBI,
        decode_block,
    )
    from isee3_decoder_tpu.ops.syncword import find_sync

    ss, _ = find_sync(soft[:, : FRAMESYMBOLS + SYNCBITS], FRAMESYMBOLS)
    ss_np = np.asarray(ss, np.int64)
    S = soft_np.shape[1]
    f_avail = int((S - ss_np.max() - SYNCBITS) // FRAMESYMBOLS)
    decode_block(soft, f_avail, cfg.decode)  # warmup/compile
    t0 = time.perf_counter()
    rec, _ = decode_block(soft, f_avail, cfg.decode)
    t_decode = time.perf_counter() - t0

    # The ENTIRE chain (demod → sync → decode) as ONE fused device
    # program with a single packed fetch (models/pipeline.receive_block)
    # — the one-program form of the 3-process pipe chain.
    from isee3_decoder_tpu.models.pipeline import (
        receive_block,
        receive_blocks_pipelined,
    )

    receive_block(iq, f_avail, cfg)  # warmup/compile
    t0 = time.perf_counter()
    rec, _ = receive_block(iq, f_avail, cfg)
    t_chain = time.perf_counter() - t0

    # Headline: steady-state DOUBLE-BUFFERED block stream — block k+1's
    # device program is dispatched before block k's packed buffer is
    # fetched, overlapping the fetch with compute.
    npipe = 3 if small else int(os.environ.get("BENCH_PIPE_BLOCKS", "4"))
    keys = jax.random.split(key, npipe)
    iqs = [to_raw(synth(frames_dev, k, noise_clean)) for k in keys]
    jax.block_until_ready(iqs)  # synthesis off the clock
    recs = []
    t0 = time.perf_counter()
    for r, _ss in receive_blocks_pipelined(iqs, f_avail, cfg):
        recs.append(r)
    t_pipe = time.perf_counter() - t0
    t_block = t_pipe / npipe
    rec = recs[-1]

    total_samples = nchan * nsamples
    samples_per_sec = total_samples / t_block
    channels_realtime = samples_per_sec / samprate

    def frame_stats(r):
        d = r.data.reshape(nchan, f_avail, -1)
        g = r.good.reshape(nchan, f_avail)
        m = sum(
            1
            for ch in range(nchan)
            for f in range(f_avail)
            if g[ch, f] and any(np.array_equal(d[ch, f], fr) for fr in frames)
        )
        return int(r.good.sum()), m

    ngood, nmatched = frame_stats(rec)

    # Mid-SNR regime: same compiled programs (noise is a traced arg),
    # real Fano walks + (rare) Viterbi fallbacks engage.  Measured with
    # the SAME double-buffered block-stream driver as the headline, so
    # the two regimes differ only in decode-tier work, not methodology.
    keys_m = jax.random.split(jax.random.PRNGKey(99), npipe)
    iqs_m = [to_raw(synth(frames_dev, k, noise_mid)) for k in keys_m]
    jax.block_until_ready(iqs_m)  # synthesis off the clock
    receive_block(iqs_m[0], f_avail, cfg)  # warm host fallback paths
    t0 = time.perf_counter()
    rec_m, _ = receive_block(iqs_m[0], f_avail, cfg)
    t_mid_serial = time.perf_counter() - t0
    recs_m = []
    t0 = time.perf_counter()
    for r, _ss in receive_blocks_pipelined(iqs_m, f_avail, cfg):
        recs_m.append(r)
    t_mid = (time.perf_counter() - t0) / npipe
    rec_m = recs_m[-1]
    # free this regime's device-resident IQ before synthesizing the next
    # (each block is ~1 GB at 128 ch)
    del iqs_m
    ngood_m, nmatched_m = frame_stats(rec_m)
    chan_rt_mid = total_samples / t_mid / samprate

    # Threshold regime: same driver, noise at the Fano cliff so the
    # Viterbi fallback does real work on every block.
    del iqs
    keys_t = jax.random.split(jax.random.PRNGKey(1234), npipe)
    iqs_t = [to_raw(synth(frames_dev, k, noise_thr)) for k in keys_t]
    jax.block_until_ready(iqs_t)
    # cold vs warm: with every fallback shape
    # prewarmed, the first block should already be within noise of the
    # steady state — record both so drift is visible in the artifact
    t0 = time.perf_counter()
    receive_block(iqs_t[0], f_avail, cfg)
    t_thr_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    receive_block(iqs_t[0], f_avail, cfg)
    t_thr_serial = time.perf_counter() - t0
    # one untimed pass over ALL blocks first: each distinct noise
    # realization's first visit still pays one-time work the shape
    # prewarm can't reach (e.g. persistent-cache loads).  The timed pass
    # below is the steady-state number a long-running receiver sees; the first-pass
    # time is reported alongside so the drift stays visible.
    t0 = time.perf_counter()
    for _r, _ss in receive_blocks_pipelined(iqs_t, f_avail, cfg):
        pass
    t_thr_first = (time.perf_counter() - t0) / npipe
    recs_t = []
    t0 = time.perf_counter()
    for r, _ss in receive_blocks_pipelined(iqs_t, f_avail, cfg):
        recs_t.append(r)
    t_thr = (time.perf_counter() - t0) / npipe
    rec_t = recs_t[-1]
    ngood_t, nmatched_t = frame_stats(rec_t)
    chan_rt_thr = total_samples / t_thr / samprate

    # Wideband regime: ONE synthetic wide capture carrying all nchan
    # carriers → polyphase channelizer → the same fused receive chain,
    # as one device program.  Per-channel
    # length 2^21 (8.389 s) keeps the 2^28-point wide FFTs power-of-two.
    wide_detail = None
    if os.environ.get("BENCH_WIDEBAND", "1") == "1" and not small:
        from isee3_decoder_tpu.models.pipeline import receive_block_wideband
        from isee3_decoder_tpu.utils.devicesignal import (
            synthesize_wideband_device,
        )

        del iqs_t  # free the threshold blocks before the wide FFTs

        @jax.jit
        def to_raw_wide(w):
            # PACKED int32 IQ (I low half, Q high half) — byte-identical
            # to the interleaved int16 recording, one word per sample
            i_p = jnp.trunc(jnp.clip(jnp.real(w), -32767.0, 32767.0))
            q_p = jnp.trunc(jnp.clip(jnp.imag(w), -32767.0, 32767.0))
            return (i_p.astype(jnp.int32) & 0xFFFF) | (
                q_p.astype(jnp.int32) << 16
            )

        Lw = 1 << 21
        # amplitude scaled to the capture's 16-bit dynamic range (the
        # nchan carriers sum; at the per-channel default the wide
        # waveform would clip ~4x over full scale and the
        # intermodulation knocks out whole channels) — noise scales
        # with it so per-channel C/N0 matches the clean regime
        w_amp = min(12_000.0, 30_000.0 / nchan)
        wide = synthesize_wideband_device(
            frames_dev, carriers, jax.random.PRNGKey(5), Lw, nchan,
            samprate=samprate, symrate=symrate,
            amplitude=w_amp, noise_std=noise_clean * w_amp / 12_000.0,
        )
        wraw = to_raw_wide(wide)
        del wide
        jax.block_until_ready(wraw)
        receive_block_wideband(wraw, nchan, f_avail, cfg)  # warm
        t0 = time.perf_counter()
        rec_w, _ssw = receive_block_wideband(wraw, nchan, f_avail, cfg)
        t_wide = time.perf_counter() - t0
        ngood_w, nmatched_w = frame_stats(rec_w)
        del wraw
        wide_detail = {
            "realtime_channels": round(nchan * Lw / t_wide / samprate, 2),
            "t_block_s": round(t_wide, 3),
            "frames_good": ngood_w,
            "frames_matched": nmatched_w,
            "frames_possible": f_avail * nchan,
        }
    dec_t = {
        "quicklook": 0,
        "qlec": 0,
        "fano": 0,
        "viterbi": 0,
    }
    for r in recs_t:
        dec_t["quicklook"] += int((r.decoder == DECODER_QUICKLOOK).sum())
        dec_t["qlec"] += int((r.decoder == DECODER_QLEC).sum())
        dec_t["fano"] += int((r.decoder == DECODER_FANO).sum())
        dec_t["viterbi"] += int((r.decoder == DECODER_VITERBI).sum())

    payload = {
        "metric": "realtime_250ksps_channels_per_chip",
        "value": round(channels_realtime, 2),
        "unit": "channels",
        "vs_baseline": round(channels_realtime / 1.0, 2),
        "detail": {
            "demod_Msamples_per_s": round(samples_per_sec / 1e6, 2),
            "t_synth_s": round(t_synth, 3),
            "t_demod_s": round(t_demod, 3),
            "t_decode_s": round(t_decode, 3),
            "t_chain_s": round(t_chain, 3),
            "t_block_pipelined_s": round(t_block, 3),
            "pipeline_speedup": round(t_chain / t_block, 2),
            "t_fetch_s": round(t_fetch, 3),
            "nchan": nchan,
            "seconds_per_chan": round(seconds, 2),
            "frames_good": ngood,
            "frames_matched": nmatched,
            "frames_possible": f_avail * nchan,
            "min_cn0_db": round(float(cn0_min), 1),
            "decoders": {
                "quicklook": int((rec.decoder == DECODER_QUICKLOOK).sum()),
                "qlec": int((rec.decoder == DECODER_QLEC).sum()),
                "fano": int((rec.decoder == DECODER_FANO).sum()),
                "viterbi": int((rec.decoder == DECODER_VITERBI).sum()),
            },
            # honest decode-tier regime: C/N0 ≈ 31 dB-Hz, quicklook
            # rejects, lockstep Fano does real threshold walks
            "noisy": {
                "realtime_channels": round(chan_rt_mid, 2),
                "noise_std": noise_mid,
                "t_block_pipelined_s": round(t_mid, 3),
                "t_chain_s": round(t_mid_serial, 3),
                "frames_good": ngood_m,
                "frames_matched": nmatched_m,
                "frames_possible": f_avail * nchan,
                "decoders": {
                    "quicklook": int((rec_m.decoder == DECODER_QUICKLOOK).sum()),
                    "qlec": int((rec_m.decoder == DECODER_QLEC).sum()),
                    "fano": int((rec_m.decoder == DECODER_FANO).sum()),
                    "viterbi": int((rec_m.decoder == DECODER_VITERBI).sum()),
                },
            },
            # Fano-threshold regime: the reference's worst case — Fano
            # times out on a share of frames and the Viterbi fallback
            # engages (decoders.viterbi counts all npipe blocks)
            "threshold": {
                "realtime_channels": round(chan_rt_thr, 2),
                "noise_std": noise_thr,
                "t_block_pipelined_s": round(t_thr, 3),
                "t_block_firstpass_s": round(t_thr_first, 3),
                "t_block_cold_s": round(t_thr_cold, 3),
                "t_chain_s": round(t_thr_serial, 3),
                "frames_good": ngood_t,
                "frames_matched": nmatched_t,
                "frames_possible": f_avail * nchan,
                "decoders": dec_t,
            },
            "wideband": wide_detail,
            "prewarm_s": round(t_prewarm, 3),
            # honest cost of shape-bounded Viterbi batching: frames
            # decoded only to pad a partial chunk
            "viterbi_frames_padded": _dec_mod.VITERBI_FRAMES_PADDED,
            "backend": jax.default_backend(),
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "card": card_name_and_power(),
            "viterbi_backend": cfg.decode.viterbi_backend,
        },
    }
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
