"""Device times of the receive chain's layers, each run alone.

Measures, on the accelerator JAX finds, at the bench's shapes
(128 channels x 2,097,656 samples of int16 IQ, 4 frames each):

  * demod stages: pm carrier demod scan, prefix sum + symbol demod,
    the device decode tiers, and the whole one-dispatch chain;
  * the windowed carrier DFT against a float64 numpy FFT;
  * the XLA Fano walk: microseconds per forward look and while_loop
    iterations, tier 1 and tier 2, at 128 and 256 lanes, and the tier-2
    walk at several unroll depths;
  * ms per frame of the jnp and inplace K=24 Viterbi kernels at B=1, 4.

Every time is the minimum of several runs ending in block_until_ready,
after a warm-up call that compiles.  Prints one line per measurement
and, last, all of them as one JSON object.

Usage: python scripts/layer_times.py [--small]
(--small shrinks every shape for a CPU rehearsal; without it the script
refuses to run on the CPU.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

RESULTS: dict = {}


def report(name: str, value, **extra) -> None:
    RESULTS[name] = dict(value=value, **extra)
    print(f"{name}: {value} {extra if extra else ''}", flush=True)


def timed(fn, *args, reps: int = 5) -> tuple[float, object, float]:
    """(min warm seconds, last output, seconds of the first call)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts), out, first


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    small = args.small
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not small:
        raise SystemExit(f"no GPU (found {dev.platform}); use --small")
    from isee3_decoder_tpu.backends import card_name_and_power, enable_compile_cache

    enable_compile_cache()
    report("device", f"{dev.platform} {dev.device_kind} x{len(jax.devices())}")
    report("card", card_name_and_power())

    from isee3_decoder_tpu.config import (
        FRAMEBITS, FRAMESYMBOLS, MCQLI24, SYNC_STATE, SYNCBITS, SYNCWORD,
        CodeSpec,
    )
    from isee3_decoder_tpu.models.decode import DecodeConfig, decode_block_device
    from isee3_decoder_tpu.models.pipeline import (
        PipelineConfig, receive_block_device,
    )
    from isee3_decoder_tpu.models.symdemod import symdemod_scan
    from isee3_decoder_tpu.ops import carrier, fano, viterbi, viterbi_inplace
    from isee3_decoder_tpu.ops.encode import encode_bits
    from isee3_decoder_tpu.ops.symbols import SymConfig
    from isee3_decoder_tpu.ops.syncword import find_sync
    from isee3_decoder_tpu.utils import ebn0_to_noise, simulate, testsignal
    from isee3_decoder_tpu.utils.devicesignal import synthesize_iq_device

    samprate, symrate = 250_000.0, 1024.0
    nchan = 2 if small else 128
    nframes = 3 if small else 4
    nsamples = int((nframes * 2048 + 400) / symrate * samprate)
    cfg = PipelineConfig(
        pm=carrier.PMConfig(samprate=samprate, binsize=4.0, search_width=200.0),
        sym=SymConfig(samprate=samprate, symrate=symrate),
        decode=DecodeConfig(),
    )
    rng = np.random.default_rng(0)
    frames = testsignal.random_frames(rng, nframes)
    frames_dev = jnp.asarray(np.broadcast_to(frames, (nchan, *frames.shape)))
    carriers = jnp.asarray(20_000.0 + 137.0 * np.arange(nchan), jnp.float32)

    @jax.jit
    def to_raw(iq):
        ri = jnp.stack([iq.real, iq.imag], axis=-1).reshape(iq.shape[0], -1)
        return jnp.trunc(jnp.clip(ri, -32767.0, 32767.0)).astype(jnp.int16)

    # ---- demod stages, clean and threshold regimes ----
    n = cfg.pm.fftsize
    nblocks = nsamples // n
    for regime, noise in (("clean", 2500.0), ("threshold", 110000.0)):
        iq = synthesize_iq_device(
            frames_dev, carriers, jax.random.PRNGKey(1), nsamples,
            samprate=samprate, symrate=symrate, noise_std=noise,
        )
        raw = to_raw(iq)
        del iq
        blocks = raw[:, : nblocks * 2 * n].reshape(nchan, nblocks, 2 * n)
        pm = jax.jit(
            lambda b: carrier.pm_demod_scan(
                carrier.init_carry(nchan, cfg.pm), b, cfg.pm
            )
        )
        t, (_, pm_out), first = timed(pm, blocks, reps=3)
        report(f"{regime}.pm_demod_scan_s", t, compile_s=first - t)
        bb = jnp.swapaxes(pm_out.baseband, 0, 1).reshape(nchan, -1)
        nwin = max((nblocks * n - int(cfg.sym.symbolsamples / 2))
                   // int(cfg.sym.window * samprate) - 1, 0)
        sym = jax.jit(lambda x: symdemod_scan(x, cfg.sym, nwin)[1].soft)
        t, soft_w, first = timed(sym, bb, reps=3)
        report(f"{regime}.csum_symdemod_s", t, compile_s=first - t)
        soft = jnp.swapaxes(soft_w, 0, 1).reshape(nchan, -1)
        ss, _ = find_sync(soft[:, : FRAMESYMBOLS + SYNCBITS], FRAMESYMBOLS)
        f_avail = int((soft.shape[1] - int(ss.max()) - SYNCBITS) // FRAMESYMBOLS)
        dec = jax.jit(
            lambda s: decode_block_device(s, f_avail, FRAMESYMBOLS, cfg.decode)
        )
        t, _, first = timed(dec, soft, reps=3)
        report(f"{regime}.decode_device_s", t, compile_s=first - t,
               nframes=f_avail)
        chain = jax.jit(
            lambda r: receive_block_device(r, f_avail, FRAMESYMBOLS, cfg)
        )
        t, _, first = timed(chain, raw, reps=3)
        report(f"{regime}.receive_block_device_s", t, compile_s=first - t)
        del raw, blocks, pm_out, bb, soft_w, soft

    # ---- windowed carrier DFT against float64 numpy ----
    iq = synthesize_iq_device(
        frames_dev, carriers, jax.random.PRNGKey(4), n,
        samprate=samprate, symrate=symrate, noise_std=2500.0,
    )
    first = (jnp.trunc((carriers - 200.0) / cfg.pm.actual_binsize)
             .astype(jnp.int32))
    K = carrier._window_bins(cfg.pm)
    wb = jax.jit(lambda v, f: carrier.windowed_bins(v, f - 1, K, cfg.pm))
    t, S, _ = timed(wb, iq, first)
    full = np.fft.fft(np.asarray(iq, np.complex128), axis=-1)
    idx = np.asarray(first)[:, None] - 1 + np.arange(K)[None, :]
    Sref = np.take_along_axis(full, idx, axis=1)
    rel = np.abs(np.asarray(S) - Sref).max() / np.abs(Sref).max()
    peak_same = bool(
        (np.abs(np.asarray(S)).argmax(1) == np.abs(Sref).argmax(1)).all()
    )
    report("windowed_bins_s", t, rel_err=float(rel), peaks_equal=peak_same)

    # ---- Fano walk ----
    code = MCQLI24
    nbits = 256 if small else FRAMEBITS
    tail = SYNCWORD & ((1 << (code.k - 1)) - 1)
    mettab = jnp.asarray(cfg.decode.mettab())

    def fano_lanes(lanes, ebn0, seed):
        r = np.random.default_rng(seed)
        bits = r.integers(0, 2, (lanes, nbits), dtype=np.uint8)
        for j in range(code.k - 1):
            bits[:, nbits - 1 - j] = (tail >> j) & 1
        syms, _ = encode_bits(jnp.asarray(bits), SYNC_STATE, code)
        return simulate(jax.random.PRNGKey(seed), syms, 100.0,
                        ebn0_to_noise(100.0, ebn0))

    for lanes in ((8, 16) if small else (128, 256)):
        softs = fano_lanes(lanes, 2.0, lanes)
        for tier, params in (("tier1", cfg.decode.fano_params_tier1()),
                             ("tier2", cfg.decode.fano_params())):
            fn = jax.jit(lambda s, p=params: fano.fano_decode(
                s, mettab, nbits, SYNC_STATE, tail, code, p))
            t, res, first = timed(fn, softs, reps=3)
            cyc = int(np.asarray(res.cycles).max())
            u = params.resolved_unroll()
            report(f"fano.{tier}.lanes{lanes}.us_per_look", t / cyc * 1e6,
                   walk_s=t, max_cycles=cyc, unroll=u,
                   while_iterations=-(-cyc // u), compile_s=first - t,
                   decoded=int((np.asarray(res.goodbits) == nbits).sum()))
    lanes = 16 if small else 256
    softs = fano_lanes(lanes, 2.0, lanes)
    # XLA's CPU backend slows down super-linearly past unroll 2
    for u in ((1, 2) if small else (1, 2, 4, 8)):
        params = fano.FanoParams(delta=cfg.decode.fano_delta,
                                 maxcycles=cfg.decode.fano_maxcycles, unroll=u)
        fn = jax.jit(lambda s, p=params: fano.fano_decode(
            s, mettab, nbits, SYNC_STATE, tail, code, p))
        t, res, first = timed(fn, softs, reps=3)
        cyc = int(np.asarray(res.cycles).max())
        report(f"fano.tier2.lanes{lanes}.unroll{u}.us_per_look",
               t / cyc * 1e6, walk_s=t, max_cycles=cyc, compile_s=first - t)

    # ---- Viterbi fallback kernels ----
    vcode = CodeSpec("TESTK15", 0o46321, 0o51445, 15, 0, 1) if small else MCQLI24
    r = np.random.default_rng(5)
    bits = r.integers(0, 2, (4, FRAMEBITS), dtype=np.uint8)
    syms, _ = encode_bits(jnp.asarray(bits), SYNC_STATE & vcode.state_mask, vcode)
    vsoft = simulate(jax.random.PRNGKey(6), syms, 100.0, ebn0_to_noise(100.0, 1.5))
    outs = {}
    for B in (1, 4):
        for name, fn in (
            ("jnp", viterbi.decode_frame),
            ("inplace", viterbi_inplace.decode_frame_inplace),
        ):
            f = jax.jit(lambda s, fn=fn: fn(s, FRAMEBITS, SYNC_STATE, SYNC_STATE,
                                            vcode))
            t, out, first = timed(f, vsoft[:B], reps=3)
            outs[name, B] = np.asarray(out)
            report(f"viterbi.{name}.B{B}.ms_per_frame", t / B * 1e3,
                   compile_s=first - t)
        report(f"viterbi.B{B}.identical",
               bool((outs["jnp", B] == outs["inplace", B]).all()))

    report("card_after", card_name_and_power())
    print(json.dumps(RESULTS))


if __name__ == "__main__":
    main()
