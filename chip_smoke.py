"""Smoke test of the receive chain on a GPU, through its entry points.

Runs, in one process, at the bench's widths (128 channels x 2,097,656
samples = 8.39 s at 250 ksps, 4 frames each, int16 IQ synthesized on
the card from --seed):

  1 clean      two blocks through receive_blocks_pipelined; every frame
               good and equal to one its channel transmitted.
  2 threshold  two blocks at noise_std 110000, so tier-2 Fano and the
               Viterbi fallback run; at least one Viterbi frame.  Every
               untransmitted good frame (a frame error that still ends in
               the syncword), every Viterbi frame of the channels below
               and two more Viterbi frames equal the native C decoder's
               bytes.  Per block, 4 channels (first those holding an
               untransmitted Fano frame, then the longest walks) run again
               on jax.devices("cpu") with the fallback off (a K=24 frame
               costs XLA's CPU backend minutes): soft symbols within 1 LSB
               in at most 0.1 % of positions, carriers within 0.01 Hz,
               identical frames, flags and decoder labels on every lane
               with the same symbols, and the card's Viterbi lanes failing
               the Fano tiers there too.
  3 kernels    the Viterbi fallback kernel on 4 noisy K=24 frames against
               the native C decoder, bit for bit; the Fano walk on 256
               lanes x 1024 bits at the cliff against the same walk on
               the CPU; the windowed carrier DFT against a float64 FFT.
  4 wideband   one packed-int32 capture of 128 carriers through
               receive_block_wideband; every frame good and transmitted.
  5 pipe       pmdemod | symdemod | decode as three processes over a
               10 s single-channel recording; every frame after the
               first equal to a transmitted one.

With --four-cards it runs only the four-card phase: receive_block_sharded
over a 4-card channel mesh (4 x 128 channels at the mid-SNR noise_std
50000, where the Fano walks run) against the single-card
receive_block_device on each quarter, and a K=24 frame decoded on a
(1, 4) state mesh against the single-card decode.

Each phase prints its name, seconds, checks and the card's name and
power limit.  Any failed check raises.  The last line of stdout is
{"ok": true, "device": {...}} with the device JAX reports.  On a machine
without a GPU it exits non-zero and prints no result.

Usage: python chip_smoke.py [--four-cards] [--seed N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# allocate on demand: the pipe phase runs three more JAX processes on
# the card beside this one
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")

import numpy as np  # noqa: E402

SAMPRATE, SYMRATE = 250_000.0, 1024.0
NCHAN, NFRAMES = 128, 4
NSAMPLES = int((NFRAMES * 2048 + 400) / SYMRATE * SAMPRATE)  # 8.39 s
NOISE_CLEAN, NOISE_MID, NOISE_THRESHOLD = 2500.0, 50000.0, 110000.0
FANO_LANES = 256
CARD = "unknown"


def check(cond, what: str) -> str:
    if not cond:
        raise AssertionError(f"check failed: {what}")
    return what


def run_phase(name: str, fn) -> None:
    print(f"phase {name}: start", flush=True)
    t0 = time.perf_counter()
    checks = fn()
    dt = time.perf_counter() - t0
    print(f"phase {name}: {dt:.1f} s | card {CARD}", flush=True)
    for c in checks:
        print(f"  ok: {c}", flush=True)


class Chain:
    """Signals and configuration shared by the single-card phases."""

    def __init__(self, seed: int, nchan: int = NCHAN, nsamples: int = NSAMPLES):
        import jax
        import jax.numpy as jnp

        from isee3_decoder_tpu.models.pipeline import PipelineConfig
        from isee3_decoder_tpu.ops.carrier import PMConfig
        from isee3_decoder_tpu.ops.symbols import SymConfig
        from isee3_decoder_tpu.utils import testsignal

        self.seed, self.nchan, self.nsamples = seed, nchan, nsamples
        self.cfg = PipelineConfig(
            pm=PMConfig(samprate=SAMPRATE, binsize=4.0, search_width=200.0),
            sym=SymConfig(samprate=SAMPRATE, symrate=SYMRATE),
        )
        rng = np.random.default_rng(seed)
        self.frames = testsignal.random_frames(rng, nchan * NFRAMES).reshape(
            nchan, NFRAMES, -1
        )
        self.frames_dev = jnp.asarray(self.frames)
        self.carriers = jnp.asarray(
            20_000.0 + 137.0 * np.arange(nchan), jnp.float32
        )
        self.nframes = self.frames_available(
            jax.ShapeDtypeStruct((nchan, 2 * nsamples), jnp.int16)
        )

    def frames_available(self, spec, wide_nchan: int | None = None) -> int:
        """Frames every channel can decode whatever its sync offset."""
        import jax

        from isee3_decoder_tpu.config import FRAMESYMBOLS, SYNCBITS
        from isee3_decoder_tpu.models import pipeline

        if wide_nchan is None:
            fn = lambda x: pipeline.demod_to_symbols(x, self.cfg)[0]  # noqa: E731
        else:
            fn = lambda x: pipeline.receive_wideband_device_soft(  # noqa: E731
                x, wide_nchan, 1, FRAMESYMBOLS, self.cfg
            )[1]
        S = jax.eval_shape(fn, spec).shape[1]
        return (S - FRAMESYMBOLS - SYNCBITS + 1) // FRAMESYMBOLS

    def raw_block(self, key: int, noise: float):
        """(nchan, 2 * nsamples) int16 interleaved IQ made on the card."""
        import jax
        import jax.numpy as jnp

        from isee3_decoder_tpu.utils.devicesignal import synthesize_iq_device

        iq = synthesize_iq_device(
            self.frames_dev, self.carriers, jax.random.PRNGKey(key),
            self.nsamples, samprate=SAMPRATE, symrate=SYMRATE, noise_std=noise,
        )
        ri = jnp.stack([iq.real, iq.imag], axis=-1).reshape(self.nchan, -1)
        return jnp.trunc(jnp.clip(ri, -32767.0, 32767.0)).astype(jnp.int16)

    def matched(self, rec, chans=None) -> np.ndarray:
        """(nch, nframes) bool: frame equals one its channel transmitted."""
        tx = self.frames if chans is None else self.frames[chans]
        d = rec.data.reshape(tx.shape[0], -1, 1, tx.shape[-1])
        return (d == tx[:, None]).all(-1).any(-1)


def phase_clean(ch: Chain) -> list[str]:
    from isee3_decoder_tpu.models.pipeline import receive_blocks_pipelined

    iqs = [ch.raw_block(k, NOISE_CLEAN) for k in (1, 2)]
    recs = [r for r, _ in receive_blocks_pipelined(iqs, ch.nframes, ch.cfg)]
    n = ch.nchan * ch.nframes
    out = []
    for i, rec in enumerate(recs):
        out.append(check(rec.good.all(), f"block {i}: {n}/{n} frames good"))
        out.append(check(ch.matched(rec).all(),
                         f"block {i}: every frame transmitted"))
    return out


def phase_threshold(ch: Chain) -> list[str]:
    import jax

    from isee3_decoder_tpu.config import FRAMEBITS, FRAMESYMBOLS, SYNC_STATE, SYNCBITS
    from isee3_decoder_tpu.models.decode import DECODER_FANO, DECODER_VITERBI
    from isee3_decoder_tpu.models.pipeline import (
        _finish_block,
        receive_block_device_soft,
    )
    from isee3_decoder_tpu.ops.carrier import init_carry, pm_demod_scan
    from isee3_decoder_tpu.utils import native

    cpu = jax.devices("cpu")[0]
    shape = (ch.nchan, ch.nframes)
    code = ch.cfg.decode.code
    n = ch.cfg.pm.fftsize
    # A K=24 Viterbi frame costs XLA's CPU backend minutes, so the CPU
    # runs with the fallback off; the card's Viterbi frames are checked
    # against the native C decoder instead.
    cfg_cpu = dataclasses.replace(
        ch.cfg, decode=dataclasses.replace(ch.cfg.decode, viterbi_enabled=False)
    )

    def run(x, cfg):
        """receive_block, keeping the soft symbols."""
        buf, soft = receive_block_device_soft(x, ch.nframes, FRAMESYMBOLS, cfg)
        return _finish_block(buf, soft, x.shape[0], ch.nframes, cfg)[0], soft

    @jax.jit
    def carriers(x):
        blocks = x[:, : x.shape[1] // (2 * n) * 2 * n].reshape(x.shape[0], -1, 2 * n)
        return pm_demod_scan(init_carry(x.shape[0], ch.cfg.pm), blocks,
                             ch.cfg.pm)[1].carrier_freq

    def c_decode(soft, rec, c, f):
        st = int(rec.start_symbol[c * ch.nframes + f])
        return np.packbits(native.viterbi_decode_frame(
            soft[c, st : st + FRAMESYMBOLS], FRAMEBITS, SYNC_STATE, SYNC_STATE,
            code))

    out = []
    nvit = 0
    tier1_cap = ch.cfg.decode.fano_params_tier1().maxcycles * FRAMEBITS
    for i, key in enumerate((3, 4)):
        iq = ch.raw_block(key, NOISE_THRESHOLD)
        rec, soft = run(iq, ch.cfg)
        soft_np = np.asarray(soft)
        dec = rec.decoder.reshape(shape)
        good = rec.good.reshape(shape)
        data = rec.data.reshape(*shape, -1)
        vit = dec == DECODER_VITERBI
        nvit += int(vit.sum())
        tier2 = (dec == DECODER_FANO) & (rec.fano_cycles.reshape(shape) > tier1_cap)
        out.append(f"block {i}: {int(good.sum())}/{good.size} frames good;"
                   f" {int((dec == DECODER_FANO).sum())} Fano"
                   f" ({int(tier2.sum())} past the tier-1 cap),"
                   f" {int(vit.sum())} Viterbi")
        # At the Fano cliff a frame with errors can still end in the
        # syncword, the only check the reference makes (decode.c:237-247).
        # Such a good frame that its channel did not send passes only if a
        # reference makes the same bytes of the same symbols: the native C
        # decoder for Viterbi frames, the CPU run below for the others.
        bad = good & ~ch.matched(rec)
        # The CPU reruns 4 channels at a time: first those holding such
        # frames, then those whose walks ran longest.
        rank = np.lexsort((-np.where(dec == DECODER_FANO,
                                     rec.fano_cycles.reshape(shape), 0).sum(1),
                           -(tier2 | vit).sum(1), -(bad & ~vit).sum(1)))
        need = int((bad & ~vit).any(1).sum())
        chans = np.sort(rank[: max(4, -(-need // 4) * 4)])
        # the native C decoder on every untransmitted Viterbi frame, every
        # Viterbi frame of the rerun channels, and two more
        picked = np.zeros_like(vit)
        picked[chans] = True
        lanes = list(zip(*np.nonzero(vit & (bad | picked))))
        lanes += [l for l in zip(*np.nonzero(vit & ~bad & ~picked))][:2]
        with ThreadPoolExecutor(3) as pool:  # ~9 GB of decisions each
            wants = list(pool.map(lambda cf: c_decode(soft_np, rec, *cf), lanes))
        for (c, f), want in zip(lanes, wants):
            nerr = min(int(np.unpackbits(data[c, f] ^ t).sum())
                       for t in ch.frames[c])
            out.append(check(np.array_equal(data[c, f], want),
                             f"block {i}, channel {int(c)}, frame {int(f)}:"
                             f" Viterbi, {nerr} bit errors; the native C"
                             " Viterbi decodes the same bytes"))

        for g in range(0, len(chans), 4):
            sel = chans[g : g + 4]
            x = iq[sel]
            with jax.default_device(cpu):
                x_c = jax.device_put(np.asarray(x), cpu)
                rec_c, soft_c = run(x_c, cfg_cpu)
                fr_c = np.asarray(carriers(x_c))
            fr_g = np.asarray(carriers(x))
            lbl = f"block {i}, channels {sel.tolist()} on the CPU"
            ds = np.abs(soft_np[sel].astype(np.int32)
                        - np.asarray(soft_c).astype(np.int32))
            frac = float((ds > 0).mean())
            out.append(check(ds.max() <= 1 and frac <= 1e-3,
                             f"{lbl}: soft symbols differ by at most"
                             f" {int(ds.max())} LSB in {frac:.2e} of positions"
                             " (limits 1, 1e-3)"))
            dfreq = float(np.abs(fr_g.astype(np.float64) - fr_c).max())
            out.append(check(dfreq <= 0.01, f"{lbl}: carriers agree within"
                             f" {dfreq:.2e} Hz (limit 0.01 Hz)"))
            # lane by lane: a lane whose symbols (sync and frame) are the
            # same on both sides must decode the same way; a lane whose
            # symbols differ by the LSBs above may not, but two good frames
            # of the same lane must be the same bytes
            lanes_g = (sel[:, None] * ch.nframes + np.arange(ch.nframes)).ravel()
            st_g, st_c = rec.start_symbol[lanes_g], rec_c.start_symbol
            soft_cn = np.asarray(soft_c)
            win = FRAMESYMBOLS + 2 * SYNCBITS
            same_in = (st_g == st_c) & np.array([
                np.array_equal(soft_np[sel[j // ch.nframes], a : a + win],
                               soft_cn[j // ch.nframes, a : a + win])
                for j, a in enumerate(np.maximum(st_g - SYNCBITS, 0))
            ])
            v = rec.decoder[lanes_g] == DECODER_VITERBI
            same_data = (rec.data[lanes_g] == rec_c.data).all(1)
            ident = (same_data & (rec.good[lanes_g] == rec_c.good)
                     & (rec.decoder[lanes_g] == rec_c.decoder))
            b = bad.reshape(-1)[lanes_g] & ~v
            out.append(check(
                ident[same_in & ~v].all()
                and not rec_c.good[v].any()
                and same_data[rec.good[lanes_g] & rec_c.good].all()
                and (same_in & ident)[b].all(),
                f"{lbl}: frame bytes, good flags and decoder labels identical"
                f" on the {int((same_in & ~v).sum())} lanes with the same"
                f" symbols, {int(b.sum())} good untransmitted frames among"
                f" them; {int((~same_in & ~v).sum())} lanes with other symbols,"
                f" {int((ident & ~same_in & ~v).sum())} of them identical too"
                " (frames good on both sides the same bytes);"
                f" {int(v.sum())} Viterbi lanes fail the Fano tiers there too"))
        out.append(f"block {i}: {int(bad.sum())} good frames not transmitted,"
                   " each checked above")
    out.append(check(nvit >= 1, f"{nvit} frames decoded by the Viterbi"
                     " fallback on the card"))
    return out


def phase_kernels(ch: Chain) -> list[str]:
    import jax
    import jax.numpy as jnp

    from isee3_decoder_tpu.config import FRAMEBITS, SYNC_STATE, SYNCWORD
    from isee3_decoder_tpu.models.decode import _viterbi_decode
    from isee3_decoder_tpu.ops import carrier
    from isee3_decoder_tpu.ops.fano import fano_decode
    from isee3_decoder_tpu.utils import ebn0_to_noise, native, simulate, testsignal
    from isee3_decoder_tpu.utils.devicesignal import synthesize_iq_device

    out = []
    code = ch.cfg.decode.code
    rng = np.random.default_rng(ch.seed + 1)

    # Viterbi fallback kernel against the native C decoder, which runs
    # in threads beside the Fano walks below
    vframes = testsignal.random_frames(rng, 4)
    vsyms = testsignal.frames_to_symbols(vframes, code).reshape(4, -1)
    vsoft = np.asarray(simulate(jax.random.PRNGKey(ch.seed + 2),
                                jnp.asarray(vsyms), 100.0,
                                ebn0_to_noise(100.0, 1.0)))
    pool = ThreadPoolExecutor(2)  # ~9 GB of decisions each
    futs = [pool.submit(native.viterbi_decode_frame, s, FRAMEBITS,
                        SYNC_STATE, SYNC_STATE, code) for s in vsoft]
    bits = np.asarray(_viterbi_decode(jnp.asarray(vsoft), ch.cfg.decode))

    # Fano walk at the cliff: card against CPU, all integer
    nbits = FRAMEBITS
    tail = SYNCWORD & ((1 << (code.k - 1)) - 1)
    fbits = rng.integers(0, 2, (FANO_LANES, nbits), dtype=np.uint8)
    for j in range(code.k - 1):
        fbits[:, nbits - 1 - j] = (tail >> j) & 1
    from isee3_decoder_tpu.ops.encode import encode_bits

    fsyms, _ = encode_bits(jnp.asarray(fbits), SYNC_STATE, code)
    fsoft = np.asarray(simulate(jax.random.PRNGKey(ch.seed + 3), fsyms, 100.0,
                                ebn0_to_noise(100.0, 2.0)))
    mettab = ch.cfg.decode.mettab()
    params = ch.cfg.decode.fano_params()
    rg = fano_decode(jnp.asarray(fsoft), jnp.asarray(mettab), nbits,
                     SYNC_STATE, tail, code, params)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        rc = fano_decode(jax.device_put(fsoft, cpu),
                         jax.device_put(mettab, cpu), nbits,
                         SYNC_STATE, tail, code, params)
    same = all(np.array_equal(np.asarray(getattr(rg, f)), np.asarray(getattr(rc, f)))
               for f in ("bits", "goodbits", "metric", "cycles"))
    ndone = int((np.asarray(rg.goodbits) == nbits).sum())
    out.append(check(same and 0 < ndone < FANO_LANES,
                     f"Fano walk, {FANO_LANES} lanes x {nbits} bits:"
                     f" bits, goodbits, metric, cycles equal the CPU's"
                     f" ({ndone} lanes decoded, max"
                     f" {int(np.asarray(rg.cycles).max())} cycles)"))

    # windowed carrier DFT against a float64 FFT of the same blocks
    pm = ch.cfg.pm
    iq = synthesize_iq_device(
        ch.frames_dev, ch.carriers, jax.random.PRNGKey(ch.seed + 4),
        pm.fftsize, samprate=SAMPRATE, symrate=SYMRATE, noise_std=NOISE_CLEAN,
    )
    K = carrier._window_bins(pm)
    first1 = jnp.trunc((ch.carriers - pm.search_width) / pm.actual_binsize
                       ).astype(jnp.int32) - 1
    S = np.asarray(jax.jit(lambda x, f: carrier.windowed_bins(x, f, K, pm))(
        iq, first1))
    X = np.fft.fft(np.asarray(iq, np.complex128), axis=-1)
    ref = np.take_along_axis(
        X, np.asarray(first1)[:, None] + np.arange(K)[None, :], axis=1)
    rel = float((np.abs(S - ref).max(1) / np.abs(ref).max(1)).max())
    peaks = np.array_equal(np.abs(S).argmax(1), np.abs(ref).argmax(1))
    out.append(check(rel <= 1e-5 and peaks,
                     f"windowed carrier DFT, {S.shape[0]} x {pm.fftsize}"
                     f" samples, {K} bins: peak bins equal the float64 FFT's,"
                     f" relative error {rel:.2e} (limit 1e-5, float32 at"
                     " HIGHEST precision)"))

    want = np.stack([f.result() for f in futs])
    pool.shutdown()
    nerr = int((bits != np.unpackbits(vframes, axis=1)).sum())
    out.append(check(np.array_equal(bits, want),
                     f"Viterbi ({ch.cfg.decode.viterbi_backend}) on 4 K={code.k}"
                     f" frames equals the native C decoder ({nerr} bit"
                     " errors against the transmitted frames)"))
    return out


def phase_wideband(ch: Chain) -> list[str]:
    import jax
    import jax.numpy as jnp

    from isee3_decoder_tpu.models.pipeline import receive_block_wideband
    from isee3_decoder_tpu.utils.devicesignal import synthesize_wideband_device

    nchan = ch.nchan
    Lw = 1 << 21
    amp = min(12_000.0, 30_000.0 / nchan)  # the sum of carriers fits int16
    wide = synthesize_wideband_device(
        ch.frames_dev, ch.carriers, jax.random.PRNGKey(ch.seed + 5), Lw, nchan,
        samprate=SAMPRATE, symrate=SYMRATE, amplitude=amp,
        noise_std=NOISE_CLEAN * amp / 12_000.0,
    )
    i_p = jnp.trunc(jnp.clip(wide.real, -32767.0, 32767.0)).astype(jnp.int32)
    q_p = jnp.trunc(jnp.clip(wide.imag, -32767.0, 32767.0)).astype(jnp.int32)
    packed = (i_p & 0xFFFF) | (q_p << 16)
    del wide, i_p, q_p
    nframes = ch.frames_available(
        jax.ShapeDtypeStruct(packed.shape, packed.dtype), wide_nchan=nchan
    )
    rec, _ = receive_block_wideband(packed, nchan, nframes, ch.cfg)
    n = nchan * nframes
    m = ch.matched(rec)
    return [
        check(rec.good.all(), f"{int(rec.good.sum())}/{n} frames good"),
        check(m.all(), "every frame transmitted"),
    ]


def phase_pipe(seed: int) -> list[str]:
    from isee3_decoder_tpu.utils import testsignal

    rng = np.random.default_rng(seed + 6)
    frames = testsignal.random_frames(rng, 5)  # 5 frames: 10 s at 512 bps
    iq = testsignal.synthesize_iq(
        frames, samprate=SAMPRATE, symrate=SYMRATE, carrier=20_000.0,
        noise_std=1500.0, lead_symbols=60, rng=rng,
    )
    env = {k: v for k, v in os.environ.items() if k != "ISEE3_CPU"}
    mod = "isee3_decoder_tpu.cli."
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "input.iq")
        testsignal.iq_to_int16(iq).tofile(path)
        cmds = [
            [sys.executable, "-m", mod + "pmdemod", "-W", "100", path],
            [sys.executable, "-m", mod + "symdemod", "-c", "1024."],
            [sys.executable, "-m", mod + "decode"],
        ]
        procs = []
        stdin = None
        for c in cmds:
            p = subprocess.Popen(c, stdin=stdin, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, env=env)
            if stdin is not None:
                stdin.close()
            stdin = p.stdout
            procs.append(p)
        out, err = procs[-1].communicate(timeout=900)
        errs = [err] + [p.stderr.read() for p in procs[:-1]]
        rcs = [p.wait(timeout=60) for p in procs]
    if any(rcs):
        sys.stderr.write(b"\n".join(errs).decode(errors="replace"))
        raise AssertionError(f"pipe chain exit codes {rcs}")
    decoded = []
    for block in out.decode().split("Frame ")[1:]:
        head, *rows = block.strip().splitlines()
        data = bytes.fromhex("".join(rows))
        decoded.append(("(bad)" not in head, data))
    later = decoded[1:]
    tx = {bytes(f) for f in frames}
    return [
        check(len(later) >= 2, f"{len(decoded)} frames out of 3 processes"
              " sharing the card"),
        check(all(good and data in tx for good, data in later),
              "every frame after the first good and byte-identical to a"
              " transmitted one"),
    ]


def phase_four_cards(seed: int) -> list[str]:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from isee3_decoder_tpu.config import FRAMEBITS, FRAMESYMBOLS, SYNC_STATE
    from isee3_decoder_tpu.models.decode import _viterbi_decode, unpack_block_buffer
    from isee3_decoder_tpu.models.pipeline import receive_block_device_soft
    from isee3_decoder_tpu.parallel.mesh import make_mesh
    from isee3_decoder_tpu.parallel.sharding import receive_block_sharded
    from isee3_decoder_tpu.parallel.viterbi_sharded import decode_frame_sharded
    from isee3_decoder_tpu.utils import ebn0_to_noise, simulate, testsignal

    devs = jax.devices()[:4]
    ch = Chain(seed, nchan=4 * NCHAN)
    # one block of 4 x 128 channels, each quarter made on its own card
    quarters = []
    for q, d in enumerate(devs):
        with jax.default_device(d):
            quarters.append(_quarter_block(ch, q, 10 + q))
    mesh = make_mesh(4, 1, devs)
    glob = jax.make_array_from_single_device_arrays(
        (4 * NCHAN, quarters[0].shape[1]),
        NamedSharding(mesh, P("ch", None)), quarters,
    )
    buf = np.asarray(receive_block_sharded(glob, ch.nframes, ch.cfg, mesh))
    full = unpack_block_buffer(buf, 4 * NCHAN, ch.nframes)
    L = NCHAN * ch.nframes
    out = []
    for q in range(4):
        one = jax.device_put(quarters[q], devs[0])
        bq = np.asarray(receive_block_device_soft(
            one, ch.nframes, FRAMESYMBOLS, ch.cfg)[0])
        part = unpack_block_buffer(bq, NCHAN, ch.nframes)
        same = all(np.array_equal(a[q * L:(q + 1) * L], b)
                   for a, b in zip(full[:5], part[:5]))
        same = same and np.array_equal(full[5][q * NCHAN:(q + 1) * NCHAN], part[5])
        out.append(check(same, f"quarter {q}: packed buffer equals the"
                         f" single-card receive_block_device's"
                         f" ({int(part[1].sum())}/{L} frames good)"))

    code = ch.cfg.decode.code
    rng = np.random.default_rng(seed + 7)
    syms = testsignal.frames_to_symbols(testsignal.random_frames(rng, 1), code)
    soft = simulate(jax.random.PRNGKey(seed + 8), jnp.asarray(syms[None]),
                    100.0, ebn0_to_noise(100.0, 1.0))
    smesh = make_mesh(1, 4, devs)
    got = np.asarray(decode_frame_sharded(soft, smesh, FRAMEBITS, SYNC_STATE,
                                          SYNC_STATE, code))
    want = np.asarray(_viterbi_decode(jax.device_put(soft, devs[0]), ch.cfg.decode))
    out.append(check(np.array_equal(got, want),
                     f"K={code.k} frame on a (1, 4) state mesh equals the"
                     " single-card decode bit for bit"))
    return out


def _quarter_block(ch: Chain, q: int, key: int):
    """Channels [128q, 128q+128) of the four-card block, made on the
    default device."""
    import jax
    import jax.numpy as jnp

    from isee3_decoder_tpu.utils.devicesignal import synthesize_iq_device

    sl = slice(q * NCHAN, (q + 1) * NCHAN)
    iq = synthesize_iq_device(
        jnp.asarray(ch.frames[sl]), jnp.asarray(np.asarray(ch.carriers)[sl]),
        jax.random.PRNGKey(key), ch.nsamples,
        samprate=SAMPRATE, symrate=SYMRATE, noise_std=NOISE_MID,
    )
    ri = jnp.stack([iq.real, iq.imag], axis=-1).reshape(NCHAN, -1)
    return jnp.trunc(jnp.clip(ri, -32767.0, 32767.0)).astype(jnp.int16)


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    need = 4 if args.four_cards else 1
    if devs[0].platform != "gpu" or len(devs) < need:
        print(f"chip_smoke: needs {need} GPU(s); JAX found"
              f" {len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 1
    from isee3_decoder_tpu.backends import card_name_and_power, enable_compile_cache

    enable_compile_cache()
    CARD = card_name_and_power()
    print(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}",
          flush=True)
    if args.four_cards:
        run_phase("four-cards", lambda: phase_four_cards(args.seed))
    else:
        ch = Chain(args.seed)
        run_phase("1 clean", lambda: phase_clean(ch))
        run_phase("2 threshold", lambda: phase_threshold(ch))
        run_phase("3 kernels", lambda: phase_kernels(ch))
        run_phase("4 wideband", lambda: phase_wideband(ch))
        run_phase("5 pipe", lambda: phase_pipe(args.seed))
    print(card_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
