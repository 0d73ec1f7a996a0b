"""symdemod CLI — Manchester symbol demodulator (reference: symdemod.c).

Reads int16 baseband samples on stdin, writes 8-bit offset-128 soft
decisions on stdout (one byte per symbol), status on stderr.

Flags (README.txt:30-33 + symdemod.c:56-84):
  -c symbol rate Hz (scaled by the measured spacecraft clock unless a
     decimal point is given; rates < 1000 switch to subcarrier mode)
  -r sample rate Hz   -w window seconds   -C clocks/symbol   -t track
  -q quiet
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from isee3_decoder_tpu.cli._io import (
    setup_jax,
    read_exact,
    status,
    write_bytes,
)
from isee3_decoder_tpu.config import ACTUALCLOCK, NOMINALCLOCK
from isee3_decoder_tpu.utils.timeformat import format_hms


def parse_symrate(arg: str | None) -> tuple[float, int]:
    """The -c semantics of symdemod.c:67-77: no decimal point → scale by
    the measured spacecraft clock; < 1000 Hz → subcarrier mode."""
    if arg is None:
        return ACTUALCLOCK, 1
    try:
        value = float(arg)
    except ValueError:
        raise SystemExit(f"symdemod: invalid symbol rate {arg!r}")
    if "." not in arg:
        symrate = value * ACTUALCLOCK / NOMINALCLOCK
    else:
        symrate = value
    clocks = 1
    if symrate < 1000:
        clocks = int(round(NOMINALCLOCK / symrate))
    return symrate, clocks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="symdemod")
    p.add_argument("-c", default=None, dest="symrate")
    p.add_argument("-r", type=int, default=250000, dest="samprate")
    p.add_argument("-w", type=float, default=1.0, dest="window")
    p.add_argument("-C", type=int, default=None, dest="symbolclocks")
    p.add_argument("-t", action="store_true", dest="track")
    p.add_argument("-q", action="store_true", dest="quiet")
    a = p.parse_args(argv)

    setup_jax()
    import jax.numpy as jnp

    from isee3_decoder_tpu.models.symdemod import initial_firstsample
    from isee3_decoder_tpu.ops import symbols as sym_ops
    from isee3_decoder_tpu.ops.symbols import SymConfig

    symrate, clocks = parse_symrate(a.symrate)
    if a.symbolclocks is not None:
        clocks = a.symbolclocks
    cfg = SymConfig(
        samprate=float(a.samprate),
        symrate=symrate,
        symbolclocks=clocks,
        window=a.window,
    )
    if not a.quiet:
        status(
            f"symdemod: sample rate {a.samprate:,} Hz; estimation window "
            f"{a.window:.3f} sec; clocks/symbol {clocks}; symbol rate "
            f"{symrate:.3f} Hz; tracking {'on' if a.track else 'off'}"
        )

    f = sys.stdin.buffer
    fullwater = int(cfg.window * 2.0 * cfg.samprate)  # symdemod.c:90
    symbolsamples = cfg.symbolsamples
    buf = np.zeros(0, np.int16)
    firstsample = initial_firstsample(cfg)
    total_samples = 0
    total_symbols = 0
    eof = False
    while True:
        # purge (symdemod.c:101-112)
        if firstsample >= cfg.window * cfg.samprate:
            slide = int(firstsample - 2 * symbolsamples)
            slide = min(slide, len(buf))
            buf = buf[slide:]
            firstsample -= slide
            total_samples += slide
        # refill (symdemod.c:114-123)
        if not eof and len(buf) < fullwater:
            raw = read_exact(f, (fullwater - len(buf)) * 2)
            if len(raw) < (fullwater - len(buf)) * 2:
                eof = True
            if raw:
                buf = np.concatenate([buf, np.frombuffer(raw, "<i2")])
        if len(buf) < cfg.window * cfg.samprate:
            break

        nsym = cfg.nsymbols
        if a.track:
            from isee3_decoder_tpu.models.symdemod import symdemod_tracked

            # one-window tracked step: reuse the host driver on the buffer
            soft, infos = symdemod_tracked(buf[None, :], cfg, 1)
            info = infos[0]
            symbolsamples = float(info["symbolsamples"][0])
            cfg = SymConfig(cfg.samprate, cfg.samprate / symbolsamples, clocks, cfg.window)
            firstsample = int(info["firstsample"][0])
            write_bytes(soft[0])
            energy = float(info["energy"][0])
            symphase = 0
        else:
            ts = sym_ops.timesearch(
                jnp.asarray(buf), firstsample, cfg.halfclock, nsym,
                cfg.symbolclocks, cfg.noffsets,
            )
            symphase = int(ts.symphase[0])
            firstsample += symphase
            energy = float(ts.maxenergy[0])
            gain = 100.0 / np.sqrt(energy)
            res = sym_ops.integrate_symbols(
                jnp.asarray(buf), firstsample, cfg.halfclock, nsym,
                cfg.symbolclocks, gain,
            )
            write_bytes(np.asarray(res.soft[0]))

        if not a.quiet:
            t = (firstsample + total_samples) / cfg.samprate
            status(
                f"symdemod: sample {firstsample + total_samples:,} "
                f"({t:,.3f} sec, {format_hms(t)}) symbol {total_symbols:,}: "
                f"clock {cfg.samprate / symbolsamples:,.4f} Hz; "
                f"{symbolsamples:,.4f} samp/sym; timing adj {symphase:+d} "
                f"samples; energy {10 * np.log10(energy):.3f} dB"
            )
        total_symbols += nsym
        firstsample = int(firstsample + nsym * symbolsamples)
    return 0


if __name__ == "__main__":
    from isee3_decoder_tpu.cli._io import run_main

    run_main(main)
