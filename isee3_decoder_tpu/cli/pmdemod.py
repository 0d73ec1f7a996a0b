"""pmdemod CLI — PM carrier demodulator (reference: pmdemod.c).

Reads interleaved little-endian int16 I,Q samples from a file or stdin,
writes int16 baseband PM samples on stdout, status on stderr.

Flags mirror the reference (README.txt:19-28):
  -S start carrier estimate Hz   -W search width Hz (when locked)
  -D doppler rate Hz/s           -t C/N0 lock threshold dB
  -b FFT bin size Hz             -r sample rate Hz
  -f flip I/Q                    -q quiet
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from isee3_decoder_tpu.cli._io import (
    setup_jax,
    open_input,
    read_iq_block,
    status,
    write_int16,
)
from isee3_decoder_tpu.utils.timeformat import format_hms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pmdemod", add_help=True)
    p.add_argument("-S", type=float, default=0.0, dest="start_freq")
    p.add_argument("-W", type=float, default=0.0, dest="search_width")
    p.add_argument("-D", type=float, default=0.0, dest="doppler_rate")
    p.add_argument("-t", type=float, default=21.0, dest="cn0_threshold")
    p.add_argument("-b", type=float, default=4.0, dest="binsize")
    p.add_argument("-r", type=float, default=250000.0, dest="samprate")
    p.add_argument("-f", action="store_true", dest="flip")
    p.add_argument("-q", action="store_true", dest="quiet")
    p.add_argument("input", nargs="?", default=None)
    a = p.parse_args(argv)

    setup_jax()
    import jax.numpy as jnp

    from isee3_decoder_tpu.ops.carrier import PMConfig, init_carry, pm_demod_block

    if abs(a.start_freq) > a.samprate / 2:
        status(f"pmdemod: carrier estimate outside Nyquist ±{a.samprate/2:.1f} Hz")
        return 1
    a.search_width = abs(a.search_width)
    if a.search_width > a.samprate / 2:
        status(f"pmdemod: search width reduced to ±{a.samprate/2:.1f} Hz")
        a.search_width = a.samprate / 2

    cfg = PMConfig(
        samprate=a.samprate,
        binsize=a.binsize,
        search_width=a.search_width,
        doppler_rate=a.doppler_rate,
        cn0_threshold=a.cn0_threshold,
    )
    if not a.quiet:
        status(
            f"pmdemod: FFT bin size {cfg.actual_binsize:.4f} Hz; start carrier "
            f"{a.start_freq:.4f} Hz; Doppler {a.doppler_rate:.6f} Hz/s; "
            f"search range +/-{a.search_width:.1f} Hz"
        )

    f = open_input(a.input)
    carry = init_carry(1, cfg, a.start_freq)
    total = 0
    while True:
        blk = read_iq_block(f, cfg.fftsize, a.flip)
        if blk is None:
            break
        carry, out = pm_demod_block(carry, jnp.asarray(blk)[None, :], cfg)
        write_int16(np.asarray(out.baseband[0]))
        if not a.quiet:
            lock = " locked" if bool(out.locked[0]) else ""
            secs = total / a.samprate
            status(
                f"pmdemod: sample {total:,} ({secs:,.3f} sec, {format_hms(secs)}); "
                f"carrier {float(out.carrier_freq[0]):,.1f} Hz; "
                f"C/No = {float(out.cn0[0]):,.2f} dB{lock}"
            )
        total += cfg.fftsize
    return 0


if __name__ == "__main__":
    from isee3_decoder_tpu.cli._io import run_main

    run_main(main)
