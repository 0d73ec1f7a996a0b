"""bitsync CLI — whole-file symbol sync + streaming Viterbi + syncword
framing (bitsync.c): reads a PM baseband int16 file, prints per-window
timing/energy status lines and the decoded 1024-bit frames as hex.

Flags mirror the reference (bitsync.c:84-100): -c/-s symbol rate,
-r sample rate, -o skip-to-sample.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from isee3_decoder_tpu.cli._io import setup_jax


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bitsync")
    p.add_argument("-c", type=float, default=1024.467, dest="symrate")
    p.add_argument("-s", type=float, dest="symrate2")
    p.add_argument("-r", type=float, default=250000.0, dest="samprate")
    p.add_argument("-o", type=int, default=0, dest="offset")
    p.add_argument("-d", type=int, default=200, dest="decode_delay")
    p.add_argument(
        "--code",
        default="MCQLI24",
        help="convolutional code catalogue name (default MCQLI24; "
        "TESTK7 = small K=7 code for smoke tests)",
    )
    p.add_argument("input")
    a = p.parse_args(argv)
    if a.symrate2 is not None:
        a.symrate = a.symrate2

    setup_jax()
    from isee3_decoder_tpu.config import CODES, CodeSpec
    from isee3_decoder_tpu.models.legacy import bitsync_frames
    from isee3_decoder_tpu.utils.timeformat import format_hms

    codes = dict(CODES, TESTK7=CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0))
    if a.code not in codes:
        p.error(f"unknown code {a.code!r} (choices: {', '.join(codes)})")

    samples = np.fromfile(a.input, "<i2")[a.offset :]
    secs = len(samples) / a.samprate
    print(
        f"{a.input}: {len(samples):,} samples; {secs:,.3f} sec "
        f"({format_hms(secs)}) @ {a.samprate:,.1f} Hz"
    )
    res = bitsync_frames(
        samples,
        a.samprate,
        a.symrate,
        decode_delay=a.decode_delay,
        code=codes[a.code],
    )
    for n, info in enumerate(res.infos, start=1):
        t = info["firstsample"] / a.samprate
        e = info["energy"]
        edb = 10 * math.log10(e) if e > 0 else float("-inf")
        print(
            f"Frame {n:,} starting at sample {info['firstsample']:,} "
            f"({t:,.3f} sec, {format_hms(t)}): clock {info['symrate']:,.4f} Hz; "
            f"{a.samprate / info['symrate']:,.4f} samp/sym; energy {edb:.3f} dB"
        )
    for fr in res.frames:
        for i in range(0, len(fr), 16):
            print(" ".join(f"{b:02x}" for b in fr[i : i + 16]))
        print()
    return 0


if __name__ == "__main__":
    from isee3_decoder_tpu.cli._io import run_main

    run_main(main)
