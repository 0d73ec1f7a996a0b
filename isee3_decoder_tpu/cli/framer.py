"""framer CLI — syncword framer over decoded ASCII bits (framer.c)."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from isee3_decoder_tpu.cli._io import setup_jax
from isee3_decoder_tpu.utils.timeformat import format_hms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="framer")
    p.add_argument("-r", type=int, default=512, dest="bitrate")
    a = p.parse_args(argv)

    setup_jax()
    from isee3_decoder_tpu.models.legacy import frame_bits

    text = sys.stdin.read()
    bits = np.array([1 if c == "1" else 0 for c in text if c in "01"], np.uint8)
    res = frame_bits(bits)
    for n, (frame, pos) in enumerate(zip(res.frames, res.positions), start=1):
        print(f"Frame {n:,} at bit {pos:,} ({format_hms(pos / a.bitrate)})")
        for i in range(0, len(frame), 16):
            print(" ".join(f"{b:02x}" for b in frame[i : i + 16]))
        print()
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    from isee3_decoder_tpu.cli._io import run_main

    run_main(main)
