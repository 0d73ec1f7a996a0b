"""qdecode CLI — quick-look-in decoder (qdecode.c): reads soft symbol
bytes on stdin, writes '0'/'1' ASCII bits on stdout, with automatic
symbol-pair phase flipping unless -F."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from isee3_decoder_tpu.cli._io import setup_jax, status


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qdecode")
    p.add_argument("-F", action="store_true", dest="dontflip")
    p.add_argument("-p", action="store_true", dest="opposite_phase")
    p.add_argument("-q", action="store_true", dest="quiet")
    a = p.parse_args(argv)

    setup_jax()
    import jax.numpy as jnp

    from isee3_decoder_tpu.models.legacy import auto_phase_flip, qdecode_stream

    raw = sys.stdin.buffer.read()
    symbols = np.frombuffer(raw, np.uint8)[None, :]
    flip = 0
    if a.opposite_phase:
        # qdecode.c:76-80: -p starts the pair counter at 1, so the first
        # input byte pairs with a phantom zero-initialized symbol
        symbols = np.concatenate(
            [np.zeros((1, 1), np.uint8), symbols], axis=1
        )
        flip = 1
    if not a.dontflip and symbols.shape[1] >= 2082:
        symbols, extra = auto_phase_flip(symbols)
        extra = int(extra[0])
        flip ^= extra
        if extra and not a.quiet:
            status("qdecode: flipping phase")
    bits = np.asarray(qdecode_stream(jnp.asarray(symbols)))[0]
    sys.stdout.write("".join("1" if b else "0" for b in bits))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    from isee3_decoder_tpu.cli._io import run_main

    run_main(main)
