"""decode CLI — frame sync + hybrid Fano/Viterbi decoder (decode.c).

Reads 8-bit soft symbols on stdin, prints decoded 128-byte frames in hex.

Flags (decode.c:75-107): -F fano only, -V viterbi only, -p persistent,
-n suppress bad frames, -r symrate, -s fano scale, -m fano maxcycles,
-d fano delta, -v verbose.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from isee3_decoder_tpu.cli._io import setup_jax, read_exact
from isee3_decoder_tpu.config import FRAMESYMBOLS, SYNCBITS


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="decode")
    p.add_argument("-F", action="store_true", help="disable Viterbi (Fano only)")
    p.add_argument("-V", action="store_true", help="disable Fano (Viterbi only)")
    p.add_argument("-p", action="store_true", dest="persistent")
    p.add_argument("-n", action="store_true", dest="no_bad_frames")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    p.add_argument("-r", type=float, default=1024.0, dest="symrate")
    p.add_argument("-s", type=float, default=8.0, dest="fano_scale")
    p.add_argument("-m", type=int, default=100, dest="fano_maxcycles")
    p.add_argument("-d", type=int, default=None, dest="fano_delta")
    p.add_argument("--backend", default="jnp",
                   choices=["jnp", "inplace"],
                   help="Viterbi kernel backend (bit-identical outputs)")
    p.add_argument("--strict-labels", action="store_true",
                   help="disable the quicklook-EC middle tier so decoder"
                   " labels match decode.c exactly (the reference has no"
                   " such tier; frames it accepts are labeled"
                   " 'Quicklook-EC' instead of 'Fano').  Frame BYTES are"
                   " identical either way — the tier only skips the Fano"
                   " walk on frames it can correct algebraically")
    p.add_argument("--no-quicklook", action="store_true",
                   help="disable the quick-look fast tier (error-free "
                        "frames then always pay the Fano walk; output "
                        "is identical either way)")
    a = p.parse_args(argv)

    setup_jax()
    from isee3_decoder_tpu.models.decode import (
        DecodeConfig,
        DecodeStreamState,
        decode_stream,
        format_frame,
    )

    fano_enabled = not a.V
    viterbi_enabled = not a.F
    if not fano_enabled and not viterbi_enabled:
        print("decode: Specify only one of -F or -V")
        return 1
    delta = a.fano_delta if a.fano_delta is not None else int(4 * a.fano_scale)
    cfg = DecodeConfig(
        fano_enabled=fano_enabled,
        viterbi_enabled=viterbi_enabled,
        persistent=a.persistent,
        fano_scale=a.fano_scale,
        fano_delta=delta,
        # Reference quirk: decode.c:202 passes a literal 100 to fano();
        # the parsed -m value (Fano_maxcycles) is only ever *displayed*.
        # Mirror that for golden parity — the library DecodeConfig stays
        # fully configurable for programmatic users.
        fano_maxcycles=100,
        viterbi_backend=a.backend,
        quicklook=not a.no_quicklook,
        qlec=not a.strict_labels,
    )
    print(
        f"decode: Fano {'enabled' if fano_enabled else 'disabled'}; "
        f"Viterbi {'enabled' if viterbi_enabled else 'disabled'}"
    )
    if a.no_bad_frames:
        print("decode: Not displaying bad frames")

    f = sys.stdin.buffer
    state = DecodeStreamState(1)
    buf = np.zeros(0, np.uint8)
    frame_no = 1
    chunk = FRAMESYMBOLS + SYNCBITS
    eof = False
    while True:
        if not eof:
            raw = read_exact(f, 4 * chunk)
            if len(raw) < 4 * chunk:
                eof = True
            if raw:
                buf = np.concatenate([buf, np.frombuffer(raw, np.uint8)])
        recs, state = decode_stream(buf[None, :], cfg, state)
        for r in recs:
            if r.good[0] or not a.no_bad_frames:
                sys.stdout.write(
                    format_frame(r, 0, frame_no, a.symrate) + "\n"
                )
                sys.stdout.flush()
            frame_no += 1
        if eof and not recs:
            break
    return 0


if __name__ == "__main__":
    from isee3_decoder_tpu.cli._io import run_main

    run_main(main)
