"""channelize CLI — split a wideband int16 IQ capture into per-channel
baseband files (the many-channel front-end; no reference equivalent).

Each output channel k is written to <outdir>/chan<k>.iq as interleaved
int16 I,Q at rate fs_in / M, centered at k*fs_in/M (aliased to ±fs/2),
ready for the pmdemod | symdemod | decode pipeline.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from isee3_decoder_tpu.cli._io import setup_jax, status


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="channelize")
    p.add_argument("-M", type=int, default=8, dest="nchan")
    p.add_argument("-r", type=float, default=2_000_000.0, dest="samprate")
    p.add_argument("-t", type=int, default=8, dest="taps_per_branch")
    p.add_argument("-O", type=int, default=1, choices=(1, 2), dest="oversample",
                   help="2 = 2x oversampled bank (rate 2*fs/M; recovers "
                        "channel-edge carriers the critical bank aliases)")
    p.add_argument("-o", default="channels", dest="outdir")
    p.add_argument("-c", default=None, dest="channels",
                   help="comma-separated channel indices (default: all)")
    p.add_argument("-g", type=float, default=1.0, dest="gain")
    p.add_argument("input")
    a = p.parse_args(argv)

    setup_jax()
    import jax.numpy as jnp

    from isee3_decoder_tpu.ops.channelizer import channel_center, channelize

    raw = np.fromfile(a.input, "<i2").astype(np.float32)
    iq = (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    status(
        f"channelize: {len(iq):,} samples @ {a.samprate:,.0f} Hz -> "
        f"{a.nchan} channels @ "
        f"{a.oversample * a.samprate / a.nchan:,.0f} Hz"
    )
    y = np.asarray(
        channelize(
            jnp.asarray(iq), a.nchan, a.taps_per_branch,
            oversample=a.oversample,
        )
    )[0]
    os.makedirs(a.outdir, exist_ok=True)
    sel = (
        [int(c) for c in a.channels.split(",")]
        if a.channels
        else range(a.nchan)
    )
    for k in sel:
        out = np.empty((y.shape[1], 2), np.int16)
        out[:, 0] = np.clip(y[k].real * a.gain, -32768, 32767).astype(np.int16)
        out[:, 1] = np.clip(y[k].imag * a.gain, -32768, 32767).astype(np.int16)
        path = os.path.join(a.outdir, f"chan{k}.iq")
        out.tofile(path)
        status(
            f"channelize: wrote {path} (center "
            f"{channel_center(k, a.samprate, a.nchan):,.0f} Hz, "
            f"{y.shape[1]:,} samples)"
        )
    return 0


if __name__ == "__main__":
    from isee3_decoder_tpu.cli._io import run_main

    run_main(main)
