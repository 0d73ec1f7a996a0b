"""vtest CLI — Viterbi BER/throughput harness (vtest224.c).

Modes:
  with -e EbN0: encode random frames → AWGN channel → decode → BER/FER
  without -e:   pure-throughput timing on all-erasure symbols

Unlike the reference (seeded from time(), vtest224.c:57-58) runs are
reproducible from --seed.  Frames are decoded in device batches.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from isee3_decoder_tpu.cli._io import setup_jax


def _decode(rx, nbits, code, backend):
    if backend == "inplace":
        from isee3_decoder_tpu.ops.viterbi_inplace import decode_frame_inplace

        return decode_frame_inplace(rx, nbits, 0, 0, code)
    from isee3_decoder_tpu.ops import viterbi

    return viterbi.decode_frame(rx, nbits, 0, 0, code)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vtest")
    p.add_argument("-l", "--frame-length", type=int, default=1024, dest="framebits")
    p.add_argument("-n", "--frame-count", type=int, default=10, dest="trials")
    p.add_argument("-e", "--ebn0", type=float, default=None)
    p.add_argument("-g", "--gain", type=float, default=24.0)
    p.add_argument("-b", "--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="jnp",
                   choices=["jnp", "inplace"],
                   help="Viterbi kernel backend (bit-identical outputs)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    a = p.parse_args(argv)

    setup_jax()
    import jax
    import jax.numpy as jnp

    from isee3_decoder_tpu.config import DEFAULT_CODE
    from isee3_decoder_tpu.ops import encode_bits, viterbi
    from isee3_decoder_tpu.utils.sim import ebn0_to_noise, simulate

    code = DEFAULT_CODE
    nbits = a.framebits
    rng = np.random.default_rng(a.seed)

    if a.ebn0 is not None:
        noise = ebn0_to_noise(a.gain, a.ebn0)
        print(
            f"nframes = {a.trials} framesize = {nbits} ebn0 = {a.ebn0:.2f} dB "
            f"Gain = {a.gain:g} noise = {noise:g}"
        )
        key = jax.random.PRNGKey(a.seed)
        tot_errs = 0
        badframes = 0
        done = 0
        t_decode = 0.0
        while done < a.trials:
            B = min(a.batch, a.trials - done)
            bits = rng.integers(0, 2, (B, nbits), dtype=np.uint8)
            bits[:, -code.k :] = 0  # zero tail (vtest224.c:105)
            syms, _ = encode_bits(jnp.asarray(bits), 0, code)
            key, sub = jax.random.split(key)
            rx = simulate(sub, syms, a.gain, noise)
            t0 = time.perf_counter()
            decoded = _decode(rx, nbits, code, a.backend)
            decoded = np.asarray(jax.block_until_ready(decoded))
            t_decode += time.perf_counter() - t0
            errs = (decoded != bits).sum(axis=1)
            tot_errs += int(errs.sum())
            badframes += int((errs != 0).sum())
            done += B
            if a.verbose:
                print(
                    f"BER {tot_errs}/{nbits * done} ({tot_errs / (nbits * done):10.3g}) "
                    f"FER {badframes}/{done} ({badframes / done:10.3g}) "
                    f"time {t_decode:.6g} s ({nbits * done / t_decode:.2f} b/s)"
                )
        print(
            f"BER {tot_errs}/{nbits * a.trials} ({tot_errs / (nbits * a.trials):.3g}) "
            f"FER {badframes}/{a.trials} ({badframes / a.trials:.3g})"
        )
    else:
        print("Starting time trials")
        syms = jnp.full((a.batch, 2 * nbits), 128, jnp.uint8)  # erasures
        decoded = _decode(syms, nbits, code, a.backend)  # warmup
        import jax

        jax.block_until_ready(decoded)
        t0 = time.perf_counter()
        done = 0
        while done < a.trials:
            decoded = _decode(syms, nbits, code, a.backend)
            jax.block_until_ready(decoded)
            done += a.batch
        extime = time.perf_counter() - t0
        print(f"Execution time for {done} {nbits}-bit frames: {extime:.2f} sec")
        print(f"decoder speed: {done * nbits / extime:g} bits/s")
    return 0


if __name__ == "__main__":
    from isee3_decoder_tpu.cli._io import run_main

    run_main(main)
