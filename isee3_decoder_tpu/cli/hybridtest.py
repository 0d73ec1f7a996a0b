"""hybridtest CLI — hybrid Fano-then-Viterbi policy harness (hybridtest.c).

Frames that Fano fails (or mis-decodes) are retried with Viterbi; stats
are reported separately for both decoders.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from isee3_decoder_tpu.cli._io import setup_jax


def _decode(rx, nbits, code, backend):
    if backend == "inplace":
        from isee3_decoder_tpu.ops.viterbi_inplace import decode_frame_inplace

        return decode_frame_inplace(rx, nbits, 0, 0, code)
    from isee3_decoder_tpu.ops import viterbi

    return viterbi.decode_frame(rx, nbits, 0, 0, code)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hybridtest")
    p.add_argument("-d", "--delta", type=int, default=4)
    p.add_argument("-S", "--scale", type=int, default=8)
    p.add_argument("-m", "--max-cycles", type=int, default=1000, dest="maxcycles")
    p.add_argument("-l", "--frame-length", type=int, default=1024, dest="nbits")
    p.add_argument("-n", "--frame-count", type=int, default=1000, dest="trials")
    p.add_argument("-e", "--ebn0", type=float, default=2.0)
    p.add_argument("-s", "--signal", type=float, default=30.0)
    p.add_argument("-b", "--batch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="jnp",
                   choices=["jnp", "inplace"],
                   help="Viterbi kernel backend (bit-identical outputs)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-z", "--zerodata", action="store_true")
    a = p.parse_args(argv)

    setup_jax()
    import jax
    import jax.numpy as jnp

    from isee3_decoder_tpu.config import DEFAULT_CODE
    from isee3_decoder_tpu.ops import encode_bits, viterbi
    from isee3_decoder_tpu.ops.fano import FanoParams, fano_decode
    from isee3_decoder_tpu.utils.metrics import gen_met
    from isee3_decoder_tpu.utils.sim import simulate

    code = DEFAULT_CODE
    nbits = a.nbits
    rate = 0.5
    delta = a.delta * a.scale
    noise_amp = a.signal / math.sqrt(2 * rate * 10 ** (a.ebn0 / 10))
    mettab = jnp.asarray(gen_met(a.signal, noise_amp, rate, a.scale))
    print(f"Code rate {rate:.2f}, Nbits = {nbits}, Maxcycles/bit {a.maxcycles}")
    print(
        f"Eb/N0 = {a.ebn0:.3f} dB, Signal = {a.signal:g}, Noise = {noise_amp:g}, "
        f"BER@Eb/N0 = {0.5 * math.erfc(10 ** (a.ebn0 / 20)):g}, "
        f"BER@Es/N0 = {0.5 * math.erfc(math.sqrt(rate * 10 ** (a.ebn0 / 10))):g}"
    )

    rng = np.random.default_rng(a.seed)
    key = jax.random.PRNGKey(a.seed)
    params = FanoParams(delta=delta, maxcycles=a.maxcycles)
    fano_good = fano_failures = fano_frame_errors = fano_bit_errors = 0
    vit_attempts = vit_good = vit_frame_errors = vit_bit_errors = 0
    done = 0
    while done < a.trials:
        B = min(a.batch, a.trials - done)
        bits = np.zeros((B, nbits), np.uint8)
        if not a.zerodata:
            bits[:, : nbits - 64] = rng.integers(0, 2, (B, nbits - 64))
        syms, _ = encode_bits(jnp.asarray(bits), 0, code)
        key, sub = jax.random.split(key)
        rx = simulate(sub, syms, a.signal, noise_amp)
        res = fano_decode(rx, mettab, nbits, 0, 0, code, params)
        goodbits = np.asarray(res.goodbits)
        decoded = np.asarray(res.bits)
        finished = goodbits == nbits
        errs = (decoded != bits).sum(axis=1)
        fano_failures += int((~finished).sum())
        fano_ok = finished & (errs == 0)
        fano_good += int(fano_ok.sum())
        fano_err = finished & (errs != 0)
        fano_frame_errors += int(fano_err.sum())
        fano_bit_errors += int((errs * (finished & (errs != 0))).sum())

        retry = ~fano_ok  # failed or mis-decoded → try Viterbi
        if retry.any():
            sub_idx = np.nonzero(retry)[0]
            vit_attempts += len(sub_idx)
            vbits = np.asarray(_decode(rx[sub_idx], nbits, code, a.backend))
            verrs = (vbits != bits[sub_idx]).sum(axis=1)
            vit_good += int((verrs == 0).sum())
            vit_frame_errors += int((verrs != 0).sum())
            vit_bit_errors += int(verrs.sum())
        done += B
    print(
        f"Fano good frames: {fano_good}, decode failures {fano_failures}, "
        f"frame errors {fano_frame_errors}, bit errors {fano_bit_errors}"
    )
    if vit_attempts:
        print(
            f"Viterbi attempts {vit_attempts} good frames: {vit_good} frame errors "
            f"{vit_frame_errors} ({100.0 * vit_frame_errors / vit_attempts:g}%) bit errors "
            f"{vit_bit_errors} ({100.0 * vit_bit_errors / (nbits * vit_attempts):g}%)"
        )
    return 0


if __name__ == "__main__":
    from isee3_decoder_tpu.cli._io import run_main

    run_main(main)
