"""fanotest CLI — Fano decoder statistics harness (fanotest.c).

Encode random frames with known start/tail states, pass them through the
seeded AWGN channel, decode with Fano, and report good/bad/undetected
frame counts plus average cycles per bit against the theoretical BER.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from isee3_decoder_tpu.cli._io import setup_jax

TAIL = 0x12345  # fanotest.c:36-37
START = 0x54321


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fanotest")
    p.add_argument("-d", "--delta", type=int, default=4)
    p.add_argument("-S", "--scale", type=int, default=8)
    p.add_argument("-m", "--max-cycles", type=int, default=1000, dest="maxcycles")
    p.add_argument("-l", "--frame-length", type=int, default=1024, dest="nbits")
    p.add_argument("-n", "--frame-count", type=int, default=1000, dest="trials")
    p.add_argument("-e", "--ebn0", type=float, default=2.0)
    p.add_argument("-s", "--signal", type=float, default=30.0)
    p.add_argument("-b", "--batch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-z", "--zerodata", action="store_true")
    a = p.parse_args(argv)

    setup_jax()
    import jax
    import jax.numpy as jnp

    from isee3_decoder_tpu.config import DEFAULT_CODE
    from isee3_decoder_tpu.ops import encode_bits
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
    good = bad = undetected = 0
    totcycles = 0
    done = 0
    while done < a.trials:
        B = min(a.batch, a.trials - done)
        bits = np.zeros((B, nbits), np.uint8)
        if not a.zerodata:
            bits[:, : nbits - 64] = rng.integers(0, 2, (B, nbits - 64))
        for j in range(code.k - 1):  # tail forcing (fanotest.c:117-119)
            bits[:, nbits - 1 - j] = (TAIL >> j) & 1
        syms, _ = encode_bits(jnp.asarray(bits), START, code)
        key, sub = jax.random.split(key)
        rx = simulate(sub, syms, a.signal, noise_amp)
        res = fano_decode(rx, mettab, nbits, START, TAIL, code, params)
        goodbits = np.asarray(res.goodbits)
        decoded = np.asarray(res.bits)
        totcycles += int(np.asarray(res.cycles).sum())
        ok = goodbits == nbits
        mismatch = (decoded != bits).any(axis=1)
        bad += int(mismatch.sum())
        good += int((~mismatch).sum())
        undetected += int((ok & mismatch).sum())
        done += B
        if a.verbose:
            for i in range(B):
                if a.verbose > 1 or goodbits[i] != nbits:
                    print(
                        f"trial {done - B + i} fano returns {goodbits[i]}, "
                        f"metric = {int(res.metric[i])}, cycles = {int(res.cycles[i])}"
                    )
    print(
        f"trials {done} avg cycles/bit {totcycles / (done * nbits):g} good {good} "
        f"bad {bad} undetected {undetected} deletion rate {100.0 * bad / done:g}%"
    )
    return 0


if __name__ == "__main__":
    from isee3_decoder_tpu.cli._io import run_main

    run_main(main)
