"""simtest CLI — channel simulator sanity check (simtest.c:11-33):
print simulated soft receive samples for tx symbols 0 and 1 at a given
Es/N0 for eyeball inspection."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from isee3_decoder_tpu.cli._io import setup_jax


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="simtest")
    p.add_argument("-n", type=int, default=1000, dest="count")
    p.add_argument("-s", type=float, default=100.0, dest="signal")
    p.add_argument("-e", type=float, default=3.0, dest="esn0_db")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)

    setup_jax()
    import jax
    import jax.numpy as jnp

    from isee3_decoder_tpu.utils.sim import simulate

    noise = a.signal / (10 ** (a.esn0_db / 20.0)) / np.sqrt(2.0)
    for tx in (0, 1):
        print(f"tx symbol {tx}:")
        rx = np.asarray(
            simulate(
                jax.random.PRNGKey(a.seed + tx),
                jnp.full(a.count, tx, jnp.uint8),
                a.signal,
                noise,
            )
        )
        for i in range(0, a.count, 20):
            print(" ".join(f"{v:3d}" for v in rx[i : i + 20]))
        print(f"mean {rx.mean():.2f} std {rx.std():.2f}")
    return 0


if __name__ == "__main__":
    from isee3_decoder_tpu.cli._io import run_main

    run_main(main)
