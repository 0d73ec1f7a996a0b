"""AWGN/BPSK channel simulator for the 8-bit quantized soft channel.

Capability parity with ``sim.c``: the reference builds 256-bin CDF tables
for the two transmit symbols (``setup_channel``, sim.c:17-28) and samples
by binary search against ``random()`` (``simulate``, sim.c:31-51), plus a
direct Gaussian alternative (``addnoise``, sim.c:150-158).

Batched differences: sampling is a vectorized ``searchsorted`` against
the same CDF driven by ``jax.random`` — so runs are *reproducible* from a
PRNG key, unlike the reference's time()-seeded ``random()``
(vtest224.c:57-58).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

try:
    from scipy.special import erf
except ImportError:  # pragma: no cover
    erf = np.vectorize(math.erf)

RAND_MAX = 2**31 - 1


def _normal(x: np.ndarray) -> np.ndarray:
    return 0.5 + 0.5 * erf(x / np.sqrt(2.0))


@functools.lru_cache(maxsize=16)
def channel_cdf(signal: float, noise: float) -> np.ndarray:
    """(2, 256) float64 CDF at the right edge of each sample bin.

    Matches ``setup_channel`` (sim.c:17-28); kept in float64 probability
    space rather than scaled to RAND_MAX ints (the int scaling in the
    reference is just an artifact of using ``random()``).
    """
    s = np.arange(256, dtype=np.float64)
    inv_noise = 1.0 / noise
    cdf0 = _normal((s - 128 + 0.5 + signal) * inv_noise)
    cdf1 = _normal((s - 128 + 0.5 - signal) * inv_noise)
    # Bin 255 absorbs the upper tail (sim.c's binary search can only
    # return bins 0..255).
    cdf0[255] = 1.0
    cdf1[255] = 1.0
    return np.stack([cdf0, cdf1])


@functools.partial(jax.jit, static_argnames=("signal", "noise"))
def simulate(key: jax.Array, tx: jax.Array, signal: float, noise: float) -> jax.Array:
    """Sample soft receive symbols for 0/1 transmit symbols (sim.c:31-51).

    Args:
      key: PRNG key.
      tx: (...,) array of 0/1 transmit symbols.
      signal, noise: channel amplitudes (static; table is baked in).

    Returns:
      (...,) uint8 offset-binary soft decisions with the same quantized
      AWGN distribution as the reference's inverse-CDF sampler.
    """
    cdf = jnp.asarray(channel_cdf(signal, noise))
    u = jax.random.uniform(key, tx.shape, dtype=jnp.float32)
    # Smallest bin s with u <= cdf[tx][s]  ==  searchsorted(left) on the CDF.
    per_tx = jnp.stack(
        [
            jnp.searchsorted(cdf[0], u.astype(jnp.float64) if cdf.dtype == jnp.float64 else u, side="left"),
            jnp.searchsorted(cdf[1], u.astype(jnp.float64) if cdf.dtype == jnp.float64 else u, side="left"),
        ]
    )
    s = jnp.where(tx.astype(jnp.int32) == 0, per_tx[0], per_tx[1])
    return jnp.clip(s, 0, 255).astype(jnp.uint8)


def addnoise(key: jax.Array, sym: jax.Array, signal: float, noise: float) -> jax.Array:
    """Gaussian alternative sampler (sim.c:150-158): offset-128 BPSK + AWGN."""
    mean = 128.0 + signal * (2 * sym.astype(jnp.float32) - 1)
    sample = mean + noise * jax.random.normal(key, sym.shape, dtype=jnp.float32)
    return jnp.clip(jnp.round(sample), 0, 255).astype(jnp.uint8)


def ebn0_to_noise(signal: float, ebn0_db: float, rate: float = 0.5) -> float:
    """Noise amplitude for a given Eb/N0 (vtest224.c:93-95, fanotest.c:92).

    The factor of 2 accounts for BPSK seeing half the noise power; sqrt
    converts power to voltage.
    """
    return signal / math.sqrt(2 * rate * 10.0 ** (ebn0_db / 10.0))
