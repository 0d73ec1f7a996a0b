"""The symbol demod's exclusive int32 prefix sum against numpy."""

import numpy as np
import jax.numpy as jnp
import pytest

from isee3_decoder_tpu.ops.symbols import prefix_sum


@pytest.mark.parametrize(
    "B, L, pad_to",
    [(8, 4000, None), (4, 3 * 8192 + 77, None), (4, 3 * 8192 + 77, 3 * 8192 + 500)],
    ids=["flat", "tiled", "padded"],
)
def test_prefix_sum_matches_reference(B, L, pad_to):
    """Flat (short) and tiled (long) paths, and zero-padding into the
    sum, with int32 wraparound like the device path."""
    rng = np.random.default_rng(L)
    s = rng.integers(-32768, 32768, (B, L), dtype=np.int64).astype(np.int16)
    out = np.asarray(prefix_sum(jnp.asarray(s), pad_to=pad_to))
    flat = np.pad(s, ((0, 0), (0, (pad_to or L) - L))).astype(np.int64)
    want = np.concatenate(
        [np.zeros((B, 1), np.int64), np.cumsum(flat, axis=1)], axis=1
    ).astype(np.int32)
    np.testing.assert_array_equal(out, want)
