"""Shared CLI plumbing: binary stream IO matching the reference's byte
contracts (int16 IQ pairs in, int16 baseband, uint8 soft symbols)."""

from __future__ import annotations

import os
import sys

import numpy as np


def open_input(path: str | None):
    """File argument or stdin, binary (pmdemod.c:167-203)."""
    if path:
        return open(path, "rb")
    return sys.stdin.buffer


def read_exact(f, nbytes: int) -> bytes:
    """Read exactly nbytes or whatever remains at EOF."""
    chunks = []
    got = 0
    while got < nbytes:
        b = f.read(nbytes - got)
        if not b:
            break
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def read_iq_block(f, nsamples: int, flip: bool = False) -> np.ndarray | None:
    """nsamples of interleaved int16 I,Q → complex64, or None at EOF
    (partial blocks are dropped, pmdemod.c:210-215).

    Uses the native deinterleave kernel when the C++ runtime is built.
    """
    raw = read_exact(f, nsamples * 4)
    if len(raw) < nsamples * 4:
        return None
    from isee3_decoder_tpu.utils import native

    return native.iq_deinterleave(np.frombuffer(raw, "<i2"), flip)


def write_int16(data: np.ndarray) -> None:
    sys.stdout.buffer.write(np.asarray(data, "<i2").tobytes())
    sys.stdout.buffer.flush()


def write_bytes(data: np.ndarray) -> None:
    sys.stdout.buffer.write(np.asarray(data, np.uint8).tobytes())
    sys.stdout.buffer.flush()


def status(msg: str) -> None:
    """Status on stderr so stdout stays a clean data pipe (README.txt:14)."""
    print(msg, file=sys.stderr, flush=True)


def setup_jax() -> None:
    """Prepare JAX for a CLI stage; call before any JAX computation.

    ISEE3_CPU=1 forces the CPU backend.  Device memory is allocated on
    demand instead of reserved up front (unless the user set
    XLA_PYTHON_CLIENT_PREALLOCATE), so the three stages of a
    ``pmdemod | symdemod | decode`` pipe can share one card.  Compiled
    programs go to the persistent compile cache."""
    os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")
    import jax

    if os.environ.get("ISEE3_CPU", "") == "1":
        jax.config.update("jax_platforms", "cpu")
    from isee3_decoder_tpu.backends import enable_compile_cache

    enable_compile_cache()


def run_main(main) -> None:
    """CLI entry wrapper: exit silently on closed stdout (SIGPIPE), like
    the C tools, instead of dumping a BrokenPipeError traceback."""
    import sys

    try:
        code = main()
    except BrokenPipeError:
        try:
            sys.stdout.close()
        except Exception:
            pass
        code = 0
    except KeyboardInterrupt:
        code = 130
    sys.exit(code)
