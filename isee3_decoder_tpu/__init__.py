"""isee3_decoder_tpu — batched JAX rebuild of the KA9Q ISEE-3/ICE telemetry chain.

A JAX/XLA framework with the capabilities of
``andruxa-smirnov/isee3-decoder`` (KA9Q decoder v0.11): PM carrier
demodulation, Manchester symbol demodulation, and hybrid Fano/Viterbi
decoding of the K=24 rate-1/2 MCQLI convolutional code — redesigned as a
batched, block-synchronous streaming framework over device meshes instead
of a UNIX pipe pipeline.

Layout:
  config    — code tables and framing constants (code.h)
  ops       — compute kernels: encoder, Viterbi-224, Fano, carrier DSP,
              symbol matched filter, sync correlation
  models    — pipeline stages as pure (carry, block) -> (carry, out)
              functions plus the full-chain composition
  parallel  — mesh/sharding helpers for multi-chip channel & batch axes
  utils     — metric tables, channel simulator, time formatting, IO
  cli       — command-line front-ends mirroring the reference programs
"""

from isee3_decoder_tpu.config import (
    CODES,
    DEFAULT_CODE,
    FRAMEBITS,
    FRAMESYMBOLS,
    SYNCBITS,
    SYNCWORD,
    SYNC_STATE,
    CodeSpec,
    sync_vector,
)

__version__ = "0.1.0"

__all__ = [
    "CODES",
    "DEFAULT_CODE",
    "FRAMEBITS",
    "FRAMESYMBOLS",
    "SYNCBITS",
    "SYNCWORD",
    "SYNC_STATE",
    "CodeSpec",
    "sync_vector",
    "__version__",
]
