from isee3_decoder_tpu.ops import (  # noqa: F401 — re-exported modules
    carrier,
    channelizer,
    fano,
    reductions,
    symbols,
    syncword,
    viterbi,
    viterbi_inplace,
)
from isee3_decoder_tpu.ops.encode import (
    bits_to_bytes,
    bytes_to_bits,
    encode_bits,
    encode_bytes,
    reencode_symbol_errors,
)

__all__ = [
    "bits_to_bytes",
    "bytes_to_bits",
    "encode_bits",
    "encode_bytes",
    "reencode_symbol_errors",
]
