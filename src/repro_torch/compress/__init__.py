"""repro_torch.compress -- lossless page codecs + quantized gradient transport.

Counterpart of `repro.compress`. Shrinks the host and host-to-device bytes
the out-of-core pipeline moves: ELLPACK bin pages pack to
``ceil(log2(n_bins))`` bits (``"bitpack"``, expanded on the card by the
bitpack decode kernel), sorted/sparse pages delta+RLE code on disk
(``"delta-rle"``), paged-forest chunks pack node fields to 14 bytes
(``ForestPageTransport``), and histogram spills narrow to f16/bf16/int8
(``GradQuantizer``). Defaults (``"raw"`` everywhere) are bit for bit the
uncompressed paths.
"""

from .codecs import (
    BitpackCodec,
    CodecChain,
    DeltaRLECodec,
    EncodedPage,
    ForestPageTransport,
    PageCodec,
    PageTransport,
    RawCodec,
    available_codecs,
    get_codec,
    make_transport,
    model_bits,
    register_codec,
)
from .grad import GRAD_TRANSPORTS, PSUM_TRANSPORTS, GradQuantizer

__all__ = [
    "PageCodec",
    "RawCodec",
    "BitpackCodec",
    "DeltaRLECodec",
    "CodecChain",
    "register_codec",
    "get_codec",
    "available_codecs",
    "PageTransport",
    "ForestPageTransport",
    "make_transport",
    "model_bits",
    "GradQuantizer",
    "GRAD_TRANSPORTS",
    "PSUM_TRANSPORTS",
]
