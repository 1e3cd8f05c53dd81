from .decoder import (
    KAFKA_CODEC_NAMES,
    NativeDecoder,
    PackedBufferPool,
    UnsupportedCodecError,
    native_crc32c,
)

__all__ = [
    "KAFKA_CODEC_NAMES",
    "NativeDecoder",
    "PackedBufferPool",
    "UnsupportedCodecError",
    "native_crc32c",
]
