"""Native (C) host pieces, bound with ctypes and built at first use."""

from dense2sparse_vit_torch.native.normalize import (
    native_available,
    normalize_u8,
    normalize_u8_reference,
)

__all__ = ["native_available", "normalize_u8", "normalize_u8_reference"]
