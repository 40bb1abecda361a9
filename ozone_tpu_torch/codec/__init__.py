"""Erasure-codec layer: GF(2^8) math, the fused CUDA kernel, the raw coder
SPI (torch, cpp and numpy coders behind a registry) and the codec service.

Port of `ozone_tpu/codec/__init__.py`. Its exports resolve on first use,
so importing the package (or any module in it) builds nothing and
creates no registry.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "CoderOptions": "ozone_tpu_torch.codec.api",
    "RawErasureEncoder": "ozone_tpu_torch.codec.api",
    "RawErasureDecoder": "ozone_tpu_torch.codec.api",
    "CodecRegistry": "ozone_tpu_torch.codec.registry",
    "create_encoder": "ozone_tpu_torch.codec.registry",
    "create_decoder": "ozone_tpu_torch.codec.registry",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)
