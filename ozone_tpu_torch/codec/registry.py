"""Codec registry with priority ordering and fallback.

Port of `ozone_tpu/codec/registry.py` (the reference's CodecRegistry,
erasurecode CodecRegistry.java:55-97, and CodecUtil.
createRawEncoderWithFallback, rawcoder/util/CodecUtil.java:55-82):
backends are tried in priority order and the first one that constructs
wins. The CUDA coder ("torch", codec/torch_coder.py) is one factory next
to the host C++ coder ("cpp") and the numpy reference ("numpy"):

    rs:    torch 100, cpp 50 (when its library builds), numpy 10
    xor:   torch 100, numpy 10
    lrc:   numpy 10
    dummy: numpy 10

Registering builds and imports nothing on the GPU. Without CUDA the
torch constructor raises and the next backend is taken; once a coder is
constructed, a kernel build or launch error raises from its
encode/decode, so no call steps past a broken kernel. `device` reaches
the torch factory only.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from ozone_tpu_torch.codec.api import (
    KNOWN_FAMILIES,
    CoderOptions,
    RawErasureDecoder,
    RawErasureEncoder,
)

log = logging.getLogger(__name__)

EncoderFactory = Callable[..., RawErasureEncoder]
DecoderFactory = Callable[..., RawErasureDecoder]


def known_families() -> tuple[str, ...]:
    """Codec family names a CoderOptions string may use, sorted: the
    default families and any registered since, read from the live
    registry when one exists, without creating it."""
    reg = CodecRegistry._instance
    if reg is None:
        return KNOWN_FAMILIES
    return tuple(sorted(set(KNOWN_FAMILIES) | set(reg._factories)))


class _Factory:
    def __init__(self, name: str, priority: int, make_encoder, make_decoder,
                 takes_device: bool = False):
        self.name = name
        self.priority = priority
        self.make_encoder = make_encoder
        self.make_decoder = make_decoder
        self.takes_device = takes_device


class CodecRegistry:
    """codec name -> ordered list of backend factories."""

    _instance: Optional["CodecRegistry"] = None

    def __init__(self):
        self._factories: dict[str, list[_Factory]] = {}

    @classmethod
    def instance(cls) -> "CodecRegistry":
        if cls._instance is None:
            reg = cls()
            reg._register_defaults()
            cls._instance = reg
        return cls._instance

    def register(
        self,
        codec: str,
        backend: str,
        priority: int,
        make_encoder: EncoderFactory,
        make_decoder: DecoderFactory,
        takes_device: bool = False,
    ) -> None:
        """Higher priority is tried first (reference CodecRegistry.java:
        92-97). `takes_device`: the factories accept a `device` keyword."""
        lst = self._factories.setdefault(codec, [])
        lst.append(_Factory(backend, priority, make_encoder, make_decoder,
                            takes_device))
        lst.sort(key=lambda f: -f.priority)

    def backends(self, codec: str) -> list[str]:
        return [f.name for f in self._factories.get(codec, [])]

    def _register_defaults(self) -> None:
        from ozone_tpu_torch.codec import numpy_coder, torch_coder

        self.register("rs", "numpy", 10, numpy_coder.NumpyRSEncoder,
                      numpy_coder.NumpyRSDecoder)
        self.register("xor", "numpy", 10, numpy_coder.NumpyXOREncoder,
                      numpy_coder.NumpyXORDecoder)
        self.register("dummy", "numpy", 10, numpy_coder.DummyEncoder,
                      numpy_coder.DummyDecoder)
        self.register("lrc", "numpy", 10, numpy_coder.NumpyLRCEncoder,
                      numpy_coder.NumpyLRCDecoder)
        # the host C++ coder: above numpy, below the device coder, as the
        # reference's native coder sits (CodecRegistry.java:92-97)
        try:
            from ozone_tpu_torch.codec import cpp_coder

            cpp_coder.load()
            self.register("rs", "cpp", 50, cpp_coder.CppRSEncoder,
                          cpp_coder.CppRSDecoder)
        except Exception as e:  # noqa: BLE001 - no compiler on this host
            log.warning("cpp codec backend unavailable: %s", e)
        self.register("rs", "torch", 100, torch_coder.TorchRSEncoder,
                      torch_coder.TorchRSDecoder, takes_device=True)
        self.register("xor", "torch", 100, torch_coder.TorchXOREncoder,
                      torch_coder.TorchXORDecoder, takes_device=True)

    def _create(self, options: CoderOptions, what: str, backend: Optional[str],
                device=None):
        factories = self._factories.get(options.codec)
        if not factories:
            raise ValueError(f"no coder registered for codec {options.codec!r}")
        if backend is not None:
            factories = [f for f in factories if f.name == backend]
            if not factories:
                raise ValueError(
                    f"backend {backend!r} not registered for {options.codec!r}"
                )
        errors = []
        for f in factories:
            try:
                maker = f.make_encoder if what == "encoder" else f.make_decoder
                if device is not None and f.takes_device:
                    return maker(options, device=device)
                return maker(options)
            except Exception as e:  # noqa: BLE001 - fall through to the next backend
                errors.append(f"{f.name}: {e}")
                log.warning("codec backend %s failed for %s, falling back: %s",
                            f.name, options, e)
        raise RuntimeError(
            f"all backends failed for {options.codec} {what}: {'; '.join(errors)}"
        )

    def create_encoder(self, options: CoderOptions, backend: Optional[str] = None,
                       device=None) -> RawErasureEncoder:
        return self._create(options, "encoder", backend, device)

    def create_decoder(self, options: CoderOptions, backend: Optional[str] = None,
                       device=None) -> RawErasureDecoder:
        return self._create(options, "decoder", backend, device)


def create_encoder(options: CoderOptions, backend: Optional[str] = None,
                   device=None) -> RawErasureEncoder:
    return CodecRegistry.instance().create_encoder(options, backend, device)


def create_decoder(options: CoderOptions, backend: Optional[str] = None,
                   device=None) -> RawErasureDecoder:
    return CodecRegistry.instance().create_decoder(options, backend, device)
