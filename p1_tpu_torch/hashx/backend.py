"""``HashBackend`` ABC and the port's own plugin registry.

The port's copy of ``p1_tpu/hashx/backend.py``: the same ``@register``
decorator, ``get_backend(name)`` factory and lazy table, but a registry of
its own — names registered here never reach ``p1_tpu``'s, and the reverse.

The two operations every backend provides:

- ``sha256d(data)`` — one double-SHA-256 (validation path).
- ``search(prefix, nonce_start, count, difficulty)`` — scan candidate nonces
  ``[nonce_start, nonce_start+count)`` over a 76-byte header prefix and
  return the **earliest** nonce whose SHA-256d meets the difficulty target,
  or None.  This is the miner's hot loop.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Callable, Iterator

from p1_tpu_torch.core.header import NONCE_OFFSET


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Outcome of scanning a nonce range."""

    nonce: int | None  # earliest hit, or None
    hashes_done: int  # how many candidates were evaluated


class HashBackend(abc.ABC):
    """A pluggable SHA-256d implementation."""

    #: Registry key; set by @register.
    name: str = "?"

    @abc.abstractmethod
    def sha256d(self, data: bytes) -> bytes:
        """Double SHA-256 of ``data`` (32 raw bytes out)."""

    @abc.abstractmethod
    def search(
        self, header_prefix: bytes, nonce_start: int, count: int, difficulty: int
    ) -> SearchResult:
        """Find the earliest nonce in [nonce_start, nonce_start+count) whose
        header hash meets ``difficulty`` leading zero bits.

        ``header_prefix`` is the first ``NONCE_OFFSET`` (76) bytes of the
        serialized header.  The scanned range must stay within uint32 space.
        """

    def _check_search_args(
        self, header_prefix: bytes, nonce_start: int, count: int, difficulty: int
    ) -> None:
        if len(header_prefix) != NONCE_OFFSET:
            raise ValueError(
                f"header prefix must be {NONCE_OFFSET} bytes, got {len(header_prefix)}"
            )
        if not 0 <= nonce_start <= 0xFFFFFFFF:
            raise ValueError(f"nonce_start={nonce_start} out of uint32 range")
        if count < 0 or nonce_start + count > 1 << 32:
            raise ValueError("nonce range exceeds uint32 space")
        if not 0 <= difficulty <= 255:
            raise ValueError(f"difficulty={difficulty} out of range")


_REGISTRY: dict[str, type[HashBackend]] = {}
_LAZY_BACKENDS: dict[str, Callable[[], type[HashBackend]]] = {}
_INSTANCES: dict[tuple, HashBackend] = {}


def register(name: str) -> Callable[[type[HashBackend]], type[HashBackend]]:
    """Class decorator: ``@register("cpu")`` adds the backend to the registry."""

    def deco(cls: type[HashBackend]) -> type[HashBackend]:
        if name in _REGISTRY:
            raise ValueError(f"hash backend {name!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        # A direct `import p1_tpu_torch.hashx.<module>` fulfills the lazy
        # entry without going through _resolve; drop it so the name isn't
        # listed twice and _resolve never re-imports a loaded module.
        _LAZY_BACKENDS.pop(name, None)
        return cls

    return deco


def register_lazy(name: str, loader: Callable[[], type[HashBackend]]) -> None:
    """Register a backend whose module should only import on first use."""
    if name in _REGISTRY or name in _LAZY_BACKENDS:
        raise ValueError(f"hash backend {name!r} already registered")
    _LAZY_BACKENDS[name] = loader


def _resolve(name: str) -> type[HashBackend]:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _LAZY_BACKENDS:
        # The loader's module is expected to @register(name) on import,
        # which also removes the lazy entry.  A failed import leaves the
        # entry in place so the error surfaces again on retry.
        _LAZY_BACKENDS[name]()
        if name not in _REGISTRY:
            raise RuntimeError(f"lazy loader for {name!r} did not register it")
        return _REGISTRY[name]
    raise KeyError(
        f"unknown hash backend {name!r}; available: {sorted(available_backends())}"
    )


def get_backend(name: str, **kwargs) -> HashBackend:
    """Instantiate (and memoize) a backend by registry name."""
    key = (name, tuple(sorted(kwargs.items())))
    if key not in _INSTANCES:
        _INSTANCES[key] = _resolve(name)(**kwargs)
    return _INSTANCES[key]


def available_backends() -> Iterator[str]:
    yield from _REGISTRY
    yield from _LAZY_BACKENDS
