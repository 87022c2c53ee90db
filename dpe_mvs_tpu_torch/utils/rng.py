"""Explicit random keys, following the JAX package's key schedule call for
call.

The JAX package draws every random number through ``jax.random`` keys
(``split``, ``fold_in``, ``uniform``). The port keeps that structure: every
function that draws takes a key object with the methods

    key.split(n)                -> list of n child keys
    key.fold_in(i)              -> child key for the integer i
    key.uniform(shape, lo, hi)  -> float32 tensor in [lo, hi)
    key.randint(shape, lo, hi)  -> int32 tensor in [lo, hi)

and each key is consumed by at most one ``uniform`` or ``randint`` call,
exactly where the JAX function consumes its key. :class:`TorchKey` is the
implementation of the main path: a 64-bit seed; children derive their seeds
from the parent's seed and the split or fold index through a fixed integer
hash, and ``uniform`` and ``randint`` draw from a ``torch.Generator`` on the
target device seeded with the key's seed. A run is therefore reproducible
from its root seed. The tests substitute an
adapter that calls ``jax.random`` itself, so the port's stage functions draw
the very numbers the JAX functions draw.
"""
from __future__ import annotations

from typing import List

import torch

_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64 finaliser."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


class TorchKey:
    """A key backed by ``torch.Generator``s on ``device``."""

    _SPLIT = 0x5EED5EED
    _FOLD = 0xF01DF01D

    def __init__(self, seed: int, device="cpu"):
        self.seed = int(seed) & _MASK
        self.device = torch.device(device)

    def _child(self, tag: int, i: int) -> "TorchKey":
        return TorchKey(_mix(_mix(self.seed ^ tag) + (int(i) & _MASK)),
                        self.device)

    def split(self, n: int = 2) -> List["TorchKey"]:
        return [self._child(self._SPLIT, i) for i in range(n)]

    def fold_in(self, i) -> "TorchKey":
        return self._child(self._FOLD, int(i))

    def _generator(self) -> torch.Generator:
        g = torch.Generator(device=self.device)
        # manual_seed takes a signed 64-bit value range on some devices.
        g.manual_seed(self.seed & 0x7FFFFFFFFFFFFFFF)
        return g

    def uniform(self, shape, lo=0.0, hi=1.0) -> torch.Tensor:
        g = self._generator()
        u = torch.rand(tuple(shape), generator=g, device=self.device,
                       dtype=torch.float32)
        lo = torch.as_tensor(lo, dtype=torch.float32, device=self.device)
        hi = torch.as_tensor(hi, dtype=torch.float32, device=self.device)
        return torch.maximum(lo, u * (hi - lo) + lo)

    def randint(self, shape, lo: int, hi: int) -> torch.Tensor:
        return torch.randint(int(lo), int(hi), tuple(shape),
                             generator=self._generator(), device=self.device,
                             dtype=torch.int32)
