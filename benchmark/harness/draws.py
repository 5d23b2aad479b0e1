"""The benchmark's random inputs, keyed so that the reference can make
the same numbers again.

Every draw the program asks for (a spawn, a fresh start, a search
level) is made from a key: the run's seed and the draw's place, such as
("spawn", 17) for the 17th step's spawn.  A ``torch.Generator`` on the
device is seeded from the key's hash and makes the numbers.  So a draw
depends only on its key and shape, never on what was drawn before it,
and the reference rebuilds any of them from the key alone
(``KeyedDraws.remake``).

``KeyedDraws`` serves the program through its draw seam (the methods
of ``tpu2048_torch.draws.Draws``); it imports nothing of the program.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import torch

NOISE_MIN = 1e-6  # the search's Gumbel noise lies in [1e-6, 1)


def key_seed(*parts) -> int:
    """A 63-bit seed from a key's parts."""
    h = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


class _Source:
    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def _gen(self, *key) -> torch.Generator:
        self.gen.manual_seed(key_seed(self.seed, *key))
        return self.gen

    def rand(self, key: tuple, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self._gen(*key),
                          device=self.device, dtype=torch.float32)

    def starts(self, key: tuple, n: int):
        """(p1, u1, p2r, u2) of ``n`` fresh boards."""
        g = self._gen(*key)
        p1 = torch.randint(0, 16, (n,), generator=g, device=self.device,
                           dtype=torch.int32)
        u1 = torch.rand((n,), generator=g, device=self.device)
        p2r = torch.randint(0, 15, (n,), generator=g, device=self.device,
                            dtype=torch.int32)
        u2 = torch.rand((n,), generator=g, device=self.device)
        return p1, u1, p2r, u2

    def spawn_pair(self, key: tuple, n: int):
        u = self.rand(key + ("u",), (n,))
        return u, self.rand(key + ("v",), (n,))

    def level(self, key: tuple, b: int, width: int):
        noise = self.rand(key + ("noise",), (b, 16)) * (1.0 - NOISE_MIN) \
            + NOISE_MIN
        return noise, self.rand(key + ("tile",), (b, width))


class SearchKey:
    """A node of the search's key tree: a chunk of roots and each level
    below take keys of their own, as a split key does."""

    def __init__(self, source: _Source, path: tuple):
        self.source, self.path = source, path

    def chunks(self, n: int):
        return [SearchKey(self.source, self.path + ("chunk", i))
                for i in range(n)]

    def level(self, depth: int, b: int, width: int):
        noise, u = self.source.level(self.path + ("level", depth), b, width)
        return noise, u, SearchKey(self.source, self.path + ("below", depth))


class KeyedDraws(_Source):
    """The program's draw source.  ``split`` starts the next step; a
    step's spawn, start and search draws are keyed by the step's
    number, and fresh starts outside a step by their own count."""

    def __init__(self, seed: int, device):
        super().__init__(seed, device)
        self.step = -1  # no step started yet
        self.new_calls = 0

    def split(self) -> None:
        self.step += 1

    def spawn(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.spawn_pair(("spawn", self.step), n)

    def new(self, n: int):
        self.new_calls += 1
        return self.starts(("new", self.new_calls - 1), n)

    def reset(self, n: int):
        return self.starts(("reset", self.step), n)

    def uniform(self, shape) -> torch.Tensor:
        return self.rand(("uniform", self.step), tuple(shape))

    def search(self) -> SearchKey:
        return SearchKey(self, ("search", self.step))

    def remake(self) -> _Source:
        """A fresh source of the same seed, for the reference."""
        return _Source(self.seed, self.device)
