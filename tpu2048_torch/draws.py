"""The draw seam: where every random number of the engine comes from.

The JAX reference draws from threefry keys split on a fixed schedule
(``tpu2048/train/trial.py:200-201, :85``; the train step's
``tpu2048/agent/td.py:195``, ``:201`` and ``:400``; the search tree's
``tpu2048/search/expectimax.py:151``, ``:234``); torch generators
have no twin of that.  So the port's engine, trial, search and train
step never draw for themselves: they ask a draw source, through
methods named after the reference's draw sites.

``TorchDraws`` serves production from one ``torch.Generator``.  A
test can pass a source that replays the reference's own key schedule,
so both packages play the same games from the same draws;
``NumpyDraws`` gives the same numbers on every device, so a run on
the card and a run on the CPU can be fed identical draws.
``EnvSliceDraws`` gives one rank of a data-parallel run its env range
of the global batch's draws, so the games do not depend on the number
of ranks.
"""

from __future__ import annotations

from typing import List, Protocol, Tuple

import numpy as np
import torch

NewDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# the Gumbel noise's range (expectimax.py:113): no empty cell scores 0
NOISE_MIN = 1e-6


class SearchKey(Protocol):
    """The draws of one expectimax tree, in the shape of the
    reference's key: a tree level or a chunk of roots gets its own
    key, derived from its parent's."""

    def chunks(self, n: int) -> List["SearchKey"]:
        """One key per chunk of a chunked root batch
        (``split(key, chunks)``)."""

    def level(self, depth: int, b: int, width: int
              ) -> Tuple[torch.Tensor, torch.Tensor, "SearchKey"]:
        """The spawn draws of the tree level at ``depth`` over ``b``
        boards, and the key of the level below: ``k_spawn, k_rec =
        split(fold_in(key, depth))``, ``kp, kv = split(k_spawn)``;
        returns (Gumbel noise (b, 16) f32 in [1e-6, 1) from ``kp``,
        tile-value uniforms (b, width) f32 from ``kv``, ``k_rec``)."""


class Draws(Protocol):
    def split(self) -> None:
        """Advance to the next step's draws (trial's per-step
        ``key, k_est, k_spawn = split(key, 3)``; the train step's
        ``key, k_spawn, k_reset = split(key, 3)``)."""

    def spawn(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(u, v): two (n,) f32 uniforms in [0, 1) for one spawn —
        position and value (``fast.spawn_codes``)."""

    def new(self, n: int) -> NewDraws:
        """(p1, u1, p2r, u2) for the initial boards (``fast.new_codes``):
        p1 in [0, 16) and p2r in [0, 15) int32, u1 and u2 f32
        uniforms for the two tile values."""

    def reset(self, n: int) -> NewDraws:
        """The same four draws for a train step's auto-reset of the
        whole batch (``fast.reset_where_codes``)."""

    def uniform(self, shape: Tuple[int, ...]) -> torch.Tensor:
        """f32 uniforms of ``shape``: the random-baseline policy of
        trial, and the initial weight table of a fresh train state."""

    def search(self) -> SearchKey:
        """The key of this step's expectimax estimator (trial's
        ``k_est``)."""


class _OneStream:
    """A search key for a source with one stream: every chunk and
    level draws next from the same stream, so the key is the source.
    Subclasses give ``uniform``."""

    def search(self) -> "_OneStream":
        return self

    def chunks(self, n: int) -> List["_OneStream"]:
        return [self] * n

    def level(self, depth: int, b: int, width: int):
        noise = self.uniform((b, 16)) * (1.0 - NOISE_MIN) + NOISE_MIN
        return noise, self.uniform((b, width)), self


class TorchDraws(_OneStream):
    """Draws from one ``torch.Generator``, on the generator's device.

    One stream serves every draw site, so ``split`` has nothing to do.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def split(self) -> None:
        pass

    def uniform(self, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          device=self.device, dtype=torch.float32)

    def spawn(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.uniform((n,)), self.uniform((n,))

    def _randint(self, high: int, n: int) -> torch.Tensor:
        return torch.randint(0, high, (n,), generator=self.generator,
                             device=self.device, dtype=torch.int32)

    def new(self, n: int) -> NewDraws:
        return (self._randint(16, n), self.uniform((n,)),
                self._randint(15, n), self.uniform((n,)))

    reset = new


class NumpyDraws(_OneStream):
    """Draws from a seeded ``numpy`` generator, as tensors on
    ``device``: the same numbers whatever the device.  Each call copies
    from host memory, which synchronises a CUDA stream, so this source
    is for checks, not for speed."""

    def __init__(self, seed: int, device):
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def split(self) -> None:
        pass

    def uniform(self, shape: Tuple[int, ...]) -> torch.Tensor:
        return self._t(self.rng.random(shape, dtype=np.float32))

    def spawn(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.uniform((n,)), self.uniform((n,))

    def new(self, n: int) -> NewDraws:
        return (self._t(self.rng.integers(0, 16, n, dtype=np.int32)),
                self.uniform((n,)),
                self._t(self.rng.integers(0, 15, n, dtype=np.int32)),
                self.uniform((n,)))

    reset = new


class EnvSliceDraws:
    """Rank ``rank`` of ``world``'s share of another source's draws.

    Every rank seeds the same source.  A per-env draw of ``n`` (this
    rank's envs) draws the global batch's ``n * world`` numbers and
    keeps rows ``[rank * n, (rank + 1) * n)``; ``uniform`` (the fresh
    weight table) is drawn whole, the same on every rank.  So every
    rank's source advances alike: any rank's generator state is the
    run's, and the global batch's draws are those of one rank alone."""

    def __init__(self, inner: Draws, rank: int, world: int):
        self.inner, self.rank, self.world = inner, rank, world

    def _mine(self, draw, n: int):
        rows = slice(self.rank * n, (self.rank + 1) * n)
        return tuple(t[rows] for t in draw(n * self.world))

    def split(self) -> None:
        self.inner.split()

    def uniform(self, shape: Tuple[int, ...]) -> torch.Tensor:
        return self.inner.uniform(shape)

    def spawn(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._mine(self.inner.spawn, n)

    def new(self, n: int) -> NewDraws:
        return self._mine(self.inner.new, n)

    def reset(self, n: int) -> NewDraws:
        return self._mine(self.inner.reset, n)
