"""The draw seam: where every random number of the engine comes from.

The JAX reference draws from threefry keys split on a fixed schedule
(``tpu2048/train/trial.py:200-201, :85``; the train step's
``tpu2048/agent/td.py:195``, ``:201`` and ``:400``); torch generators
have no twin of that.  So the port's engine, trial and train step
never draw for themselves: they ask a draw source, through methods
named after the reference's draw sites.

``TorchDraws`` serves production from one ``torch.Generator``.  A
test can pass a source that replays the reference's own key schedule,
so both packages play the same games from the same draws;
``NumpyDraws`` gives the same numbers on every device, so a run on
the card and a run on the CPU can be fed identical draws.
"""

from __future__ import annotations

from typing import Protocol, Tuple

import numpy as np
import torch

NewDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


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


class TorchDraws:
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


class NumpyDraws:
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
