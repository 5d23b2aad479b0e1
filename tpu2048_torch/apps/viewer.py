"""Desktop (pygame) viewer of the port (``tpu2048/apps/viewer.py``:
the same code, apart from loading the agent's table onto the CPU).

Capability parity with the pygame client of abachurin/2048
(``show.py`` there): a 600x700 window with colored tiles and three
modes — interactive play (arrow keys, R restarts), replay of a stored
game record, and live watch of an agent — implemented against this
framework's store/agent stack.  Import of pygame is deferred so
headless deployments never pay for SDL.  Every mode plays on the host.

Run: ``python -m tpu2048_torch.apps.viewer --store ~/.tpu2048``
"""

from __future__ import annotations

import argparse
import random
from typing import Optional

import numpy as np

from ..engine.parity import ParityGame
from ..features import ntuple
from ..store import checkpoint as ckpt
from ..store.artifacts import ArtifactStore, open_store
from .cli import _pick, _speed, np_estimator

TILE_COLORS = [
    (40, 40, 48), (198, 40, 40), (216, 27, 96), (142, 36, 170),
    (94, 53, 177), (30, 136, 229), (0, 137, 123), (124, 179, 66),
    (67, 160, 71), (251, 140, 0), (244, 81, 30), (109, 76, 65),
    (229, 57, 53), (208, 120, 120), (156, 39, 176), (103, 58, 183),
    (239, 83, 80),
]


class Viewer:
    def __init__(self, title: str = "tpu2048"):
        import pygame

        self.pygame = pygame
        pygame.init()
        pygame.display.set_caption(title)
        self.screen = pygame.display.set_mode((600, 700))
        self.font = pygame.font.SysFont("monospace", 24)

    def draw(self, board: np.ndarray, score: int, odometer: int,
             msg: str = "") -> None:
        pg = self.pygame
        self.screen.fill((18, 18, 24))
        header = self.font.render(
            f"score {score}  moves {odometer}  {msg}", True, (255, 255, 255)
        )
        self.screen.blit(header, (10, 30))
        for i in range(4):
            for j in range(4):
                v = int(board[j, i])
                color = TILE_COLORS[min(v, 16)]
                pg.draw.rect(self.screen, color,
                             (i * 150 + 2, j * 150 + 100 + 2, 146, 146))
                if v:
                    label = self.font.render(str(1 << v), True,
                                             (255, 255, 255))
                    rect = label.get_rect(
                        center=(i * 150 + 75, j * 150 + 175)
                    )
                    self.screen.blit(label, rect)
        pg.display.update()

    def _pump(self) -> bool:
        """Process events; False when the window was closed."""
        for event in self.pygame.event.get():
            if event.type == self.pygame.QUIT:
                self.pygame.quit()
                return False
        return True

    def play(self) -> None:
        pg = self.pygame
        game = ParityGame(rng=random.Random())
        keymap = {pg.K_LEFT: 0, pg.K_UP: 1, pg.K_RIGHT: 2, pg.K_DOWN: 3}
        while True:
            over = game.game_over(game.row)
            self.draw(game.row, game.score, game.odometer,
                      "GAME OVER" if over else "")
            for event in pg.event.get():
                if event.type == pg.QUIT:
                    pg.quit()
                    return
                if event.type == pg.KEYDOWN:
                    if event.key == pg.K_r:
                        game = ParityGame(rng=random.Random())
                    elif event.key in keymap and not over:
                        nr, ns, changed = game.pre_move(
                            game.row, game.score, keymap[event.key]
                        )
                        if changed:
                            game.row, game.score = nr, ns
                            game.odometer += 1
                            game.new_tile()
            pg.time.wait(16)

    def replay(self, store: ArtifactStore, name: str,
               speed_ms: int = 200) -> None:
        rec = ckpt.load_game(store, name)
        g = ParityGame(row=np.array(rec["starting_position"], np.int32))
        for t in range(rec["odometer"]):
            if not self._pump():
                return
            move = int(rec["moves"][t])
            self.draw(g.row, g.score, t,
                      f"next {ParityGame.actions[move]}")
            g.row, g.score, _ = g.pre_move(g.row, g.score, move)
            val, i, j = (int(x) for x in rec["tiles"][t])
            g.row[i, j] = val
            self.pygame.time.wait(speed_ms)
        self.draw(np.asarray(rec["final_board"]), rec["score"],
                  rec["odometer"], "GAME OVER")
        while self._pump():
            self.pygame.time.wait(100)

    def watch(self, store: ArtifactStore, name: str, speed_ms: int = 200,
              depth: int = 0, width: int = 1, since_empty: int = 6) -> None:
        acfg, weights, _ = ckpt.load_agent_dense(store, name, "cpu")
        ts = ntuple.get_tuple_set(acfg.n)
        est = np_estimator(ts, np.asarray(weights))
        game = ParityGame(rng=random.Random())
        for state, move in game.generate_run(
            est, depth=depth, width=width, since_empty=since_empty
        ):
            if not self._pump():
                return
            self.draw(state.row, state.score, state.odometer,
                      f"next {ParityGame.actions[move]}")
            self.pygame.time.wait(speed_ms)
        self.draw(game.row, game.score, game.odometer, "GAME OVER")
        while self._pump():
            self.pygame.time.wait(100)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="tpu2048 pygame viewer")
    p.add_argument("--store", default="~/.tpu2048")
    p.add_argument("--backend", default="local")
    args = p.parse_args(argv)
    store = open_store(args.backend, args.store)
    print("option 0 = play yourself")
    print("option 1 = replay a game from storage")
    print("option 3 = watch a trained agent play")
    try:
        option = int(input("> "))
    except (ValueError, EOFError):
        return
    viewer = Viewer()
    if option == 0:
        viewer.play()
    elif option == 1:
        name = _pick(store, "game")
        if name:
            viewer.replay(store, name, _speed())
    elif option == 3:
        name = _pick(store, "agent")
        if name:
            viewer.watch(store, name, _speed())


if __name__ == "__main__":
    main()
