"""The plain reference against hand-worked boards, and its feature
geometry against the program's."""

import json
import os

import numpy as np
import pytest
import torch

from reference import features, game, search

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def board(rows):
    return torch.tensor(rows, dtype=torch.int64).reshape(1, 16)


def tuples(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return features.tuples_from_config(json.load(f)["tuples"])


@pytest.mark.parametrize("direction,want,score", [
    (0, [[2, 1, 0, 0], [3, 0, 0, 0], [1, 2, 1, 0], [2, 0, 0, 0]], 4 + 8 + 4),
    (2, [[0, 0, 1, 2], [0, 0, 0, 3], [0, 1, 2, 1], [0, 0, 0, 2]], 4 + 8 + 4),
    (1, [[1, 1, 2, 1], [2, 3, 1, 0], [1, 0, 0, 0], [0, 0, 0, 0]], 8 + 4),
    (3, [[0, 0, 0, 0], [1, 0, 0, 0], [2, 1, 1, 0], [1, 3, 2, 1]], 8 + 4),
])
def test_moves_by_hand(direction, want, score):
    b = board([[1, 1, 1, 0], [2, 2, 0, 0], [1, 2, 1, 0], [0, 0, 1, 1]])
    after, sc, legal = game.move(b, direction)
    assert after.reshape(4, 4).tolist() == want
    assert int(sc) == score and bool(legal)


def test_left_row_by_hand():
    b = board([[1, 1, 1, 0], [2, 2, 0, 0], [1, 2, 1, 0], [0, 0, 1, 1]])
    after, sc, legal = game.move(b, 0)
    assert after.reshape(4, 4).tolist() == [
        [2, 1, 0, 0], [3, 0, 0, 0], [1, 2, 1, 0], [2, 0, 0, 0]]
    assert int(sc) == 4 + 8 + 4 and bool(legal)


def test_up_by_hand():
    b = board([[1, 0, 0, 0], [1, 0, 0, 0], [2, 0, 0, 0], [2, 0, 0, 3]])
    after, sc, _ = game.move(b, 1)
    assert after.reshape(4, 4).tolist() == [
        [2, 0, 0, 3], [3, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]
    assert int(sc) == 4 + 8


def test_no_legal_move():
    b = board([[1, 2, 1, 2], [2, 1, 2, 1], [1, 2, 1, 2], [2, 1, 2, 1]])
    _, _, legal = game.afterstates(b)
    assert not bool(legal.any())


def test_spawn_by_hand():
    b = board([[1, 0, 1, 0], [0, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 0]])
    # empty cells in row-major order: 1, 3, 4, 15; u = 0.6 -> the third
    out, pos, val = game.spawn(b, torch.tensor([0.6]), torch.tensor([0.95]))
    assert int(pos) == 4 and int(val) == 2 and int(out[0, 4]) == 2
    out, pos, val = game.spawn(b, torch.tensor([0.999]), torch.tensor([0.1]))
    assert int(pos) == 15 and int(val) == 1


def test_fresh_by_hand():
    out = game.fresh(torch.tensor([5]), torch.tensor([0.5]),
                     torch.tensor([5]), torch.tensor([0.95]))
    # the second tile skips the first's cell
    assert out[0, 5] == 1 and out[0, 6] == 2 and int((out > 0).sum()) == 2


def test_codes_round_trip():
    b = torch.randint(0, 16, (50, 16))
    assert torch.equal(game.from_codes(game.to_codes(b)), b)


def test_indices_by_hand():
    ts = tuples("n5_champion")
    b = board([[1, 2, 3, 4], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]])
    # tuple 4 is row 0, cells in order: 1*16^3 + 2*16^2 + 3*16 + 4
    idx = features.indices(ts, b, (4,))
    assert int(idx) == ts.offsets[4] + 1 * 4096 + 2 * 256 + 3 * 16 + 4


def test_clip_base_14():
    ts = tuples("n6_flagship")
    f = next(f for f in range(len(ts.cells)) if ts.bases[f] == 14)
    b = torch.full((1, 16), 15, dtype=torch.int64)
    idx = features.indices(ts, b, (f,))
    assert int(idx) == ts.offsets[f] + sum(13 * 14 ** j for j in range(6))


@pytest.mark.parametrize("n,name", [(5, "n5_champion"), (6, "n6_flagship")])
def test_geometry_is_the_programs(n, name):
    """The configuration's tuples, read by the reference's own geometry,
    give the program's indices and canonical indices."""
    from tpu2048_torch.features.canonical import canonical_gather_indices
    from tpu2048_torch.features.ntuple import feature_indices, get_tuple_set

    ts, rts = get_tuple_set(n), tuples(name)
    assert rts.total == ts.total
    b = torch.randint(0, 16, (400, 16), generator=torch.Generator()
                      .manual_seed(n))
    assert torch.equal(feature_indices(ts, b).long(),
                       features.indices(rts, b, tuple(range(len(rts.cells)))))
    canon, _ = canonical_gather_indices(ts, b)
    assert torch.equal(canon.long(), features.canonical_indices(rts, b))


def test_canonical_index_is_orbit_invariant():
    rts = tuples("n5_champion")
    b = torch.randint(0, 12, (64, 16))
    perms = torch.from_numpy(features.symmetries())
    base = features.canonical_indices(rts, b)
    for s in range(8):
        # the image board's canonical entries are the same set
        img = features.canonical_indices(rts, b[:, perms[s]])
        assert torch.equal(img.sort(dim=1).values, base.sort(dim=1).values)


def test_search_tiers():
    assert search.tiers(4096) == [64, 256, 1024, 4096]
    assert search.tiers(64) == [64]
    assert np.all(np.diff(search.tiers(1 << 14)) > 0)
