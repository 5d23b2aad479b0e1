"""The byte counts of the rooflines and the step shares against hand
counts."""

import pytest

from harness import roofline


def test_grad_class_bytes_by_hand():
    # one call: 8 rows of 17 tuples, 16^2 x 16^2 blocks, 6 valid rows
    calls = [((8, 17), (8, 17), (8,), (8,), 256, 256)]
    want = 8 + 2 * 17 * 256 * 256 * 4 + 6 * (2 * 17 * 4 + 4)
    assert roofline.grad_class_bytes(calls, 6) == want


def test_eval_class_bytes_by_hand():
    calls = [((17, 256, 256), (100, 17), (100, 17), "bf16"),
             ((17, 256, 256), (4, 17), (4, 17), "bf16")]
    assert roofline.eval_class_bytes(calls) == \
        (2 * 100 * 17 * 4 + 400) + (2 * 4 * 17 * 4 + 16)


def test_train_step_bytes_by_hand():
    # n=5: 17 whole tuples, 4 canonical; per env 48 state bytes, 4
    # afterstates' and the bootstrap's 21 entries, 8 * 17 + 4 updated
    # entries in three tables read and written, 2 log bytes
    per = 48 + 4 * 21 * 4 + 21 * 4 + (8 * 17 + 4) * 24 + 2
    assert roofline.train_step_bytes(10, 17, 4) == 10 * per


def test_search_bytes_by_hand():
    assert roofline.search_bytes(1000, 21) == 1000 * (21 * 4 + 12)


def test_share():
    assert roofline.share(3.35e12, 1.0) == pytest.approx(100.0)
    assert roofline.share(3.35e9, 0.01) == pytest.approx(10.0)
