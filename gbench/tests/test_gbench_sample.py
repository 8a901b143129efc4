"""The checked sample of a window's calls: uniform over the calls, of its
size whatever the number of calls, the same for the same seed."""
import random

from gbench.harness import Sample


def _draw(seed, calls, size=4):
    s = Sample(size, random.Random(seed))
    for k in range(calls):
        s.offer(k, k)
    return sorted(s.kept)


def test_size_and_repeatability():
    assert _draw(1, 2) == [0, 1]
    assert len(_draw(1, 1000)) == 4
    assert _draw(7, 500) == _draw(7, 500)
    assert _draw(7, 500) != _draw(8, 500)


def test_uniform_over_the_calls():
    hits = [0] * 10
    for seed in range(4000):
        for k in _draw(seed, 10, size=2):
            hits[k] += 1
    # each call is kept with probability 2/10: 800 of 4000 draws
    assert all(700 < h < 900 for h in hits), hits
