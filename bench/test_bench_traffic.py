"""The traffic generator: deterministic in the seed, the mix's weights held
in every block, batches from points, and the mix files' schema."""

import itertools

import pytest

from bench import loops, registry, traffic


MIX = {"loop": "closed", "clients": 1, "n": [[8, 1], [16, 2], [32, 1]],
       "batch": {"points": 1024}}


def _take(t, seed, k):
    return list(itertools.islice(traffic.requests(t, seed), k))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 12345, 2 ** 40 + 7])
def test_requests_are_deterministic_in_the_seed(seed):
    assert _take(MIX, seed, 400) == _take(MIX, seed, 400)


def test_seeds_change_the_order_not_the_work():
    a, b = _take(MIX, 5, 400), _take(MIX, 6, 400)
    assert a != b
    assert sorted(a) == sorted(b)


@pytest.mark.parametrize("seed", [3, 4, 2 ** 31 + 1])
def test_weights_hold_in_every_block(seed):
    got = _take(MIX, seed, 4 * 100)
    for k in range(100):
        block = got[4 * k:4 * k + 4]
        assert sorted(block) == [(8, 16), (16, 4), (16, 4), (32, 1)]


@pytest.mark.parametrize("n, batch", [(1024, 64), (2048, 16), (4096, 4), (8192, 1)])
def test_batch_from_points(n, batch):
    assert traffic.batch_of({"batch": {"points": 2 ** 26}}, n) == batch


def test_batch_as_a_number_and_shapes():
    t = {"n": [[64, 3], [128, 1]], "batch": 2}
    assert traffic.shapes(t) == [(64, 2), (128, 2)]


@pytest.mark.parametrize("bad", [
    {"n": [[64, 1]], "loop": "sideways"},
    {"n": [[64, 1]], "loop": "open"},
    {"n": [[64, 0]]},
    {"n": []},
    {"n": [[64, 1]], "batch": {"points": 1000}},
    {"n": [[64, 1]], "clients": 0},
])
def test_validate_refuses(bad):
    with pytest.raises(ValueError):
        traffic.validate(bad)


def test_open_loop_arrivals_are_seeded_at_the_rate():
    t = {"n": [[64, 1]], "loop": "open", "rate": 200.0}
    traffic.validate(t)
    a = list(itertools.islice(traffic.arrivals(t, 9), 4000))
    assert a == list(itertools.islice(traffic.arrivals(t, 9), 4000))
    assert all(x < y for x, y in zip(a, a[1:]))
    assert abs(len(a) / a[-1] - 200.0) < 200.0 * 0.1


@pytest.mark.parametrize("name", [w["traffic"] for w in registry.benchmark()["workloads"]])
def test_every_mix_file_validates_and_rehearses(name):
    t = registry.data("traffic", name)
    traffic.validate(t)
    small = traffic.validate({**t, **t["rehearse"]})
    assert all(n * n * b <= 2 ** 16 for n, b in traffic.shapes(small))


def test_the_reservoir_samples_uniformly_from_the_seed():
    counts = [0] * 5
    for seed in range(2000):
        r = loops.Reservoir(seed, held={"s": "set-up"})
        assert r.sampled == {} and r.kept == {"s": "set-up"}
        for i in range(5):
            r.offer("s", i)
        counts[r.sampled["s"]] += 1
    assert all(abs(c - 400) < 100 for c in counts)
    a, b = loops.Reservoir(9), loops.Reservoir(9)
    for i in range(50):
        a.offer("s", i)
        b.offer("s", i)
    assert a.sampled == b.sampled


def test_the_reservoir_holds_a_placeholder_until_the_window_s_first_answer():
    r = loops.Reservoir(3, held={"s": "set-up", "t": "set-up"})
    r.offer("s", 0)
    assert r.kept == {"s": 0, "t": "set-up"} and r.sampled == {"s": 0}
