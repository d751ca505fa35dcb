"""The traffic generator: a seed gives the same requests every time; every
seed sends the mix's set of sizes (a closed loop in the seed's own order)
and, open loop, at the mix's Poisson arrivals."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench.traffic import Traffic, sizes

HERE = Path(__file__).resolve().parent
MIXES = {p.stem: json.loads(p.read_text())
         for p in (HERE / "traffic").glob("*.json")}
SEED = 2_147_483_747                       # past 32 signed bits
VOCAB = 152064


def take(mix, seed, seconds=40.0):
    t = Traffic(mix, seed, VOCAB)
    if mix["loop"] == "open":
        return t.open_loop(seconds)
    return t.closed_loop(seconds)


def shapes(reqs):
    return [(len(r.prompt), r.max_new_tokens, r.arrival_s) for r in reqs]


@pytest.mark.parametrize("name", sorted(MIXES))
def test_same_seed_same_requests(name):
    a, b = take(MIXES[name], SEED), take(MIXES[name], SEED)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new_tokens, x.arrival_s) == (y.max_new_tokens,
                                                   y.arrival_s)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_every_seed_the_same_work(name):
    mix = MIXES[name]
    a, b = take(mix, SEED), take(mix, SEED + 1)
    key = "rate_per_s" if mix["loop"] == "open" else "requests_per_s"
    assert len(a) == len(b) == round(mix[key] * 40.0)
    assert sorted(s[:2] for s in shapes(a)) == \
        sorted(s[:2] for s in shapes(b)) == sorted(sizes(mix, len(a)))
    assert not np.array_equal(a[0].prompt[:8], b[0].prompt[:8])
    lo, hi = mix["prompt_len"]
    for r in a:
        assert lo <= len(r.prompt) <= hi
        assert mix["answer_len"][0] <= r.max_new_tokens \
            <= mix["answer_len"][1]
        assert len(r.prompt) + r.max_new_tokens <= 4096
        assert (r.prompt >= 3).all() and (r.prompt < VOCAB).all()
    assert len({r.uid for r in a}) == len(a)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_the_seed_draws_the_order(name):
    """A closed loop's order is the seed's; an open loop's schedule is
    the mix's."""
    mix = MIXES[name]
    orders = {tuple(shapes(take(mix, SEED + k))) for k in range(4)}
    assert len(orders) == (4 if mix["loop"] == "closed" else 1)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_sizes_keep_their_rows_as_the_pool_grows(name):
    mix = MIXES[name]
    assert sizes(mix, 50)[:7] == sizes(mix, 7)


def test_closed_loop_sends_its_whole_pool():
    mix = MIXES["docs1"]
    for seconds in (10.0, 40.0):
        reqs = take(mix, SEED, seconds)
        assert len(reqs) == round(mix["requests_per_s"] * seconds)
        assert all(r.arrival_s == 0.0 for r in reqs)


def test_open_loop_arrivals_are_poisson_given_their_count():
    """Arrivals within the window, in order; over many schedule seeds the
    gaps are exponential (coefficient of variation 1, the mean 1 / rate)
    and the counts of any stretch vary as a binomial's, so bursts
    happen."""
    mix = {**MIXES["chat-poisson"], "rate_per_s": 2.5}
    gaps, first_half = [], []
    for k in range(200):
        t = np.array([r.arrival_s for r in
                      take({**mix, "schedule_seed": k}, SEED)])
        assert len(t) == 100 and 0.0 < t[0] and t[-1] < 40.0
        assert np.all(np.diff(t) > 0)
        gaps.extend(np.diff(t))
        first_half.append(int((t < 20.0).sum()))
    g = np.array(gaps)
    assert abs(g.mean() - 0.4) < 0.01
    assert abs(g.std() / g.mean() - 1.0) < 0.05
    # binomial(100, 1/2): standard deviation 5
    assert 4.0 < np.std(first_half) < 6.0
    a = take(mix, SEED)
    b = take({**mix, "schedule_seed": mix["schedule_seed"] + 1}, SEED)
    assert [r.arrival_s for r in a] != [r.arrival_s for r in b]


def test_sizes_are_log_uniform_and_independent():
    mix = {"schedule_seed": 1, "prompt_len": [32, 512],
           "answer_len": [128, 2048]}
    s = np.array(sizes(mix, 20000), dtype=float)
    # the log-uniform mean of [lo, hi]: (hi - lo) / ln(hi / lo)
    assert abs(s[:, 0].mean() / (480 / np.log(16)) - 1.0) < 0.02
    assert abs(s[:, 1].mean() / (1920 / np.log(16)) - 1.0) < 0.02
    lg = np.log(s)
    assert abs(np.corrcoef(lg[:, 0], lg[:, 1])[0, 1]) < 0.03
    assert s[:, 0].min() == 32 and s[:, 0].max() == 512


def test_warmup_is_apart_from_the_window():
    mix = MIXES["chat-poisson"]
    t = Traffic(mix, SEED, VOCAB)
    w = t.warmup()
    assert len(w[0].prompt) == mix["prompt_len"][1] and w[0].uid < 0
    fresh = Traffic(mix, SEED, VOCAB).open_loop(40.0)
    assert all(np.array_equal(x.prompt, y.prompt)
               for x, y in zip(t.open_loop(40.0), fresh))
