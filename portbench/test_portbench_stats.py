"""The percentile and rate arithmetic on hand-made request lists; a stall
moves every end-to-end metric the wrong way."""
import copy

import pytest

from portbench import stats
from portbench.stats import Rec


def window(stall: float = 0.0, at: float = 5.0):
    """20 requests due every 0.5 s, each admitted at once, first token
    0.2 s later, then 9 more tokens 0.05 s apart; ``stall`` seconds of
    stall at ``at`` delay everything after it."""
    recs, events = [], []
    for i in range(20):
        due = 0.5 * i
        shift = stall if due >= at else 0.0
        first = due + 0.2 + shift
        finish = first + 9 * 0.05
        if due < at < finish:
            finish += stall
        recs.append(Rec(i, 100, 10, due, admit=due + shift, first=first,
                        finish=finish, tokens=10))
        events.append((first, 1))
        for k in range(1, 10):
            t = first + 0.05 * k
            events.append((t + (stall if first < at <= t else 0.0), 1))
    return recs, events


def test_nearest_rank():
    v = list(range(1, 101))
    assert stats.nearest_rank(v, 90) == 90
    assert stats.nearest_rank(v, 50) == 50
    assert stats.nearest_rank([3.0], 90) == 3.0
    assert stats.nearest_rank(list(range(1, 11)), 95) == 10
    with pytest.raises(ValueError):
        stats.nearest_rank([], 50)


def test_hand_made_window():
    recs, events = window()
    assert stats.tpot_ms(recs, 100.0) == pytest.approx(50.0)
    assert stats.ttft_ms(recs, 90, 100.0) == pytest.approx(200.0)
    assert stats.queue_wait_ms(recs, 90, 100.0) == pytest.approx(0.0)
    # 20 x 10 tokens, the last at 9.5 + 0.2 + 0.45
    assert stats.tokens_per_s_open(events, 0.0, 20.0) == pytest.approx(10.0)
    assert stats.tokens_per_s_closed(recs, 0.0) == pytest.approx(
        200 / 10.15)
    assert stats.mean_ttft_ms(recs) == pytest.approx(200.0)
    assert stats.failed(recs) == 0


def test_only_requests_finished_by_the_close_count_for_tpot():
    recs, _ = window()
    late = copy.deepcopy(recs)
    late[-1].finish += 100.0
    assert stats.tpot_ms(late, 20.0) == pytest.approx(50.0)


def test_a_stall_moves_every_end_to_end_metric():
    base, ev0 = window()
    slow, ev1 = window(stall=2.0, at=5.0)
    assert stats.tpot_ms(slow, 100.0) > stats.tpot_ms(base, 100.0)
    assert stats.ttft_ms(slow, 90, 100.0) > stats.ttft_ms(base, 90, 100.0)
    assert stats.queue_wait_ms(slow, 90, 100.0) > \
        stats.queue_wait_ms(base, 90, 100.0)
    assert stats.tokens_per_s_open(ev1, 0.0, 10.0) < \
        stats.tokens_per_s_open(ev0, 0.0, 10.0)
    assert stats.tokens_per_s_closed(slow, 0.0) < \
        stats.tokens_per_s_closed(base, 0.0)


def test_a_missing_request_counts_as_waiting_to_the_end():
    recs, _ = window()
    recs[3].first = recs[3].finish = recs[3].admit = None
    recs[4].first = recs[4].finish = recs[4].admit = None
    assert stats.failed(recs) == 2
    # 2 of 20 missing reach the 90th percentile: they waited until 60 s
    assert stats.ttft_ms(recs, 90, 60.0) == pytest.approx(200.0)
    recs[5].first = recs[5].finish = None
    assert stats.ttft_ms(recs, 90, 60.0) == pytest.approx(1e3 * (60 - 2.5))
