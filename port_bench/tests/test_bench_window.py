"""The window arithmetic: all the work over all the window, and tails over
every request sent, a failed or stalled request missing them."""

import math

from port_bench.harness.window import Record, percentile, summarize


def _rec(i, t_send, first, last, chunks, audio_s=1.0, error=None):
    return Record(i, 10, audio_s, t_send, first, last, error, chunks)


def test_audio_counted_where_it_arrived():
    recs = [_rec(0, 0.0, 1.0, 5.0, [(1.0, 100), (5.0, 100)]),
            _rec(1, 9.0, 9.5, 12.0, [(9.5, 100), (12.0, 300)])]
    s = summarize(recs, 0.0, 10.0, 100)
    assert s["audio_x_realtime"] == (100 + 100 + 100) / 100 / 10.0
    assert s["attempted"] == 2 and s["failed"] == 0


def test_requests_sent_after_the_window_not_counted():
    recs = [_rec(0, 0.0, 1.0, 2.0, [(1.0, 10)]),
            _rec(1, 10.5, 11.0, 12.0, [(11.0, 10)])]
    assert summarize(recs, 0.0, 10.0, 10)["attempted"] == 1


def test_p95_nearest_rank_over_all_requests():
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile(list(range(1, 21)), 95) == 19
    assert percentile([3.0], 95) == 3.0


def test_failed_and_stalled_requests_miss_the_tail():
    good = [_rec(i, 0.0, 0.1, 0.5, [(0.1, 10)]) for i in range(19)]
    stalled = _rec(19, 0.0, 0.2, None, [(0.2, 10)])
    failed = _rec(20, 0.0, None, None, [], error="boom")
    s = summarize(good + [stalled], 0.0, 10.0, 10)
    assert s["failed"] == 1
    assert s["request_rtf_p95"] == 0.5
    s = summarize(good + [stalled, failed], 0.0, 10.0, 10)
    assert s["failed"] == 2
    assert math.isinf(s["request_rtf_p95"])
    assert math.isinf(s["first_audio_p95_ms"])


def test_first_audio_and_rtf():
    r = _rec(0, 1.0, 1.25, 3.0, [(1.25, 5)], audio_s=4.0)
    assert r.first_ms() == 250.0
    assert r.rtf() == 0.5
