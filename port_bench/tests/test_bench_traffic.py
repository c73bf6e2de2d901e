"""The seeded traffic: the same seed gives the same requests, another seed
others, and every seed sends the same mix of lengths."""

import numpy as np

from port_bench.harness import spec
from port_bench.harness.traffic import Traffic, lengths


def _traffics():
    bench = spec.benchmark()
    return [spec.resolve(w["name"], bench).traffic for w in bench["workloads"]]


def test_same_seed_same_requests():
    for tr in _traffics():
        a, b = Traffic(tr, 2**31 + 17), Traffic(tr, 2**31 + 17)
        for i in (0, 5, 300):
            ra, rb = a.get(i), b.get(i)
            assert np.array_equal(ra.tokens, rb.tokens)
            assert np.array_equal(ra.speaker, rb.speaker)


def test_other_seed_other_requests():
    for tr in _traffics():
        a, b = Traffic(tr, 11), Traffic(tr, 12)
        ra, rb = [a.get(i) for i in range(8)], [b.get(i) for i in range(8)]
        assert [r.n_tokens for r in ra] != [r.n_tokens for r in rb]
        assert not np.array_equal(ra[0].speaker, rb[0].speaker)
        assert not np.array_equal(ra[0].tokens[:8], rb[0].tokens[:8])


def test_request_independent_of_how_many_taken():
    tr = _traffics()[0]
    a, b = Traffic(tr, 99), Traffic(tr, 99)
    [a.get(i) for i in range(50)]
    assert np.array_equal(a.get(50).tokens, b.get(50).tokens)


def test_every_seed_sends_the_same_lengths():
    for tr in _traffics():
        n = tr["tokens"]["strata"]
        mixes = {tuple(sorted(Traffic(tr, s).length(i) for i in range(n)))
                 for s in (1, 2, 3 * 10**9)}
        assert len(mixes) == 1
        ls = lengths(tr["tokens"])
        assert min(ls) >= tr["tokens"]["min"] and max(ls) <= tr["tokens"]["max"]


def test_ids_and_speakers_in_range():
    for tr in _traffics():
        r = Traffic(tr, 5).get(3)
        assert r.tokens.dtype == np.int32 and r.tokens.min() >= 0
        assert r.tokens.max() < tr["vocab"]
        assert r.speaker.shape == (tr["speaker_dim"],)


def test_lognormal_median():
    spec_ = {"dist": "lognormal", "median": 100, "sigma": 0.6, "min": 40,
             "max": 375, "strata": 256}
    ls = sorted(lengths(spec_))
    assert 95 <= ls[128] <= 105
