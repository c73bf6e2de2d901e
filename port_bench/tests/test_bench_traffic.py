"""The seeded traffic: the same seed gives the same requests, another seed
others, and every seed sends the same mix of lengths; a ``prompt`` block
adds prompts and moves no other draw.  The tests of every listed cell's
traffic run over the listed cells and over them with the speech-LM
fixture added (``bench_root``)."""

import hashlib

import numpy as np
import pytest

from port_bench.harness import spec
from port_bench.harness.traffic import Traffic, lengths


@pytest.fixture(scope="module")
def traffics(bench_root):
    bench, root = bench_root
    return [spec.resolve(w["name"], bench, root).traffic
            for w in bench["workloads"]]


def test_same_seed_same_requests(traffics):
    for tr in traffics:
        a, b = Traffic(tr, 2**31 + 17), Traffic(tr, 2**31 + 17)
        for i in (0, 5, 300):
            ra, rb = a.get(i), b.get(i)
            assert np.array_equal(ra.tokens, rb.tokens)
            assert np.array_equal(ra.speaker, rb.speaker)
            assert np.array_equal(ra.prompt, rb.prompt)


def test_other_seed_other_requests(traffics):
    for tr in traffics:
        a, b = Traffic(tr, 11), Traffic(tr, 12)
        ra, rb = [a.get(i) for i in range(8)], [b.get(i) for i in range(8)]
        assert [r.n_tokens for r in ra] != [r.n_tokens for r in rb]
        assert not np.array_equal(ra[0].tokens[:8], rb[0].tokens[:8])
        if tr.get("speaker_dim"):
            assert not np.array_equal(ra[0].speaker, rb[0].speaker)
        if "prompt" in tr:
            assert not np.array_equal(ra[0].prompt[:4], rb[0].prompt[:4])


def test_request_independent_of_how_many_taken(traffics):
    for tr in traffics:
        a, b = Traffic(tr, 99), Traffic(tr, 99)
        [a.get(i) for i in range(50)]
        ra, rb = a.get(50), b.get(50)
        assert np.array_equal(ra.tokens, rb.tokens)
        assert np.array_equal(ra.prompt, rb.prompt)


def test_every_seed_sends_the_same_lengths(traffics):
    for tr in traffics:
        n = tr["tokens"]["strata"]
        mixes = {tuple(sorted(Traffic(tr, s).length(i) for i in range(n)))
                 for s in (1, 2, 3 * 10**9)}
        assert len(mixes) == 1
        ls = lengths(tr["tokens"])
        assert min(ls) >= tr["tokens"]["min"] and max(ls) <= tr["tokens"]["max"]


def test_ids_and_speakers_in_range(traffics):
    for tr in traffics:
        r = Traffic(tr, 5).get(3)
        assert r.tokens.dtype == np.int32 and r.tokens.min() >= 0
        assert r.tokens.max() < tr["vocab"]
        assert r.speaker.shape == (tr.get("speaker_dim", 0),)
        p = tr.get("prompt")
        assert r.prompt.dtype == np.int32
        if p is None:
            assert r.prompt.shape == (0,)
        else:
            assert p["min"] <= len(r.prompt) <= p["max"]
            assert r.prompt.min() >= 0 and r.prompt.max() < p["vocab"]


def test_lognormal_median():
    spec_ = {"dist": "lognormal", "median": 100, "sigma": 0.6, "min": 40,
             "max": 375, "strata": 256}
    ls = sorted(lengths(spec_))
    assert 95 <= ls[128] <= 105


# sha256 of chat_closed16's first 200 requests (index, length, token and
# speaker bytes), as the generator gave them before prompts existed
FROZEN = {7: "f205163bb7f86d260d6186475c5886c3329a77d0eb5eef136f81c3536a2c4bcf",
          2**31 + 17:
          "f6183aa347639ecdc83cfb7171227b52ae692ab6b1b5ec29be182c41b04d7fd1",
          3 * 10**9 + 11:
          "6618d5240b852ce1d239fceabfb5cd7aa5f8e90ce456fbcb2a267db8748c9cf5"}


def _digest(traffic, seed, n=200):
    t, h = Traffic(traffic, seed), hashlib.sha256()
    for i in range(n):
        r = t.get(i)
        for part in (np.int64(r.index), np.int64(r.n_tokens), r.tokens,
                     r.speaker):
            h.update(part.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(FROZEN))
def test_chat_closed16_stream_unchanged(seed):
    tr = spec.resolve("moss_serve16").traffic
    assert "prompt" not in tr
    assert _digest(tr, seed) == FROZEN[seed]
    r = Traffic(tr, seed).get(0)
    assert r.prompt.dtype == np.int32 and r.prompt.shape == (0,)


PROMPT = {"dist": "uniform", "min": 4, "max": 16, "strata": 8, "vocab": 128}


def test_prompt_block_moves_no_other_draw():
    tr = spec.resolve("moss_serve16").traffic
    with_prompt = dict(tr, prompt=PROMPT)
    assert _digest(with_prompt, 7) == FROZEN[7]


def test_prompts_stratified_and_in_range():
    tr = dict(spec.resolve("moss_serve16").traffic, prompt=PROMPT)
    n = PROMPT["strata"]
    mixes = {tuple(sorted(Traffic(tr, s).prompt_length(i) for i in range(n)))
             for s in (1, 2, 3 * 10**9)}
    assert mixes == {tuple(sorted(lengths(PROMPT)))}
    a, b = Traffic(tr, 5), Traffic(tr, 5)
    for i in (0, 3, 40):
        p = a.get(i).prompt
        assert p.dtype == np.int32 and len(p) == a.prompt_length(i)
        assert 4 <= len(p) <= 16 and 0 <= p.min() and p.max() < 128
        assert np.array_equal(p, b.get(i).prompt)
    other = Traffic(tr, 6).get(0).prompt
    assert not np.array_equal(other[:4], a.get(0).prompt[:4])
