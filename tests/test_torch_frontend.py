"""The port's text front end (``moss_speech_decoder_cosy_torch/frontend.py``,
its own copy) against the JAX package's: the same functions on the same
English and Chinese strings (numbers, currency and percent, decimals,
digit ranges and phone numbers, years, paragraph budgets) give equal
results, and ``TextFrontend`` / ``CosyFrontend`` split and tokenize the
same way."""

import pytest

from moss_speech_decoder_cosy_tpu import frontend as J
from moss_speech_decoder_cosy_torch import frontend as T


def _tok(text):
    return [ord(c) % 97 for c in text]


EN = "The price rose 12.5% to $3.75 in 2024; 1,024 units sold. Wow!"
ZH = ("今天是2024年10月17日，气温-3.5度，涨幅12%。电话010-1234，"
      "范围10-20人。共有1001个苹果、30005棵树。")
LONG_EN = " ".join(f"Sentence number {i} is here." for i in range(40))
LONG_ZH = "".join(f"这是第{i}句话，内容比较长一些。" for i in range(30))

CASES = [
    ("number_to_words", (0,)), ("number_to_words", (17,)),
    ("number_to_words", (-45,)), ("number_to_words", (1_000_001,)),
    ("number_to_words", (987_654_321,)), ("number_to_words", (3 * 10 ** 9,)),
    ("normalize_text", (EN,)),
    ("normalize_text", ("  “Quoted”   spaces 0.05 and 100% \t",)),
    ("zh_number_to_words", (0,)), ("zh_number_to_words", (10,)),
    ("zh_number_to_words", (15,)), ("zh_number_to_words", (1001,)),
    ("zh_number_to_words", (100_010,)), ("zh_number_to_words", (-2050,)),
    ("zh_number_to_words", (123_456_789_012,)),
    ("normalize_zh", (ZH,)),
    ("normalize_zh", ("（注）面积5m²，体积2m³——约3.14倍，编号007。 ",)),
    ("normalize_zh", ("价格是 99 元 , 折扣 - 8 折，",)),
    ("contains_chinese", (EN,)), ("contains_chinese", (ZH,)),
    ("is_only_punctuation", ("。，！…",)), ("is_only_punctuation", (EN,)),
    ("split_paragraph", (LONG_EN,)), ("split_paragraph", (EN, 20)),
    ("split_paragraph_budget", (LONG_ZH, "zh")),
    ("split_paragraph_budget", (LONG_ZH, "zh", None, 40, 20, 10, True)),
    ("split_paragraph_budget", (LONG_EN, "en")),
    ("split_paragraph_budget", (LONG_EN, "en", _tok, 30, 20, 5)),
    ("split_paragraph_budget", ('He said "stop." Then left', "en")),
    ("split_paragraph_budget", ("", "zh")),
]


@pytest.mark.parametrize("name,args", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_frontend_functions_match_jax(name, args):
    assert getattr(T, name)(*args) == getattr(J, name)(*args)


@pytest.mark.parametrize("text", [EN, ZH, LONG_EN, LONG_ZH])
def test_frontends_split_and_tokenize_like_jax(text):
    tf_t, tf_j = T.TextFrontend(_tok, 40), J.TextFrontend(_tok, 40)
    got = tf_t.text_to_token_batches(text)
    want = tf_j.text_to_token_batches(text)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    cf_t, cf_j = T.CosyFrontend(_tok), J.CosyFrontend(_tok)
    assert cf_t.text_normalize(text) == cf_j.text_normalize(text)
    assert cf_t.text_normalize(text, split=False) == \
        cf_j.text_normalize(text, split=False)
