"""Text frontend: normalization + prompt assembly, the port's own copy of
the JAX package's ``frontend.py`` (pure Python; the port imports nothing
of the JAX package).

The role of CosyVoiceFrontEnd (cosyvoice/cli/frontend.py:39-215).  The
reference delegates heavy normalization to external native libs
(ttsfrd / wetext); here a dependency-free normalizer covers the common
cases (numbers, currency/percent, whitespace/punctuation, paragraph
splitting a la frontend.py's split_paragraph), with a pluggable tokenizer
hook (any HF tokenizer works) and a speaker-info cache (spk2info).
``CosyFrontend``'s ``codec`` is the port's ``codec.SpeechCodec``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import numpy as np

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand"),
          (100, "hundred")]


def number_to_words(n: int) -> str:
    """English number verbalization (the wetext/ttsfrd role for en)."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        return _TENS[tens] + (" " + _ONES[rest] if rest else "")
    for value, name in _SCALE:
        if n >= value:
            head, rest = divmod(n, value)
            out = number_to_words(head) + " " + name
            if rest:
                out += " " + number_to_words(rest)
            return out
    return str(n)


def normalize_text(text: str) -> str:
    """Basic en normalization: currency, percent, decimals, integers,
    whitespace/punct cleanup."""
    text = text.strip()
    text = re.sub(r"\$(\d+(?:\.\d+)?)", lambda m: m.group(1) + " dollars",
                  text)
    text = re.sub(r"(\d+(?:\.\d+)?)%", lambda m: m.group(1) + " percent",
                  text)
    def _decimal(m):
        whole, frac = m.group(1), m.group(2)
        digits = " ".join(_ONES[int(d)] for d in frac)
        return f"{number_to_words(int(whole))} point {digits}"
    text = re.sub(r"(\d+)\.(\d+)", _decimal, text)
    text = re.sub(r"\d+", lambda m: number_to_words(int(m.group(0))), text)
    text = re.sub(r"[\"“”‘’]", "", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


# ---------------------------------------------------------------------------
# Chinese text normalization (the wetext/ttsfrd role for zh,
# cli/frontend.py:125-143).  Dependency-free: number reading, percent,
# decimals, negatives, year digit reading, symbol cleanup, CJK blank removal.
# ---------------------------------------------------------------------------

_ZH_DIGITS = "零一二三四五六七八九"
_ZH_UNITS = ["", "十", "百", "千"]
_ZH_SECTIONS = ["", "万", "亿", "万亿"]
_CJK = re.compile(r"[一-鿿]")


def contains_chinese(text: str) -> bool:
    """cli/frontend_utils.py:21-22 role."""
    return bool(_CJK.search(text))


def _zh_group(n: int) -> str:
    """Read a 0..9999 group with 十百千 units and inner-zero elision."""
    if n == 0:
        return ""
    out = []
    started = False
    zero_pending = False
    for i in range(3, -1, -1):
        d = (n // 10 ** i) % 10
        if d == 0:
            if started:
                zero_pending = True
            continue
        if zero_pending:
            out.append("零")
            zero_pending = False
        out.append(_ZH_DIGITS[d] + _ZH_UNITS[i])
        started = True
    return "".join(out)


def zh_number_to_words(n: int) -> str:
    """Chinese number verbalization for 0 <= |n| < 1e16."""
    if n < 0:
        return "负" + zh_number_to_words(-n)
    if n == 0:
        return "零"
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    out = []
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if g == 0:
            continue
        part = _zh_group(g)
        # a group below 1000 after a higher group needs a leading 零
        if i < len(groups) - 1 and g < 1000 and out:
            part = "零" + part
        out.append(part + _ZH_SECTIONS[i])
    s = "".join(out)
    # 10..19 read as 十X, not 一十X
    if s.startswith("一十"):
        s = s[1:]
    return s


def _zh_digits(s: str) -> str:
    return "".join(_ZH_DIGITS[int(d)] for d in s)


def normalize_zh(text: str) -> str:
    """zh normalization pipeline (cli/frontend.py:125-143 semantics):
    wetext-style number reading plus the cleanup chain the reference applies
    around it."""
    text = text.strip().replace("\n", "")
    # corner marks / brackets / dashes (frontend_utils.py:26-37)
    text = text.replace("²", "平方").replace("³", "立方")
    for ch in "（）【】`":
        text = text.replace(ch, "")
    text = text.replace("——", " ")
    # numbers
    text = re.sub(r"(\d{4})年", lambda m: _zh_digits(m.group(1)) + "年", text)
    text = re.sub(r"(\d+(?:\.\d+)?)%",
                  lambda m: "百分之" + _zh_number_str(m.group(1)), text)
    # a hyphen counts as a minus sign only when NOT sandwiched between
    # digits — '10-20' / '010-1234' are ranges/phone numbers, not
    # negatives
    text = re.sub(r"(?<![\d])-?\d+\.\d+",
                  lambda m: _zh_number_str(m.group(0)), text)
    text = re.sub(r"(?<![\d])-?\d+",
                  lambda m: _zh_number_str(m.group(0)), text)
    # punctuation conventions (cli/frontend.py:133-139)
    text = text.replace(".", "。").replace(" - ", "，")
    text = _replace_blank(text)
    text = re.sub(r"[，,、]+$", "。", text)
    return text


def _zh_number_str(s: str) -> str:
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    if "." in s:
        whole, frac = s.split(".", 1)
        out = zh_number_to_words(int(whole)) + "点" + _zh_digits(frac)
    elif len(s) > 10 or (len(s) > 1 and s[0] == "0"):
        out = _zh_digits(s)                 # id-like: digit by digit
    else:
        out = zh_number_to_words(int(s))
    return ("负" if neg else "") + out


def _replace_blank(text: str) -> str:
    """Remove whitespace adjacent to CJK characters, keep it between
    latin words (frontend_utils.py replace_blank role)."""
    out = []
    for i, ch in enumerate(text):
        if ch == " ":
            prev_cjk = i > 0 and _CJK.match(text[i - 1])
            next_cjk = i + 1 < len(text) and _CJK.match(text[i + 1])
            if prev_cjk or next_cjk:
                continue
        out.append(ch)
    return "".join(out)


_ONLY_PUNC = re.compile(r"^[\s\.,，。！？!?；;：:、\"'“”‘’·…\-]*$")


def is_only_punctuation(text: str) -> bool:
    return bool(_ONLY_PUNC.match(text))


def split_paragraph_budget(text: str, lang: str = "zh",
                           tokenize=None, token_max_n: int = 80,
                           token_min_n: int = 60, merge_len: int = 20,
                           comma_split: bool = False) -> List[str]:
    """Budgeted sentence splitting with the reference's accumulate/merge
    rules (frontend_utils.py:64-117): break at sentence punctuation, pack
    sentences until > token_max_n (if already > token_min_n), merge a short
    tail into the previous piece.  Length is characters for zh, tokens via
    ``tokenize`` for en (falls back to whitespace words)."""
    if lang == "zh":
        pounc = list("。？！；：、") + [".", "?", "!", ";"]
        ender = "。"
    else:
        pounc = [".", "?", "!", ";", ":"]
        ender = "."
    if comma_split:
        pounc += ["，", ","]
    if not text:
        return []
    if text[-1] not in pounc:
        text += ender

    def length(t: str) -> int:
        if lang == "zh":
            return len(t)
        if tokenize is not None:
            return len(tokenize(t))
        return len(t.split())

    utts: List[str] = []
    st = 0
    i = 0
    while i < len(text):
        if text[i] in pounc:
            if i > st:
                utt = text[st:i + 1]
                # attach a trailing close-quote to the sentence
                if i + 1 < len(text) and text[i + 1] in "\"”":
                    utt += text[i + 1]
                    i += 1
                utts.append(utt)
            st = i + 1
        i += 1

    final: List[str] = []
    cur = ""
    for utt in utts:
        if length(cur + utt) > token_max_n and length(cur) > token_min_n:
            final.append(cur)
            cur = ""
        cur += utt
    if cur:
        if length(cur) < merge_len and final:
            final[-1] += cur
        else:
            final.append(cur)
    return [t for t in final if not is_only_punctuation(t)]


def split_paragraph(text: str, max_len: int = 80) -> List[str]:
    """Sentence-ish splitting with a length budget
    (frontend.py split_paragraph role)."""
    parts = re.split(r"(?<=[.!?;。！？；])\s*", text)
    out: List[str] = []
    buf = ""
    for p in parts:
        if not p:
            continue
        if buf and len(buf) + len(p) + 1 > max_len:
            out.append(buf.strip())
            buf = p
        else:
            buf = (buf + " " + p).strip()
    if buf:
        out.append(buf.strip())
    return out


class TextFrontend:
    """normalize -> split -> tokenize, plus the spk2info prompt cache.

    ``tokenize_fn``: text -> list[int] (plug any HF tokenizer's encode).
    """

    def __init__(self, tokenize_fn: Optional[Callable[[str], List[int]]]
                 = None, max_sentence_len: int = 80):
        self.tokenize_fn = tokenize_fn
        self.max_sentence_len = max_sentence_len
        self.spk2info: Dict[str, object] = {}

    def add_speaker(self, name: str, prompt) -> None:
        """Cache a prepared codec Prompt under a speaker id
        (frontend.py spk2info)."""
        self.spk2info[name] = prompt

    def speaker(self, name: str):
        return self.spk2info[name]

    def text_to_token_batches(self, text: str, split: bool = True
                              ) -> List[np.ndarray]:
        assert self.tokenize_fn is not None, "provide tokenize_fn"
        pieces = (split_paragraph(normalize_text(text),
                                  self.max_sentence_len)
                  if split else [normalize_text(text)])
        return [np.asarray(self.tokenize_fn(p), np.int32)[None]
                for p in pieces if p]


class CosyFrontend:
    """Full CosyVoiceFrontEnd role (cli/frontend.py:39-215): zh/en text
    normalization + splitting, speaker cache, and per-mode model-input
    assembly (zero-shot / cross-lingual / instruct / vc) over the codec's
    Prompt type.

    ``codec``: SpeechCodec (for prompt token/feat/embedding extraction);
    ``tokenize_fn``: text -> list[int]."""

    def __init__(self, tokenize_fn: Optional[Callable[[str], List[int]]]
                 = None, codec=None, token_max_n: int = 80,
                 token_min_n: int = 60, merge_len: int = 20):
        self.tokenize_fn = tokenize_fn
        self.codec = codec
        self.token_max_n = token_max_n
        self.token_min_n = token_min_n
        self.merge_len = merge_len
        self.spk2info: Dict[str, dict] = {}

    # -------------------------------------------------------------- text
    def text_normalize(self, text: str, split: bool = True):
        """zh/en branch of the reference normalizer
        (cli/frontend.py:121-150)."""
        text = text.strip()
        if not text:
            return [] if split else text
        if contains_chinese(text):
            text = normalize_zh(text)
            texts = split_paragraph_budget(
                text, "zh", self.tokenize_fn, self.token_max_n,
                self.token_min_n, self.merge_len, comma_split=False)
        else:
            text = normalize_text(text)
            texts = split_paragraph_budget(
                text, "en", self.tokenize_fn, self.token_max_n,
                self.token_min_n, self.merge_len, comma_split=False)
        return texts if split else text

    def _text_ids(self, text: str) -> np.ndarray:
        assert self.tokenize_fn is not None, "provide tokenize_fn"
        return np.asarray(self.tokenize_fn(text), np.int32)[None]

    # ----------------------------------------------------------- speakers
    def add_zero_shot_spk(self, prompt_text: str, prompt_wav_16k,
                          prompt_wav_24k, spk_id: str) -> None:
        """Pre-register a speaker (cli/frontend.py add_zero_shot_spk /
        spk2info)."""
        self.spk2info[spk_id] = self._prompt_inputs(prompt_text,
                                                    prompt_wav_16k,
                                                    prompt_wav_24k)

    def _prompt_inputs(self, prompt_text, prompt_wav_16k, prompt_wav_24k):
        assert self.codec is not None, "provide codec"
        prompt = self.codec.prepare_prompt(prompt_wav_24k, prompt_wav_16k)
        out = {"prompt": prompt}
        if prompt_text:
            out["prompt_text"] = self._text_ids(
                self.text_normalize(prompt_text, split=False))
        return out

    # -------------------------------------------------------------- modes
    def frontend_zero_shot(self, tts_text: str, prompt_text: str,
                           prompt_wav_16k=None, prompt_wav_24k=None,
                           zero_shot_spk_id: str = "") -> dict:
        """Zero-shot voice clone inputs (cli/frontend.py:158-178): LM sees
        prompt text + prompt speech tokens; flow sees prompt tokens/mel and
        the x-vector (feat/token alignment handled by prepare_prompt)."""
        if zero_shot_spk_id:
            base = dict(self.spk2info[zero_shot_spk_id])
        else:
            base = self._prompt_inputs(prompt_text, prompt_wav_16k,
                                       prompt_wav_24k)
        base["text"] = self._text_ids(tts_text)
        return base

    def frontend_cross_lingual(self, tts_text: str, prompt_wav_16k=None,
                               prompt_wav_24k=None,
                               zero_shot_spk_id: str = "") -> dict:
        """Cross-lingual: the LM prompt text/speech tokens are dropped —
        only the flow keeps the speaker prompt (cli/frontend.py:180-187)."""
        out = self.frontend_zero_shot(tts_text, "", prompt_wav_16k,
                                      prompt_wav_24k, zero_shot_spk_id)
        out.pop("prompt_text", None)
        out["llm_use_prompt_tokens"] = False
        return out

    def frontend_instruct(self, tts_text: str, instruct_text: str,
                          prompt_wav_16k=None, prompt_wav_24k=None,
                          zero_shot_spk_id: str = "") -> dict:
        """Instruct mode: the instruction (+ '<|endofprompt|>') becomes the
        LM prompt text; acoustic prompt tokens are dropped from the LM
        (cli/frontend.py:189-205 frontend_instruct2)."""
        out = self.frontend_zero_shot(
            tts_text, instruct_text + "<|endofprompt|>",
            prompt_wav_16k, prompt_wav_24k, zero_shot_spk_id)
        out["llm_use_prompt_tokens"] = False
        return out

    def frontend_vc(self, source_wav_16k, prompt_wav_16k,
                    prompt_wav_24k) -> dict:
        """Voice conversion inputs (cli/frontend.py:207-215): source speech
        tokens + target-speaker flow prompt."""
        assert self.codec is not None, "provide codec"
        out = self._prompt_inputs("", prompt_wav_16k, prompt_wav_24k)
        out["source_speech_token"] = self.codec.encode(source_wav_16k)
        return out
