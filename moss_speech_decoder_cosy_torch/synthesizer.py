"""Text -> speech synthesis, LM + flow + vocoder end to end, after the JAX
package's ``synthesizer.py`` (the role of CosyVoice.inference_{sft,
zero_shot,cross_lingual}, cosyvoice/cli/cosyvoice.py:81-194, and
cli/model.py's llm -> flow hand-off).

Text normalization and tokenization are the caller's (``frontend.py``;
the reference delegates them to ttsfrd / wetext and a HF tokenizer): the
API takes text TOKEN IDS.  The LM and the decoder live on their own
devices (CUDA unless asked otherwise); tokens pass between them as numpy.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .codec import Prompt
from .models.llm.speech_lm import Qwen2SpeechLM
from .pipeline import AudioDecoder


class SpeechSynthesizer:
    def __init__(self, lm: Qwen2SpeechLM, decoder: AudioDecoder,
                 max_tokens: int = 512):
        self.lm = lm
        self.decoder = decoder
        self.max_tokens = max_tokens

    def _prompt(self, prompt: Optional[Prompt]) -> Prompt:
        if prompt is not None:
            return prompt
        return Prompt(np.zeros((1, 0), np.int32),
                      np.zeros((1, 0, self.decoder.flow_cfg.output_size),
                               np.float32),
                      np.zeros((1, self.decoder.flow_cfg.spk_embed_dim),
                               np.float32))

    def generate_tokens(self, text_ids: np.ndarray,
                        prompt: Optional[Prompt] = None, seed: int = 0
                        ) -> np.ndarray:
        """text ids (1, Tt) -> speech tokens (1, n), the prompt speaker's
        tokens as acoustic prefix (llm.py:428-462); at least the reference's
        text ratio (``min_token_text_ratio`` x Tt) of them."""
        p = self._prompt(prompt)
        toks, n = self.lm(np.asarray(text_ids), np.asarray(p.token),
                          seed=seed, max_len=self.max_tokens)
        return toks[:n].cpu().numpy()[None]

    def tts(self, text_ids: np.ndarray, prompt: Optional[Prompt] = None,
            streaming: bool = False, seed: int = 0, speed: float = 1.0
            ) -> np.ndarray:
        """The inference_zero_shot / sft path -> (1, samples) at the
        vocoder's rate: offline through ``token2wav``, or ``streaming``
        through the windowed ``stream_inference``."""
        p = self._prompt(prompt)
        tokens = self.generate_tokens(text_ids, prompt, seed)
        if tokens.shape[1] == 0:
            return np.zeros((1, 0), np.float32)
        if streaming:
            return self.decoder.stream_inference(
                tokens, p.token, p.feat, p.embedding)
        return self.decoder.token2wav(tokens, p.token, p.feat, p.embedding,
                                      speed=speed)

    def tts_stream(self, text_ids: np.ndarray,
                   prompt: Optional[Prompt] = None, seed: int = 0
                   ) -> Iterator[np.ndarray]:
        """Yield wav chunks as a decoder session consumes the generated
        tokens (cli/model.py's producer / consumer, host-side)."""
        p = self._prompt(prompt)
        sess = self.decoder.new_session(p.token, p.feat, p.embedding)
        tokens = self.generate_tokens(text_ids, prompt, seed)
        yield from sess.push(tokens[0])
        yield from sess.finish()
