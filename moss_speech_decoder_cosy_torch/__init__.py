"""moss_speech_decoder_cosy_torch — the PyTorch / CUDA (H100) port of
``moss_speech_decoder_cosy_tpu``.

The JAX package stays the reference; this package mirrors its layout and
class names so each counterpart is easy to find, and imports nothing of it.
Public functions keep the JAX layouts: activations (B, T, C), attention
(B, H, T, dk).  Plain tensor code is PyTorch; each Pallas kernel of the JAX
package becomes a hand-written Hopper kernel under ``csrc/``, built with
``nvcc`` at first use and bound with ``ctypes``.

Layout
------
- ``ops``       masks, activations, norms, convs, embeddings, STFT/iSTFT,
                attention, and the flash chunk-attention kernel wrapper.
- ``models``    ``flow`` (tokens -> mel, conditional flow matching),
                ``hift`` (mel -> waveform vocoder) and ``llm`` (the Qwen2
                speech LM and the v1 TransformerLM: text -> tokens).
- ``pipeline``  ``AudioDecoder``: offline ``token2wav``, the windowed
                ``StreamSession`` and its device-resident twin
                ``device_stream_decoder``, the KV session and the
                continuous batcher.
- ``serving``   the decode server (asyncio batch engine, ``/decode_stream``),
                the websocket voice server and web page, Opus / Ogg, the
                boot warm-up, the multi-stream manager.
- ``model_dir`` a reference-layout checkpoint directory -> decoder, codec,
                speaker prompts (``utils/checkpoint.py``: the reference's
                torch key names -> this package's).
- ``synthesizer`` text ids -> speech tokens -> waveform; ``frontend``
                text normalization and splitting.
- ``weights``   JAX param trees -> this package's state dicts.
- ``bin``       CLIs: ``inference``, ``serve``, ``decode_server`` and the
                card's measurement tools.
- ``csrc``      CUDA C++ kernels (``sm_90a``); ``native`` host C++.
"""

__version__ = "0.1.0"
