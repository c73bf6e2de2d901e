"""One-call loader of a reference-layout model directory (the JAX package's
``model_dir.py``).

The reference loads a checkpoint directory in three places:
``AudioDecoder`` (GLM_modules/flow_inference.py:48-92: config.yaml +
flow.pt + hift.pt + campplus.onnx), ``CosyVoice2`` (cosyvoice/cli/
cosyvoice.py:27-80: adds the speech tokenizer and spk2info.pt) and
``GLM4Encoder`` (whisper_encoder_decoder.py:35-118: the WhisperVQ
tokenizer).  ``load_model_dir`` is the one call here: it parses the
hyperpyyaml ``config.yaml`` (utils/ref_config.py), converts every torch
checkpoint it finds (utils/checkpoint.py) and builds the objects that
serve, on one device (CUDA unless ``device="cpu"``):

    md = load_model_dir("path/to/model_dir")      # flow.pt + hift.pt [+...]
    wav = md.decoder.token2wav(tokens)            # (1, T * ratio * 480)
    wav = md.codec.decode(tokens, md.prompt("spk"))   # with a tokenizer

Files (all optional but flow.pt and hift.pt):

    config.yaml       hyperpyyaml model config -> FlowConfig / HiFTConfig;
                      v1 or v2 from the flow's class name (without it:
                      ``moss_flow_config()`` and ``moss_hift_config()``,
                      or the ``cosyvoice1_*`` presets with
                      ``flow_version="v1"``)
    flow.pt           flow decoder weights (CausalMaskedDiffWithXvec, or
                      the v1 MaskedDiffWithXvec)
    hift.pt           vocoder weights (``generator.`` prefix stripped)
    campplus.onnx     speaker x-vector -> the port's CAMPPlus
                      (``SpeakerEncoder.from_onnx``)
    spk2info.pt       speaker prompt cache (cli/frontend.py:60-66)
    <tokenizer>       HF-layout WhisperVQ directory (config.json +
                      model.safetensors) through ``tokenizer=`` or a
                      ``speech_tokenizer/`` subdirectory

A CosyVoice-v1 directory (a ``MaskedDiffWithXvec`` flow at 22.05 kHz, the
stock GLM-4-Voice decoder) gives a ``V1Decoder`` with the same decode
surface (``token2wav``, ``new_session``, ``stream_inference``).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def tokenizer_config_from_json(path):
    """HF ``config.json`` of the GLM-4-Voice tokenizer -> the port's
    ``WhisperVQConfig``."""
    from .tokenizer.config import WhisperVQConfig
    with open(path) as f:
        c = json.load(f)
    return WhisperVQConfig(
        num_mel_bins=c.get("num_mel_bins", 128),
        d_model=c.get("d_model", 1280),
        attention_heads=c.get("encoder_attention_heads", 20),
        ffn_dim=c.get("encoder_ffn_dim", 5120),
        encoder_layers=c.get("encoder_layers", 32),
        quantize_position=c.get("quantize_position", 16),
        pooling_kernel_size=c.get("pooling_kernel_size", 4),
        quantize_vocab_size=c.get("quantize_vocab_size", 16384),
        max_source_positions=c.get("max_source_positions", 1500),
        causal_attention=c.get("encoder_causal_attention", True),
        quantize_causal_block_size=c.get("quantize_causal_block_size", 200),
        quantize_ema_decay=c.get("quantize_ema_decay", 0.99),
        quantize_commit_coefficient=c.get("quantize_commit_coefficient",
                                          0.25),
        quantize_loss_scale=c.get("quantize_loss_scale", 10.0),
        quantize_restart_interval=c.get("quantize_restart_interval", 100),
        decoder_layers=c.get("decoder_layers", 4),
        decoder_attention_heads=c.get("decoder_attention_heads", 20),
        decoder_ffn_dim=c.get("decoder_ffn_dim", 5120),
        vocab_size=c.get("vocab_size", 51866),
        max_target_positions=c.get("max_target_positions", 448),
    )


class V1Decoder:
    """Token -> wav of the v1 stack (the CosyVoiceModel decode role,
    cosyvoice/cli/model.py:29-238) on one device (CUDA unless
    ``device="cpu"``): offline ``token2wav`` and the growing-hop
    ``new_session`` (``pipeline/stream_v1.py``), the surface of
    ``pipeline.AudioDecoder`` that ``load_model_dir`` and ``SpeechCodec``
    use.  ``compute_dtype`` casts the flow (the ODE carry stays f32); the
    vocoder runs in f32.  ``ratio`` is mel frames a token, fractional
    (22050 / 256 / 50 ~= 1.72)."""

    def __init__(self, flow_cfg, hift_cfg, flow_state, hift_state,
                 mel_hop: int = 256, compute_dtype=None, device=None):
        from .models.flow.flow_v1 import MaskedDiffWithXvec
        from .models.hift import HiFTGenerator
        from .utils.device import resolve_device
        self.device = resolve_device(device)
        self.flow_cfg, self.hift_cfg = flow_cfg, hift_cfg
        self.compute_dtype = compute_dtype
        with torch.device("meta"):
            flow = MaskedDiffWithXvec(flow_cfg)
            hift = HiFTGenerator(hift_cfg)
        flow.load_state_dict(flow_state, strict=True, assign=True)
        hift.load_state_dict(hift_state, strict=True, assign=True)
        self.flow = flow.to(self.device).eval()
        self.hift = hift.to(self.device).eval()
        if compute_dtype is not None:
            self.flow.to(compute_dtype)
        self.mel_hop = mel_hop
        self.ratio = (hift_cfg.sampling_rate / mel_hop
                      / flow_cfg.input_frame_rate)

    def _defaults(self, prompt_token, prompt_feat, embedding):
        if prompt_token is None:
            prompt_token = np.zeros((1, 0), np.int32)
        if prompt_feat is None:
            prompt_feat = np.zeros(
                (1, int(round(prompt_token.shape[1] * self.ratio)),
                 self.flow_cfg.output_size), np.float32)
        if embedding is None:
            embedding = np.zeros((1, self.flow_cfg.spk_embed_dim),
                                 np.float32)
        return prompt_token, prompt_feat, embedding

    def mel_len(self, n_tokens: int) -> int:
        """Mel frames of ``n_tokens`` (flow.py:128, truncated)."""
        return int(n_tokens / self.flow_cfg.input_frame_rate
                   * self.hift_cfg.sampling_rate / self.mel_hop)

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device,
                                                           dtype)

    @torch.inference_mode()
    def flow_mel(self, token, prompt_token=None, prompt_feat=None,
                 embedding=None) -> torch.Tensor:
        """The offline flow's mel after the prompt, (1, mel_len, n_mel)
        f32 on the device."""
        pt, pf, emb = self._defaults(prompt_token, prompt_feat, embedding)
        token = np.asarray(token).reshape(1, -1)
        mel, _ = self.flow.inference(
            self._tensor(token, torch.long), self._tensor(pt, torch.long),
            self._tensor(pf, torch.float32), self._tensor(emb, torch.float32),
            self.mel_len(token.shape[1]))
        return mel

    @torch.inference_mode()
    def token2wav(self, token, prompt_token=None, prompt_feat=None,
                  embedding=None) -> np.ndarray:
        """Offline decode (the flow without caches, then HiFT),
        cli/model.py:133-163; (1, mel_len * total_upsample) f32."""
        mel = self.flow_mel(token, prompt_token, prompt_feat, embedding)
        wav, _ = self.hift(mel)
        return wav.float().cpu().numpy()

    def new_session(self, prompt_token=None, prompt_feat=None,
                    embedding=None, **kw):
        """A ``StreamSessionV1``; ``kw`` its hop and cache options."""
        from .pipeline.stream_v1 import StreamSessionV1
        pt, pf, emb = self._defaults(prompt_token, prompt_feat, embedding)
        return StreamSessionV1(self.flow, self.hift, pt, pf, emb,
                               sample_rate=self.hift_cfg.sampling_rate,
                               mel_hop=self.mel_hop, **kw)

    def stream_inference(self, token, prompt_token=None, prompt_feat=None,
                         embedding=None, block_size=None,
                         max_token_len=None, **kw) -> np.ndarray:
        """All tokens through one session.  v1 hops follow their own
        schedule (2 x frame rate growing to 4 x), so ``block_size`` and
        ``max_token_len`` (``AudioDecoder``'s, passed by ``SpeechCodec``)
        are accepted and ignored."""
        sess = self.new_session(prompt_token, prompt_feat, embedding, **kw)
        chunks = sess.push_tokens(np.asarray(token).reshape(-1))
        chunks.append(sess.finalize())
        return np.concatenate([c.reshape(-1) for c in chunks])[None]


@dataclasses.dataclass
class ModelDir:
    """What ``load_model_dir`` built.  ``decoder`` is always there;
    ``codec`` only with a tokenizer checkpoint, ``speaker_encoder`` only
    with campplus.onnx.  ``report`` counts each file's unused reference
    keys."""
    path: str
    flow_version: str                    # "v1" | "v2"
    flow_cfg: Any
    hift_cfg: Any
    decoder: Any                         # pipeline.AudioDecoder | V1Decoder
    codec: Optional[Any] = None          # codec.SpeechCodec
    speaker_encoder: Optional[Any] = None
    spk2info: Dict[str, Dict[str, np.ndarray]] = dataclasses.field(
        default_factory=dict)
    report: Dict[str, int] = dataclasses.field(default_factory=dict)

    def prompt(self, speaker: str):
        """An spk2info entry -> ``codec.Prompt`` (the cli frontend's cached
        speaker, cosyvoice/cli/frontend.py:120-141).  Zero-shot entries
        carry token, feat and embedding; sft entries only an embedding, the
        missing pieces default to empty."""
        from .codec import Prompt
        info = self.spk2info[speaker]
        emb = None
        for k in ("flow_embedding", "embedding"):
            if k in info:
                emb = np.asarray(info[k], np.float32).reshape(1, -1)
                break
        if emb is None:
            emb = np.zeros((1, self.flow_cfg.spk_embed_dim), np.float32)
        token = np.asarray(
            info.get("flow_prompt_speech_token",
                     np.zeros((1, 0))), np.int32).reshape(1, -1)
        feat = info.get("prompt_speech_feat")
        if feat is None:
            feat = np.zeros((1, int(round(token.shape[1]
                                          * self.decoder.ratio)),
                             self.flow_cfg.output_size))
        feat = np.asarray(feat, np.float32)
        if feat.ndim == 2:
            feat = feat[None]
        return Prompt(token=token, feat=feat, embedding=emb)


def _load_spk2info(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return {spk: {k: (v.numpy() if hasattr(v, "numpy") else v)
                  for k, v in info.items()}
            for spk, info in raw.items()}


def _find_tokenizer(path: str, tokenizer: Optional[str]):
    """(config.json or None, weights file or None)."""
    cand = tokenizer or os.path.join(path, "speech_tokenizer")
    if os.path.isfile(cand):
        cfg = os.path.join(os.path.dirname(cand), "config.json")
        return (cfg if os.path.isfile(cfg) else None), cand
    if os.path.isdir(cand):
        cfg = os.path.join(cand, "config.json")
        weights = (glob.glob(os.path.join(cand, "*.safetensors"))
                   or glob.glob(os.path.join(cand, "*.pt")))
        if weights:
            return (cfg if os.path.isfile(cfg) else None), sorted(weights)[0]
    return None, None


def load_model_dir(path: str, tokenizer: Optional[str] = None,
                   pipeline=None, compute_dtype=None, estimator_dtype=None,
                   flow_version: Optional[str] = None,
                   flow_cfg=None, hift_cfg=None, device=None,
                   verbose: bool = True) -> ModelDir:
    """Builds the decoder (and the codec, speaker encoder and speaker cache
    where their files are) from a reference-layout checkpoint directory.
    ``tokenizer`` may point at a WhisperVQ checkpoint file or HF directory
    outside ``path``; ``flow_cfg`` / ``hift_cfg`` override the yaml's or
    the default configs; ``compute_dtype`` / ``estimator_dtype`` as in
    ``AudioDecoder``."""
    from .pipeline import AudioDecoder
    from .utils import checkpoint as ckpt
    from .utils.config import (PipelineConfig, cosyvoice1_flow_config,
                               cosyvoice1_hift_config, moss_flow_config,
                               moss_hift_config)
    from .utils.device import resolve_device

    device = resolve_device(device)
    report: Dict[str, int] = {}

    def p(*names):
        for n in names:
            f = os.path.join(path, n)
            if os.path.exists(f):
                return f
        return None

    # ----------------------------------------------------------- configs
    yaml_path = p("config.yaml")
    if yaml_path:
        from .utils.ref_config import (flow_config_from_reference,
                                       hift_config_from_reference,
                                       load_reference_yaml)
        ref_cfg = load_reference_yaml(yaml_path)
        flow = ref_cfg.get("flow")
        cls = flow.get("__class__", "") if isinstance(flow, dict) else ""
        flow_version = flow_version or ("v2" if "Causal" in cls else "v1")
        flow_cfg = flow_cfg or flow_config_from_reference(ref_cfg)
        hift_cfg = hift_cfg or hift_config_from_reference(ref_cfg)
    else:
        flow_version = flow_version or "v2"
        v1 = flow_version == "v1"
        flow_cfg = flow_cfg or (cosyvoice1_flow_config() if v1
                                else moss_flow_config())
        hift_cfg = hift_cfg or (cosyvoice1_hift_config() if v1
                                else moss_hift_config())
    if flow_version not in ("v1", "v2"):
        raise ValueError(f"flow_version {flow_version!r}: v1 or v2")

    # ----------------------------------------------------------- weights
    flow_pt = p("flow.pt", "flow.cache.pt")
    hift_pt = p("hift.pt")
    if flow_pt is None or hift_pt is None:
        raise FileNotFoundError(
            f"model dir {path!r} needs flow.pt and hift.pt "
            f"(found flow={flow_pt}, hift={hift_pt})")
    convert = (ckpt.convert_flow_v1_state_dict if flow_version == "v1"
               else ckpt.convert_flow_state_dict)
    flow_state, unused = convert(ckpt.load_torch_state_dict(flow_pt),
                                 flow_cfg)
    report["flow_unused"] = len(unused)
    sd = ckpt.strip_prefix(ckpt.load_torch_state_dict(hift_pt), "generator.")
    hift_state, unused = ckpt.convert_hift_state_dict(sd, hift_cfg)
    report["hift_unused"] = len([u for u in unused if u != "stft_window"])
    if flow_version == "v1":
        decoder = V1Decoder(flow_cfg, hift_cfg, flow_state, hift_state,
                            compute_dtype=compute_dtype, device=device)
    else:
        decoder = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                               pipeline or PipelineConfig(
                                   sample_rate=hift_cfg.sampling_rate),
                               compute_dtype=compute_dtype,
                               estimator_dtype=estimator_dtype, device=device)

    # ------------------------------------------------------------ extras
    speaker_encoder = None
    campplus = p("campplus.onnx")
    if campplus:
        from .models.campplus import SpeakerEncoder
        speaker_encoder = SpeakerEncoder.from_onnx(campplus, device=device)

    codec = None
    tok_cfg_path, tok_weights = _find_tokenizer(path, tokenizer)
    if tok_weights:
        from .codec import SpeechCodec
        from .tokenizer.config import glm4_voice_tokenizer_config
        tok_cfg = (tokenizer_config_from_json(tok_cfg_path)
                   if tok_cfg_path else glm4_voice_tokenizer_config())
        sd = ckpt.strip_prefix(ckpt.load_torch_state_dict(tok_weights),
                               "generator.encoder.", "encoder.")
        tok_state, unused = ckpt.convert_tokenizer_state_dict(sd, tok_cfg)
        report["tokenizer_unused"] = len(
            [u for u in unused if u not in
             ("embed_positions2.weight", "ema_count", "ema_weight")])
        codec = SpeechCodec(tok_cfg, tok_state, decoder,
                            speaker_encoder=speaker_encoder, device=device)

    spk2info: Dict[str, Dict[str, np.ndarray]] = {}
    spk_pt = p("spk2info.pt")
    if spk_pt:
        spk2info = _load_spk2info(spk_pt)

    if verbose:
        parts = [f"flow={flow_version}", f"hift@{hift_cfg.sampling_rate}",
                 f"on {device}"]
        if codec is not None:
            parts.append("tokenizer")
        if speaker_encoder is not None:
            parts.append("campplus")
        if spk2info:
            parts.append(f"{len(spk2info)} speakers")
        print(f"# load_model_dir({path}): " + ", ".join(parts)
              + f"  unused={report}")
    return ModelDir(path=path, flow_version=flow_version,
                    flow_cfg=flow_cfg, hift_cfg=hift_cfg, decoder=decoder,
                    codec=codec, speaker_encoder=speaker_encoder,
                    spk2info=spk2info, report=report)
