"""Checks the port against real reference checkpoints in one command (the
JAX package's ``bin/validate_reference.py``):

    python -m moss_speech_decoder_cosy_torch.bin.validate_reference \
        --flow flow.pt --hift hift.pt [--config config.yaml] \
        [--flow-version v1] [--tokenizer model.safetensors] \
        [--campplus campplus.onnx] [--reference-path /path/to/GLM_modules] \
        [--seconds 5] [--device cpu]

Steps: convert every checkpoint given through the port's converters
(reporting the reference keys left unused), decode seeded tokens end to end
through the port's ``token2wav`` (``AudioDecoder``, or
``model_dir.V1Decoder`` for ``--flow-version v1``) and time it (RTF after
one warm-up), and, when the reference's torch package imports from
``--reference-path`` (v2 only), run its pipeline on the same inputs with
the noise matched (the reference CFM's ``rand_noise`` buffer fed to the
port's solver, the NSF noise zeroed on both sides) and report the waveform
MAE.  Prints one JSON line.  Runs on the CUDA card unless ``--device
cpu``; the reference side runs on the CPU.

Reference roles: flow_inference.py:53-104 (loading and decoding),
cal_RTF.py:349-421 (the RTF protocol).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

_TOKENIZER_EXTRA = ("embed_positions2.weight", "ema_count", "ema_weight")


def _convert_all(args, flow_cfg, hift_cfg):
    """(flow state, hift state, report of unused reference keys)."""
    from ..utils import checkpoint as ckpt
    report = {}
    flow_state = hift_state = None
    if args.flow:
        sd = ckpt.load_torch_state_dict(args.flow)
        convert = (ckpt.convert_flow_v1_state_dict if args.flow_version == "v1"
                   else ckpt.convert_flow_state_dict)
        flow_state, unused = convert(sd, flow_cfg)
        report["flow_unused"] = len(unused)
    if args.hift:
        sd = ckpt.strip_prefix(ckpt.load_torch_state_dict(args.hift),
                               "generator.")
        hift_state, unused = ckpt.convert_hift_state_dict(sd, hift_cfg)
        report["hift_unused"] = len([u for u in unused
                                     if u != "stft_window"])
    if args.tokenizer:
        from ..tokenizer import (glm4_voice_tokenizer_config,
                                 tiny_tokenizer_config)
        sd = ckpt.strip_prefix(ckpt.load_torch_state_dict(args.tokenizer),
                               "generator.encoder.", "encoder.")
        tcfg = tiny_tokenizer_config() if args.tiny \
            else glm4_voice_tokenizer_config()
        _, unused = ckpt.convert_tokenizer_state_dict(sd, tcfg)
        report["tokenizer_unused"] = len(
            [u for u in unused if u not in _TOKENIZER_EXTRA])
    if args.campplus:
        from ..utils.onnx_io import load_onnx_initializers
        _, unused = ckpt.convert_campplus_state_dict(
            load_onnx_initializers(args.campplus))
        report["campplus_unused"] = len(unused)
    return flow_state, hift_state, report


def _decoder(flow_cfg, hift_cfg, flow_state, hift_state, v1: bool, device):
    """The port's decoder over the converted states."""
    if v1:
        from ..model_dir import V1Decoder
        return V1Decoder(flow_cfg, hift_cfg, flow_state, hift_state,
                         device=device)
    from ..pipeline import AudioDecoder
    from ..utils.config import PipelineConfig
    return AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                        PipelineConfig(), device=device)


def _decode(dec, tokens, prompt_feat, emb) -> np.ndarray:
    """tokens -> wav through ``token2wav``, the card synchronized."""
    wav = dec.token2wav(tokens, prompt_feat=prompt_feat, embedding=emb)
    if dec.device.type == "cuda":
        torch.cuda.synchronize(dec.device)
    return np.asarray(wav)


def main(argv=None, flow_cfg=None, hift_cfg=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flow")
    ap.add_argument("--hift")
    ap.add_argument("--tokenizer")
    ap.add_argument("--campplus")
    ap.add_argument("--config", help="the reference's config.yaml")
    ap.add_argument("--flow-version", choices=("v1", "v2"), default="v2")
    ap.add_argument("--reference-path",
                    help="GLM_modules directory, for the torch comparison")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny test configs instead of the full ones")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    v1 = args.flow_version == "v1"
    if flow_cfg is None or hift_cfg is None:
        from ..utils import config as C
        if args.config:
            from ..utils.ref_config import configs_from_reference_yaml
            flow_cfg, hift_cfg = configs_from_reference_yaml(args.config)
        elif args.tiny:
            flow_cfg, hift_cfg = C.tiny_flow_config(), C.tiny_hift_config()
        elif v1:
            flow_cfg, hift_cfg = (C.cosyvoice1_flow_config(),
                                  C.cosyvoice1_hift_config())
        else:
            flow_cfg, hift_cfg = C.moss_flow_config(), C.moss_hift_config()

    flow_state, hift_state, report = _convert_all(args, flow_cfg, hift_cfg)
    result = {"metric": "reference_validation", **report}
    if flow_state is not None and hift_state is not None:
        rng = np.random.RandomState(0)
        n_tok = max(4, int(args.seconds * flow_cfg.input_frame_rate))
        tokens = rng.randint(0, flow_cfg.vocab_size, (1, n_tok))
        prompt_feat = np.zeros((1, 0, flow_cfg.output_size), np.float32)
        emb = rng.randn(1, flow_cfg.spk_embed_dim).astype(np.float32)
        dec = _decoder(flow_cfg, hift_cfg, flow_state, hift_state, v1,
                       args.device)
        _decode(dec, tokens, prompt_feat, emb)              # warm-up
        t0 = time.perf_counter()
        wav = _decode(dec, tokens, prompt_feat, emb)
        dt = time.perf_counter() - t0
        result["rtf"] = round(dt / (wav.shape[-1] / hift_cfg.sampling_rate),
                              5)
        result["finite"] = bool(np.all(np.isfinite(wav)))
        result["device"] = str(dec.device)
        if args.reference_path and not v1:
            try:
                mae = _torch_compare(args, flow_cfg, hift_cfg, flow_state,
                                     hift_state, tokens, prompt_feat, emb)
                result["waveform_mae"] = round(mae, 8)
            except Exception as e:           # report, do not crash
                result["torch_compare_error"] = f"{type(e).__name__}: {e}"
    print(json.dumps(result))
    return result


def _build_torch_pair(args, flow_cfg, hift_cfg, load: bool = True):
    """The reference's torch modules at the port's config shapes (the
    tests/test_golden_parity.py pattern), the checkpoints loaded."""
    from omegaconf import DictConfig
    from cosyvoice.flow.flow import CausalMaskedDiffWithXvec as TorchFlow
    from cosyvoice.transformer.upsample_encoder import (
        UpsampleConformerEncoder as TorchEncoder)
    from cosyvoice.flow.decoder import (
        CausalConditionalDecoder as TorchEstimator)
    from cosyvoice.flow.flow_matching import (
        CausalConditionalCFM as TorchCFM)
    from cosyvoice.hifigan.generator import HiFTGenerator as TorchHiFT
    from cosyvoice.hifigan.f0_predictor import ConvRNNF0Predictor as TorchF0

    e, s = flow_cfg.encoder, flow_cfg.estimator
    t_enc = TorchEncoder(
        input_size=flow_cfg.input_size, output_size=e.output_size,
        attention_heads=e.attention_heads, linear_units=e.linear_units,
        num_blocks=e.num_blocks, dropout_rate=0.0,
        positional_dropout_rate=0.0, attention_dropout_rate=0.0,
        input_layer="linear", macaron_style=e.macaron_style,
        use_cnn_module=e.use_cnn_module,
        cnn_module_kernel=e.cnn_module_kernel,
        static_chunk_size=e.static_chunk_size,
        upsample_stride=e.upsample_stride)
    t_est = TorchEstimator(
        in_channels=s.in_channels, out_channels=s.out_channels,
        channels=list(s.channels), dropout=0.0,
        attention_head_dim=s.attention_head_dim, n_blocks=s.n_blocks,
        num_mid_blocks=s.num_mid_blocks, num_heads=s.num_heads,
        act_fn=s.act_fn, static_chunk_size=s.static_chunk_size)
    cfm_params = DictConfig({
        "sigma_min": 1e-6, "solver": "euler", "t_scheduler": "cosine",
        "training_cfg_rate": 0.2,
        "inference_cfg_rate": flow_cfg.cfm.inference_cfg_rate,
        "reg_loss_type": "l1"})
    t_cfm = TorchCFM(in_channels=s.in_channels - flow_cfg.output_size,
                     cfm_params=cfm_params, n_spks=1,
                     spk_emb_dim=flow_cfg.output_size, estimator=t_est)
    ref_flow = TorchFlow(
        input_size=flow_cfg.input_size, output_size=flow_cfg.output_size,
        spk_embed_dim=flow_cfg.spk_embed_dim,
        vocab_size=flow_cfg.vocab_size,
        input_frame_rate=int(flow_cfg.input_frame_rate),
        token_mel_ratio=flow_cfg.token_mel_ratio,
        pre_lookahead_len=flow_cfg.encoder.pre_lookahead_len,
        encoder=t_enc, decoder=t_cfm).eval()
    h = hift_cfg
    ref_hift = TorchHiFT(
        in_channels=h.in_channels, base_channels=h.base_channels,
        nb_harmonics=h.nb_harmonics, sampling_rate=h.sampling_rate,
        nsf_alpha=h.nsf_alpha, nsf_sigma=h.nsf_sigma,
        nsf_voiced_threshold=h.nsf_voiced_threshold,
        upsample_rates=list(h.upsample_rates),
        upsample_kernel_sizes=list(h.upsample_kernel_sizes),
        istft_params={"n_fft": h.istft_n_fft, "hop_len": h.istft_hop_len},
        resblock_kernel_sizes=list(h.resblock_kernel_sizes),
        resblock_dilation_sizes=[list(d) for d in
                                 h.resblock_dilation_sizes],
        source_resblock_kernel_sizes=list(h.source_resblock_kernel_sizes),
        source_resblock_dilation_sizes=[
            list(d) for d in h.source_resblock_dilation_sizes],
        lrelu_slope=h.lrelu_slope, audio_limit=h.audio_limit,
        f0_predictor=TorchF0(num_class=1, in_channels=h.in_channels,
                             cond_channels=h.f0_cond_channels)).eval()
    if load:
        ref_flow.load_state_dict(
            torch.load(args.flow, map_location="cpu", weights_only=True),
            strict=False)
        hift_sd = torch.load(args.hift, map_location="cpu",
                             weights_only=True)
        ref_hift.load_state_dict({k.replace("generator.", ""): v
                                  for k, v in hift_sd.items()}, strict=False)
    return ref_flow, ref_hift


def _torch_compare(args, flow_cfg, hift_cfg, flow_state, hift_state,
                   tokens, prompt_feat, emb) -> float:
    """The reference's torch pipeline against the port's on the same
    inputs, the noise matched: the reference CFM's ``rand_noise`` buffer
    in the port's solver, the NSF noise zeroed on both sides.  Returns the
    waveform MAE (v2 stack)."""
    if args.reference_path not in sys.path:
        sys.path.insert(0, args.reference_path)
    from ..models.flow import cfm as cfm_mod

    ref_flow, ref_hift = _build_torch_pair(args, flow_cfg, hift_cfg)
    n_tok = tokens.shape[1]
    patches = [(torch, "rand", torch.rand),
               (torch, "randn_like", torch.randn_like),
               (cfm_mod, "_fixed_noise", cfm_mod._fixed_noise)]
    try:
        torch.rand = lambda *a, **k: torch.zeros(
            *a, **{kk: vv for kk, vv in k.items() if kk != "device"})
        torch.randn_like = lambda x, **k: torch.zeros_like(x)
        noise = ref_flow.decoder.rand_noise.numpy().transpose(0, 2, 1)
        cfm_mod._fixed_noise = lambda max_len, dim: noise[:, :max_len, :dim]
        with torch.no_grad():
            mel_t, _ = ref_flow.inference(
                token=torch.from_numpy(np.asarray(tokens, np.int64)),
                token_len=torch.tensor([n_tok], dtype=torch.int32),
                prompt_token=torch.zeros(1, 0, dtype=torch.int64),
                prompt_token_len=torch.tensor([0], dtype=torch.int32),
                prompt_feat=torch.from_numpy(prompt_feat),
                prompt_feat_len=torch.tensor([0], dtype=torch.int32),
                embedding=torch.from_numpy(emb),
                streaming=False, finalize=True)
            want = ref_hift.inference(mel_t)[0].numpy()
        dec = _decoder(flow_cfg, hift_cfg, flow_state, hift_state, False,
                       args.device)
        dec.hift.draws = lambda h, n, dev: (
            torch.zeros(1, h, device=dev), torch.zeros(1, n, h, device=dev))
        got = _decode(dec, tokens, prompt_feat, emb)
    finally:
        for mod, name, orig in patches:
            setattr(mod, name, orig)
    if want.shape != got.shape:
        raise ValueError(f"reference wav {want.shape}, port {got.shape}")
    return float(np.mean(np.abs(want - got)))


if __name__ == "__main__":
    main()
