"""Launch the streaming voice server of the port: the websocket protocol
(``serving/ws_server.py``) and the browser demo page
(``serving/web_demo.py``).

    python -m moss_speech_decoder_cosy_torch.bin.serve --port 8888
        # echo handler
    python -m moss_speech_decoder_cosy_torch.bin.serve --port 8888 \
        --model_dir DIR --prompt_wav speaker.wav          # voice conversion

The page at http://host:8888/ streams uploaded audio over the websocket in
80 ms frames (the reference server.py protocol) and plays the result back.
With ``--prompt_wav`` every frame is tokenized and decoded in the prompt
speaker's voice (``make_vc_handler``) after ``boot_warmup`` has built the
kernels and warmed the path.  Needs aiohttp; runs on the CUDA card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse

from .inference import add_model_args, build_codec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8888)
    p.add_argument("--prompt_wav", default=None)
    add_model_args(p)
    args = p.parse_args(argv)

    from ..serving.web_demo import WebDemo, make_vc_handler

    handler = None
    if args.prompt_wav:
        from ..eval.audio_io import read_wav, resample
        from ..serving.boot import boot_warmup
        codec = build_codec(args)
        wav, sr = read_wav(args.prompt_wav)
        prompt = codec.prepare_prompt(resample(wav, sr, 24000),
                                      resample(wav, sr, 16000))
        boot_warmup(codec=codec, prompt=prompt)
        handler = make_vc_handler(codec, prompt)
        print("voice-conversion handler ready")
    else:
        print("no --prompt_wav: serving the echo handler")
    WebDemo(handler=handler, host=args.host, port=args.port).run()


if __name__ == "__main__":
    main()
