"""Browser voice demo, the reference web_demo.py / gradio VC demos rebuilt
on aiohttp (the port's copy of the JAX package's ``serving/web_demo.py``).

Serves one page that records or uploads audio, streams it to the
``/api/chat`` websocket (serving/ws_server.py protocol) and plays the
returned 24 kHz audio; ``POST /api/compare`` runs the offline-vs-streaming
A/B.  ``make_vc_handler(codec, prompt)`` is the voice-conversion frame
handler (the codec's streaming tokenizer feeding the decoder's streaming
session); without one the page echoes.  aiohttp is imported only where the
demo is built.
"""

from __future__ import annotations

import asyncio
import base64
import inspect
import io
import json
import time

import numpy as np

from ..codec import calculate_rms
from ..eval.audio_io import read_wav, resample
from .protocol import FRAME_SAMPLES, SAMPLE_RATE
from .ws_server import AudioWsServer, aiohttp_module

_PAGE = """<!DOCTYPE html>
<html><head><title>moss-speech-decoder-cosy demo</title>
<style>body{font-family:sans-serif;max-width:640px;margin:2em auto}
button{padding:.6em 1.2em;margin-right:1em}</style></head>
<body>
<h2>moss-speech-decoder-cosy: streaming voice demo</h2>
<p>Upload a wav (16-bit PCM); it streams over the websocket in 80 ms frames
and the processed audio plays back as chunks arrive.</p>
<input type="file" id="file" accept=".wav"/>
<button id="send">Stream</button>
<button id="mic">Mic</button>
<span id="status"></span>
<h3>Streaming vs offline A/B</h3>
<p>Runs the SAME input through the offline decode and the streaming
session (the reference's side-by-side comparison demo,
gradio_voice_converter_unstreaming_streaming.py:469-524).</p>
<button id="ab">Compare</button>
<label><input type="checkbox" id="prep"/> prep prompt (loudest segment +
RMS match)</label>
<div id="abres"></div>
<script>
const SR = %(sr)d, FRAME = %(frame)d;
function pcm16(f32){const o=new Int16Array(f32.length);
  for(let i=0;i<f32.length;i++){o[i]=Math.max(-1,Math.min(1,f32[i]))*32767}
  return o}
document.getElementById('send').onclick = async () => {
  const f = document.getElementById('file').files[0];
  if(!f){alert('pick a wav');return}
  const buf = await f.arrayBuffer();
  const ctx = new AudioContext({sampleRate: SR});
  const audio = await ctx.decodeAudioData(buf);
  const x = audio.getChannelData(0);
  const ws = new WebSocket(`ws://${location.host}/api/chat`);
  ws.binaryType = 'arraybuffer';
  let t = ctx.currentTime;
  ws.onmessage = (ev) => {
    const d = new Uint8Array(ev.data);
    if(d[0] === 0){ // handshake -> start sending
      for(let i=0;i<x.length;i+=FRAME){
        const seg = pcm16(x.subarray(i, i+FRAME));
        const msg = new Uint8Array(1+seg.byteLength);
        msg[0]=1; msg.set(new Uint8Array(seg.buffer),1);
        ws.send(msg);
      }
      document.getElementById('status').textContent='streaming...';
    } else if(d[0] === 1){ // audio chunk
      const i16 = new Int16Array(ev.data.slice(1));
      const f32 = Float32Array.from(i16, v=>v/32768);
      const b = ctx.createBuffer(1, f32.length, SR);
      b.copyToChannel(f32, 0);
      const src = ctx.createBufferSource();
      src.buffer = b; src.connect(ctx.destination);
      t = Math.max(t, ctx.currentTime);
      src.start(t); t += f32.length/SR;
    } else if(d[0] === 2){
      document.getElementById('status').textContent =
        new TextDecoder().decode(d.subarray(1));
    }
  };
};
// microphone capture -> 80 ms pcm16 frames over the same websocket (the
// reference's WebRTC mic client role, client.py:12-121, browser-native)
let micStop = null;
document.getElementById('mic').onclick = async () => {
  if (micStop) { micStop(); micStop = null;
    document.getElementById('mic').textContent = 'Mic'; return; }
  const media = await navigator.mediaDevices.getUserMedia({audio: true});
  const ctx = new AudioContext({sampleRate: SR});
  const srcNode = ctx.createMediaStreamSource(media);
  const proc = ctx.createScriptProcessor(4096, 1, 1);
  const ws = new WebSocket(`ws://${location.host}/api/chat`);
  ws.binaryType = 'arraybuffer';
  let buf = new Float32Array(0), playT = ctx.currentTime, ready = false;
  ws.onmessage = (ev) => {
    const d = new Uint8Array(ev.data);
    if (d[0] === 0) { ready = true;
      document.getElementById('status').textContent = 'mic live'; }
    else if (d[0] === 1) {
      const i16 = new Int16Array(ev.data.slice(1));
      const f32 = Float32Array.from(i16, v => v / 32768);
      const b = ctx.createBuffer(1, f32.length, SR);
      b.copyToChannel(f32, 0);
      const node = ctx.createBufferSource();
      node.buffer = b; node.connect(ctx.destination);
      playT = Math.max(playT, ctx.currentTime);
      node.start(playT); playT += f32.length / SR;
    }
  };
  proc.onaudioprocess = (e) => {
    if (!ready) return;
    const x = e.inputBuffer.getChannelData(0);
    const merged = new Float32Array(buf.length + x.length);
    merged.set(buf); merged.set(x, buf.length); buf = merged;
    while (buf.length >= FRAME) {
      const seg = pcm16(buf.subarray(0, FRAME));
      const msg = new Uint8Array(1 + seg.byteLength);
      msg[0] = 1; msg.set(new Uint8Array(seg.buffer), 1);
      ws.send(msg);
      buf = buf.slice(FRAME);
    }
  };
  srcNode.connect(proc); proc.connect(ctx.destination);
  document.getElementById('mic').textContent = 'Stop';
  micStop = () => { proc.disconnect(); srcNode.disconnect();
    media.getTracks().forEach(t => t.stop()); ws.close(); };
};
// streaming-vs-offline A/B: POST the wav, play both results side by side
document.getElementById('ab').onclick = async () => {
  const f = document.getElementById('file').files[0];
  if (!f) { alert('pick a wav'); return; }
  document.getElementById('abres').textContent = 'running...';
  const prep = document.getElementById('prep').checked ? 1 : 0;
  const r = await fetch(`/api/compare?prep=${prep}`, {method: 'POST',
    body: await f.arrayBuffer()});
  const j = await r.json();
  const el = document.getElementById('abres');
  el.innerHTML = '';
  for (const k of ['offline', 'streaming']) {
    const d = document.createElement('div');
    d.innerHTML = `<b>${k}</b> (proc ${j[k].seconds.toFixed(3)} s,
      RTF ${j[k].rtf.toFixed(4)}) <audio controls
      src="data:audio/wav;base64,${j[k].wav}"></audio>`;
    el.appendChild(d);
  }
};
</script></body></html>
"""


def make_vc_handler(codec, prompt):
    """Voice-conversion frame handler: each 24 kHz frame is resampled to
    16 kHz and tokenized incrementally (``codec.new_encode_session``), and
    the tokens decode in the prompt speaker's voice through the decoder's
    streaming session (``codec.decoder.new_session``).  Returns the
    samples ready so far (possibly none)."""
    enc_session = codec.new_encode_session()
    dec_session = codec.decoder.new_session(
        prompt.token, prompt.feat, prompt.embedding)

    def handler(frame: np.ndarray) -> np.ndarray:
        wav16 = resample(frame, SAMPLE_RATE, 16000)
        out = []
        for tok in enc_session.push(wav16):
            for wav in dec_session.push(tok.reshape(-1)):
                out.append(wav[0])
        if out:
            return np.concatenate(out)
        return np.zeros(0, np.float32)

    return handler


def make_compare_handler(codec, prompt, prompt_wavs=None,
                         reference_ratio=0.8):
    """Offline-vs-streaming A/B over the same input (the reference's
    side-by-side VC demo, gradio_voice_converter_unstreaming_streaming.py:
    469-524): returns {'offline': {...}, 'streaming': {...}} with wall
    seconds, RTF, and the wavs.

    ``prompt_wavs``: optional raw ``(wav_24k, wav_16k)`` prompt audio.
    When given, ``handler(wav, prep=True)`` re-prepares the prompt per
    request the way the reference demo does
    (gradio_voice_converter_unstreaming.py:385-408): loudest contiguous
    ``reference_ratio * min(dur, 10 s)`` segment, RMS-normalized to the
    INPUT's loudness.  ``prep=False`` uses the prebuilt ``prompt``; the
    page's checkbox A/Bs the two."""
    def handler(wav_24k: np.ndarray, prep: bool = False) -> dict:
        p = prompt
        if prep and prompt_wavs is not None:
            w24, w16 = prompt_wavs
            dur = np.asarray(w16).reshape(-1).shape[0] / 16000.0
            p = codec.prepare_prompt(
                w24, w16,
                pick_loudest_seconds=reference_ratio * min(dur, 10.0),
                target_rms=calculate_rms(wav_24k))
        wav16 = resample(wav_24k, SAMPLE_RATE, 16000)
        out = {}
        for mode, streaming in (("offline", False), ("streaming", True)):
            t0 = time.perf_counter()
            wav = codec.convert_voice(wav16, p, streaming=streaming)
            dt = time.perf_counter() - t0
            dur = wav.shape[-1] / SAMPLE_RATE
            out[mode] = {"wav": np.asarray(wav, np.float32).reshape(-1),
                         "seconds": dt,
                         "rtf": dt / max(dur, 1e-9)}
        return out

    return handler


def _wav_b64(x: np.ndarray, sr: int) -> str:
    from scipy.io import wavfile
    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))
    return base64.b64encode(buf.getvalue()).decode()


class WebDemo:
    """The page at ``/``, the ``/api/chat`` websocket and, with a
    ``compare_handler``, ``POST /api/compare``."""

    def __init__(self, handler=None, compare_handler=None,
                 host="0.0.0.0", port=8888):
        web = aiohttp_module("WebDemo").web
        self.ws = AudioWsServer(handler=handler, host=host, port=port,
                                log=False)
        self.compare_handler = compare_handler
        routes = [web.get("/", self.index)]
        if compare_handler is not None:
            routes.append(web.post("/api/compare", self.compare))
        self.ws.app.add_routes(routes)
        self.host, self.port = host, port

    async def compare(self, request):
        web = aiohttp_module("WebDemo").web
        wav, sr = read_wav(io.BytesIO(await request.read()))
        if sr != SAMPLE_RATE:
            wav = resample(wav, sr, SAMPLE_RATE)
        # the card's work runs off the event loop, as the websocket frames
        # do: a long A/B decode must not stall live streams
        loop = asyncio.get_running_loop()
        call = self.compare_handler
        if "prep" in inspect.signature(call).parameters:
            prep = request.query.get("prep") == "1"
            res = await loop.run_in_executor(None, lambda: call(wav, prep))
        else:
            res = await loop.run_in_executor(None, call, wav)
        payload = {k: {"wav": _wav_b64(v["wav"], SAMPLE_RATE),
                       "seconds": v["seconds"], "rtf": v["rtf"]}
                   for k, v in res.items()}
        return web.Response(text=json.dumps(payload),
                            content_type="application/json")

    async def index(self, request):
        web = aiohttp_module("WebDemo").web
        page = _PAGE % {"sr": SAMPLE_RATE, "frame": FRAME_SAMPLES}
        return web.Response(text=page, content_type="text/html")

    def run(self):                                      # pragma: no cover
        aiohttp_module("WebDemo").web.run_app(self.ws.app, host=self.host,
                                              port=self.port)
