"""Serving: the continuous-batching decode server (``audio_batcher``), the
websocket voice server and its web page (``ws_server``, ``web_demo``), the
wire protocol and codecs (``protocol``, ``opus``, ``ogg``), the boot
warm-up (``boot``), the multi-stream manager and the silence chunker; the
speech LM's continuous batcher (``lm_server``) and its SSE token servers
and chat audio consumer (``token_server``)."""
