from .audio_decoder import AudioDecoder, StreamSession  # noqa: F401
