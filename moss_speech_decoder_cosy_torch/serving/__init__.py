"""Continuous-batching audio serving over the KV batcher."""
