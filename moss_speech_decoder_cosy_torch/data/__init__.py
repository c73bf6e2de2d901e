"""The training data pipeline of the port: host numpy processors over
parquet, jsonl and indexed-tar shards (the JAX package's ``data/``)."""
from . import processor  # noqa: F401
from .dataset import DataList, Prefetcher, build_pipeline  # noqa: F401
