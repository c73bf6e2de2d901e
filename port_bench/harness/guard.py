"""The import guard: the process that prints a result may not hold JAX or the
JAX package.  Names are compared by their top-level part (before the first
dot) as whole words: the port's name begins with the JAX package's name, so
a prefix test would be wrong."""

from __future__ import annotations

import sys
from typing import Iterable, Set

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "moss_speech_decoder_cosy_tpu"})


def top_level(names: Iterable[str]) -> Set[str]:
    return {n.split(".", 1)[0] for n in names}


def forbidden_loaded(names: Iterable[str] = None) -> Set[str]:
    names = list(sys.modules) if names is None else names
    return top_level(names) & FORBIDDEN
