"""Evaluation helpers of the port: so far the host WAV IO the serving and
inference entry points read and write (the JAX package's ``eval/`` also
holds the RTF and scoring tools, ROADMAP A14)."""
