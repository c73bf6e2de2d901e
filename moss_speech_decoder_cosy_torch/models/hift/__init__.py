from .generator import HiFTGenerator, ConvRNNF0Predictor  # noqa: F401
