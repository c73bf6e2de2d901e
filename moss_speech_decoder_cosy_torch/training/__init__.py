"""Training: the flow, the HiFT GAN, the WhisperVQ codebook and the speech
LM (``bin/train.py`` drives them), in one process or data-parallel over a
process group (``parallel/``)."""

from .train_step import (TrainState, create_flow_train_state,  # noqa: F401
                         make_flow_train_step, make_optimizer)
