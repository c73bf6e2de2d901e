from .encoder import UpsampleConformerEncoder  # noqa: F401
from .estimator import CausalConditionalDecoder  # noqa: F401
from .cfm import CausalConditionalCFM  # noqa: F401
from .flow import CausalMaskedDiffWithXvec  # noqa: F401
