"""The LM substrate's decoders (port of `repro.models`)."""
from .config import ModelConfig, MoEConfig, MLAConfig, SSMConfig  # noqa: F401
from .lm import LM  # noqa: F401
from . import attention, ffn, layers, moe, ssm, transformer, counting  # noqa: F401
