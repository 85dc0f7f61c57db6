from . import lr  # noqa: F401
from .optimizer import (Adam, AdamW, ClipGradByGlobalNorm,  # noqa: F401
                        ClipGradByNorm, ClipGradByValue, L1Decay, L2Decay,
                        Optimizer)
