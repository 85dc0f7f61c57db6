"""The Paddle ``nn`` surface of the eager Llama: ``Layer`` over
``torch.nn.Module``, ``Linear``, ``Embedding``, ``RMSNorm``,
``LayerList``, the functionals and the initializers."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer import (Embedding, Layer, LayerList, Linear,  # noqa: F401
                    RMSNorm)
