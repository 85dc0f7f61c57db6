"""The Paddle ``nn`` surface of the eager Llama: ``Layer`` over
``torch.nn.Module``, ``Linear``, ``Embedding``, ``RMSNorm``,
``LayerList``, the loss layers, the functionals and the initializers."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer import (Embedding, Layer, LayerList, Linear,  # noqa: F401
                    RMSNorm)
from .layer.loss import *  # noqa: F401,F403
