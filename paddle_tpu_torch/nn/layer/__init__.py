from .base import Layer  # noqa: F401
from .common import Embedding, Linear  # noqa: F401
from .container import LayerList  # noqa: F401
from .norm import RMSNorm  # noqa: F401
from .loss import (BCELoss, BCEWithLogitsLoss,  # noqa: F401
                   CosineEmbeddingLoss, CrossEntropyLoss, GaussianNLLLoss,
                   HingeEmbeddingLoss, KLDivLoss, L1Loss, MarginRankingLoss,
                   MSELoss, MultiLabelSoftMarginLoss, NLLLoss,
                   PoissonNLLLoss, SmoothL1Loss, SoftMarginLoss,
                   TripletMarginLoss)
