from .base import Layer  # noqa: F401
from .common import Embedding, Linear  # noqa: F401
from .container import LayerList  # noqa: F401
from .norm import RMSNorm  # noqa: F401
