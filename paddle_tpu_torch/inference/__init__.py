from .engine import (EngineOverloaded, Request, RequestOutput,  # noqa: F401
                     RequestRejected, ServingEngine)
from .paged import PagedKVCache  # noqa: F401

__all__ = ["EngineOverloaded", "ServingEngine", "Request", "RequestOutput",
           "RequestRejected", "PagedKVCache"]
