from .engine import Request, RequestOutput, ServingEngine  # noqa: F401
from .paged import PagedKVCache  # noqa: F401

__all__ = ["ServingEngine", "Request", "RequestOutput", "PagedKVCache"]
