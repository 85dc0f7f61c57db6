from . import llama, moe  # noqa: F401
