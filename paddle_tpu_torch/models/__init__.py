from . import dit, llama, moe  # noqa: F401
