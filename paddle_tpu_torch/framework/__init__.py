from . import random  # noqa: F401
from .random import seed  # noqa: F401
