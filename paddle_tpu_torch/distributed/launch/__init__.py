"""``python -m paddle_tpu_torch.distributed.launch`` (port of
``paddle_tpu/distributed/launch/``)."""
from .main import launch, main  # noqa: F401
