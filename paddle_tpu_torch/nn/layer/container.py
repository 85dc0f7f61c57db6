"""``LayerList`` (port of ``paddle_tpu/nn/layer/container.py``):
sublayers named ``"0"``, ``"1"``, ... as in the reference."""
from __future__ import annotations

from .base import Layer

__all__ = ["LayerList"]


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or ()):
            self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self
