"""Composite-op registration (port of ``paddle_tpu/ops/composite.py``).

The functions of the op surface that are compositions (creation, random
draws, list-taking wrappers) and the in-place ``<name>_`` family join
the registry under their names, so ``registered_ops()`` lists the whole
surface as the reference's does. They are registered as they are: a call
counts in ``op.<name>.calls`` only through the registered ops it makes.
The names are the ones whose reference module this package holds; the
reference's other composites (its ``*_ext`` modules) come with those.
"""
from __future__ import annotations

from ._op import _OP_REGISTRY

_COMPOSITE_NAMES = [
    # creation
    "arange", "empty", "empty_like", "eye", "full", "assign",
    "create_tensor", "meshgrid", "tril_indices", "triu_indices",
    "logspace", "complex",
    # random
    "bernoulli", "gumbel",
    # manipulation, logic and linalg compositions
    "chunk", "masked_select", "allclose", "equal_all", "bmm", "multi_dot",
]


def register_composites(namespace):
    """Register every present composite and every public in-place
    function (``<name>_``) of ``namespace`` (a module's ``vars``);
    idempotent, and names an ``op_fn`` already claimed stay its."""
    added = 0
    inplace = [n for n in namespace if n.endswith("_")
               and not n.startswith("_")]
    for name in _COMPOSITE_NAMES + inplace:
        fn = namespace.get(name)
        if name in _OP_REGISTRY or fn is None or not callable(fn) \
                or isinstance(fn, type):
            continue
        if not hasattr(fn, "op_name"):
            fn.op_name = name
        _OP_REGISTRY[name] = fn
        added += 1
    return added
