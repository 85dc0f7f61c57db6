"""Composite-op registration (port of ``paddle_tpu/ops/composite.py``).

The functions of the op surface that are compositions (creation, random
draws, list-taking wrappers) and the in-place ``<name>_`` family join
the registry under their names, so ``registered_ops()`` lists the whole
surface as the reference's does. They are registered as they are: a call
counts in ``op.<name>.calls`` only through the registered ops it makes.
The names are the reference's composites, each registered from the
module that defines it (``__module__``), as the reference's are.
"""
from __future__ import annotations

from ._op import _OP_REGISTRY

_COMPOSITE_NAMES = [
    # creation
    "arange", "empty", "empty_like", "eye", "full", "assign",
    "create_tensor", "meshgrid", "tril_indices", "triu_indices",
    "logspace", "complex",
    "diag_embed",
    # random
    "bernoulli", "gumbel", "binomial", "standard_gamma", "randint_like",
    # manipulation, logic and linalg compositions
    "chunk", "masked_select", "allclose", "equal_all", "bmm", "multi_dot",
    "atleast_1d", "atleast_2d", "atleast_3d", "broadcast_tensors",
    "column_stack", "dstack", "hstack", "vstack", "row_stack", "dsplit",
    "hsplit", "vsplit", "expand_as", "as_strided", "diagonal_scatter",
    "crop", "select_scatter", "slice_scatter", "view", "view_as",
    "unflatten",
    # math compositions
    "addmm", "cdist", "corrcoef", "cov", "cummax", "cummin",
    "cumulative_trapezoid", "diff", "dist", "frexp", "histogram",
    "histogramdd", "increment", "lstsq", "lu", "lu_unpack", "nanmedian",
    "nanquantile", "pdist", "polar", "vander", "combinations",
    # indexing / search compositions
    "index_fill", "index_sample", "mode", "top_p_sampling",
    "unique_consecutive",
    # linalg surface
    "eigh", "eigvalsh", "householder_product", "ormqr",
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
