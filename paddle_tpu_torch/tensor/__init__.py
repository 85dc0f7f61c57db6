"""The ``paddle.tensor`` namespace (port of
``paddle_tpu/tensor/__init__.py``): the flat ops, the domain modules
under their reference names (``paddle.tensor.creation``, ``.math``,
``.search``, ``.stat``, ...), ``fill_constant`` and the TensorArray
helpers."""
from ..ops import *  # noqa: F401,F403
from ..ops import (creation, linalg, logic, manipulation, math,  # noqa
                   random, reduction)

# the reference's submodule aliases
search = logic
attribute = logic
stat = reduction
einsum = math

# the signal ops flat, as the reference's tensor namespace has them
from ..ops.fft_ops import istft, stft  # noqa: E402,F401
from ..ops.manipulation_ext import tensor_unfold as unfold  # noqa: E402,F401


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    """The legacy creation call: ``full`` with the fluid argument order."""
    from ..ops.creation import full
    return full(shape, value, dtype=dtype)


# -- TensorArray: a plain Python list of tensors, as the reference's
# dygraph path keeps one

def create_array(dtype="float32", initialized_list=None):
    if initialized_list is not None:
        return list(initialized_list)
    return []


def array_length(array):
    return len(array)


def array_read(array, i):
    return array[int(i)]


def array_write(x, i, array=None):
    if array is None:
        array = []
    i = int(i)
    if i < len(array):
        array[i] = x
    elif i == len(array):
        array.append(x)
    else:
        raise IndexError(
            f"array_write index {i} beyond array length {len(array)}")
    return array
