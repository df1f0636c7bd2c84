"""jincresize_tpu_torch: the Jinc (EWA Lanczos) resampler on PyTorch and CUDA.

A port of ``jincresize_tpu`` to PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a). The NumPy host layer (filters, geometry, operator
build with its native C++ builder, phase planning, golden models, clips,
operator cache) is the port's own copy of the JAX package's, with the code
unchanged, so both packages build bit-identical operators. Nothing here
imports jax or the JAX package.
"""

__version__ = "0.1.0"

from .filters import JINC_ZEROS, build_lut  # noqa: F401
from .operator import PlaneOperator, build_plane_operator, radius_for_tap  # noqa: F401
