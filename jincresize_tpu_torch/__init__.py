"""jincresize_tpu_torch: the Jinc (EWA Lanczos) resampler on PyTorch and CUDA.

A port of ``jincresize_tpu``'s device layer to PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a). The NumPy host layer (geometry,
filters, operator build, phase planning, golden models, clips, cache) is
shared with the JAX package and imported from it, not copied, so both
packages resample with the same operator objects. Nothing here imports jax.
"""

__version__ = "0.1.0"

from jincresize_tpu.filters import build_lut  # noqa: F401
from jincresize_tpu.operator import build_plane_operator, radius_for_tap  # noqa: F401
