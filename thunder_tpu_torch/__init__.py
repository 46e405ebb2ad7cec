"""thunder_tpu_torch — the PyTorch / CUDA port of thunder_tpu.

The JAX package ``thunder_tpu`` stays the reference; this package mirrors
its layout (``ops/``, ``physics/``, ``geometry/``, ``pipeline/``,
``recon/``, ``particle.py``, ``model.py``, ``optimiser.py``,
``cli/thunder.py``) and keeps its array layouts at every public
function: real space in FFT layout, Fourier space centered full-space,
and a leading hemisphere axis of size 2 on stacked state.

Hand-written Hopper kernels (``csrc/``) carry the 3D-refinement round
(slice projection, the likelihood with its products fused in, trilinear
insertion, Fourier-shell sums) and 2D classification (bilinear plane
projection and insertion into class planes); five gather kernels port
the repo's Pallas gather microbenchmarks (``micro/gather.py``).  Each
sits beside a plain PyTorch version that runs for CPU tensors; see
``thunder_tpu_torch/_native.py`` for how they are built.

The package stands alone: it imports neither jax nor ``thunder_tpu``
and keeps its own config, constants, MRC / .thu readers and round
metrics.  Its entry points run on the card unless the caller asks for
the CPU (``device="cpu"``, ``--device cpu``).
"""

__version__ = "0.1.0"
