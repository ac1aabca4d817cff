"""sph_bvf_tpu_torch — the SPH-BVF framework on PyTorch and CUDA.

A port of ``sph_bvf_tpu`` (JAX/Pallas on TPU) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).  The JAX package stays the
reference: every module here keeps its counterpart's file path, function
names and cell-slot layout (scalars ``[cap, NC]``, vectors ``[3, cap, NC]``,
tensors ``[3, 3, cap, NC]``), so a reader finds each counterpart by path and
the tests hold the two against each other on identical inputs
(``bridge.py`` carries state across as numpy arrays).

This package imports ``torch`` and never ``jax``.  It runs every model of
the JAX package and every path they take: the 2D lid-driven cavity
(``models/lid_cavity.py``, also under the mechanics pair style), the FSI
beam in a periodic channel (``models/fsi.py``), natural convection with
its continuum species (``models/natural_convection.py``), cell
polarization (``models/cell_polarization.py``), the 3D lid-driven and
spanwise-periodic cavities (``models/lid_cavity3d.py``), the 3D FSI beam
and the 2D and 3D Taylor-Green vortices, the load-balanced drifting blob
in 2D and 3D (``models/drift_blob.py``), the SDPD thermal noise, the
stochastic (SSA) species (``core/ssa.py``), all seven integrators with the
weighted-solid pass B, output and restart (``io/``), LAMMPS-style input
scripts (``api/lmp.py``, ``python -m sph_bvf_tpu_torch -in X.lmp``) and
replica ensembles (``parallel/ensemble.py``).  What it lacks, multi-device
meshes (``spec.mesh``), raises ``NotImplementedError``; nothing falls
back to other code.  Entry points build on the card (``cuda``) unless the
caller names another device.

Kernels (``csrc/*.cu``) are compiled by ``_build.py`` with ``nvcc`` at first
use.  Each kernel wrapper launches its kernel on a CUDA tensor and runs the
plain PyTorch version beside it only on a CPU tensor.
"""

__version__ = "0.1.0"

from sph_bvf_tpu_torch.core.state import Geometry, Params, State  # noqa: F401
