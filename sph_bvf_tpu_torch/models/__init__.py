"""The paper-example model families the port carries (PyTorch).

Each module exposes ``build(..., device=None) -> (state, params, spec,
scene)``; ``REGISTRY`` has the JAX package's names
(``sph_bvf_tpu/models/__init__.py``).  ``drift_blob`` (the load-balance
scenario) is a module here but, as there, no registry entry.
"""

from sph_bvf_tpu_torch.models import (  # noqa: F401
    cell_polarization,
    fsi,
    lid_cavity,
    lid_cavity3d,
    natural_convection,
)

REGISTRY = {
    "lid_cavity": lid_cavity.build,
    "lid_cavity3d": lid_cavity3d.build,
    "natural_convection": natural_convection.build,
    "fsi": fsi.build,
    "cell_polarization": cell_polarization.build,
}
