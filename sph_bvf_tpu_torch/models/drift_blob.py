"""A dense blob drifting through a periodic-x channel: the load-balance
scene (PyTorch).

The JAX package's own load-balance scenario (``tests/test_sharding.py``
``_drift_blob_scene``): a blob on a 0.02 lattice beside a sparse 0.04
lattice in a 2.4 x 0.6 box, periodic in x, every particle moving +x at 2.0
with negligible forces (c0 = 1e-3, eta = 0), so the run is pure advection
and the binning is pure bookkeeping.  Edges cut for the blob's starting
place go stale as it drifts: the fullest cell fills first, the slab
imbalance follows, and ``Scene.fix_balance`` re-cuts the x columns.

``s`` scales the particle count: every particle-scale length (the lattices,
h, the z thickness, ``min_budget``) is divided by ``s``, the mass by s^2
and dt by ``s``; the box stays 2.4 x 0.6.  s=1 holds 2,115 particles, s=10
210,000, s=20 840,000.

The cells are sized with a margin of 0.49 cutoffs (``margin_frac``; at
0.5 the cell count 2.4 / 1.5 cutoffs rounds to just below an integer), so
the x cells are 1.5 cutoffs wide at every s and the drift per chunk and
the re-cut dynamics are the same counted in cells.  At s=1 this is the
JAX scene's grid bit for bit: its default margin (0.25) gives 38 cells,
which ``ncx_multiple_of=8`` rounds down to 32, 1.5 cutoffs wide.

``scene(..., nz_cells=3)`` extrudes the scene over 3 periodic z cells (x
and z periodic): the 3D blob, whose balanced grid is the one path on which
the 3D rebin move takes ``x_edges`` on a periodic grid.

At s = 5, 10 or 20 the default margin leaves nothing to round (192, 384,
768 cells of 1.25 cutoffs c), and the blob cannot be re-cut.  With
c = 0.05/s, the re-cut quantum is q = cell/8 = 0.15625 c and the narrowest
column must exceed c + 2 * min_budget = 1.1 c = 7.04 q, so k_min = 8 and
every column is at least 1.25 c = 3.125 dense lattice spacings (0.02/s)
wide.  A cell is 4 lattice rows tall, so some blob column always holds 4
lattice columns: 16 particles.  That fires the occupancy trigger
(16 >= 0.8 * cap 18), and no edge set can bring max_occ to 16 / min_gain
= 13.3 or below.  ``rebalance`` then returns "no improving edge set under
the width constraint", the build-time columns go stale, and the blob's
front loses particles before step 200.  The JAX package's ``rebalance``
gives the same refusal on its own s=20 build
(``tests/test_torch_balance.py``,
``test_drift_blob_recuts_under_advection_match_jax``).  At 1.5 c, k_min
is 6 (2.81 lattice spacings), and a column of 3 lattice columns (12
particles) is admissible.
"""

from __future__ import annotations

from sph_bvf_tpu_torch.api.scene import Region, Scene

# the JAX package's balance settings for this scene: the build-time cut
# and the in-run re-cut (min_budget at s=1)
BALANCE = dict(n_shards=8, threshold=1.2)
FIX = dict(every=50, threshold=1.5, min_budget=2.5e-3, occ_frac=0.8)


# The 3D blob's cell capacity: the uniform grid's, Scene's rule ceil(1.3 x
# 64) + 2 for a cell of 4 x 4 x 4 dense sites, at every s.  The balanced
# build would take ceil(1.3 x 48) + 2 = 65 from its own fullest cell (3
# dense lattice columns), and a dense lattice column (16 particles) that
# drifts into a wide sparse column overflows a cell between two balance
# checks: from step 65 at s=8, with 840 particles lost, while ``rebalance``
# refuses the one re-cut it is offered before (at step 50 the fullest cell
# holds 56 and the best edges 48, short of min_gain 1.2: "no improving
# edge set under the width constraint"), in either package (replayed under
# pure advection).  At cap 86 the s=8 blob re-cuts 7-9 times in 1,000 steps
# and keeps every particle.  At s=1 the build's own rule gives 86 already.
CAP3D = 86


def timestep(s: float = 1) -> float:
    """The scene's dt at scale ``s``: the one to pass to ``setup``."""
    return 2e-4 / s


def scene(s: float = 1, balance: bool = False, inrun: bool = False,
          nz_cells: int | None = None, Scene=Scene, Region=Region):
    """The scene at scale ``s`` as an unbuilt scene of the given package's
    classes (the port's by default); ``balance`` adds ``Scene.balance``,
    ``inrun`` ``Scene.fix_balance`` with the settings above.

    With ``nz_cells`` None, the 2D scene.  Otherwise the 3D blob: the
    same box and regions extruded along a periodic z axis of ``nz_cells``
    cells of 1.5 cutoffs (``Scene(dim=3, boundary=("p", "f", "p"))``, z in
    [0, nz_cells * 0.075 / s]), simple-cubic lattices (origin at half a
    spacing) at 0.02/s and 0.04/s, the mass 8e-6 / s^3 (the dense
    lattice's spacing^3 at rho 1) and the cap fixed at ``CAP3D``.  Build
    it with ``.build(device=...)`` (the port) or ``.build()`` (the JAX
    package)."""
    if nz_cells is None:
        dim, lat, origin, lz, mass = 2, "sq", {}, 0.02 / s, 4e-4 / s ** 2
    else:
        dim, lat, origin = 3, "sc", {"origin": (0.5, 0.5, 0.5)}
        lz, mass = nz_cells * 0.075 / s, 8e-6 / s ** 3
    sc = Scene(dim=dim, boundary=("p", "f", "p"))
    if nz_cells is not None:
        sc.cap = CAP3D
    sc.ncx_multiple_of = 8
    sc.margin_frac = 0.49
    sc.create_box(1, Region.block(0, 2.4, 0, 0.6, 0, lz))
    sc.lattice(lat, 0.02 / s, **origin)
    sc.create_atoms(1, Region.block(0, 1.08, 0, 1, -1, 1))
    sc.lattice(lat, 0.04 / s, **origin)
    sc.create_atoms(1, Region.block(1.1, 2.38, 0, 1, -1, 1))
    sc.mass(1, mass)
    sc.set("all", rho=1.0, e=0.0)
    sc.velocity("all", 2.0)
    sc.pair_style("transport_velocity")
    sc.pair_coeff(1, 1, 1.0, 1e-3, 0.0, 0.05 / s, 0.05 / s, 0.0)
    sc.integrator("transport_velocity")
    sc.rebin_every = 5
    sc.timestep(timestep(s))
    if balance:
        sc.balance(BALANCE["n_shards"], threshold=BALANCE["threshold"])
    if inrun:
        sc.fix_balance(BALANCE["n_shards"],
                       **dict(FIX, min_budget=FIX["min_budget"] / s))
    return sc


def build(s: float = 1, balance: bool = False, inrun: bool = False,
          device=None, nz_cells: int | None = None):
    """Returns (state, params, spec, scene), the state and params on
    ``device`` (default: the card); set it up with ``timestep(s)``.
    ``nz_cells``: the 3D blob (``scene``)."""
    sc = scene(s, balance, inrun, nz_cells)
    state, params, spec = sc.build(device=device)
    return state, params, spec, sc
