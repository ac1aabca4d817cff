"""The pass-A pair kernels, their wrappers and the route between them.

K1 (``csrc/pass_a_2d.cu``) ports the grouped kernel of
``sph_bvf_tpu/ops/pair_pallas.py``, K4 (which launches K1's library) its
pre-shifted variant, K2 (``csrc/pass_a_2d_rowloop.cu``) its rowloop kernel
and K3 (``csrc/pass_a_3d.cu``) its tiled 3D kernel.  ``pass_a`` makes JAX's
shape choice (``pair_pallas._pass_a_tiled3d`` for every 3D grid,
``pair_pallas._default_rowloop`` in 2D): 3D grids go to K3; 2D grids with a
mixed lattice (``base_occ == 0``) or a crowded cell (``cap > 24``) go to
K2, the rest to K1, or to K4 when ``PairConfig.preshift_window`` is set
(``pair_pallas.py:1596``; the flag changes no other route).  K1 and K4
launch one kernel (``csrc/pass_a_2d.cuh``): each block stages the 3x3
window of a tile of cells (``k4_tile``) in shared memory, each cell only
to its tail (``tail_index``, which ``tail_index_of`` keeps from one rebin
to the next), and walks each neighbour cell to its tail; K4 is K1's
result, bitwise.  K2 and K3 share one
neighbour walk (``csrc/walk.cuh``: a warp's lanes on one cell, over
``walk_index``, which ``walk_index_of`` keeps from one rebin to the next;
the support test apart from the body).  Every pass-A kernel
serves every pair configuration: every pair style (transport-velocity,
mechanics, fsi), XSPH, fixed, free and elastic solids, solid-free scenes
and periodic axes of at least 3 cells (x and y; K3 z too), through the
full pair body K2 and K3 share (``csrc/pass_a_mech.cuh``, one pack and one
launcher, ``_mech_launch``).  K1, K4 and K3 run the leaner
transport-velocity pair of ``csrc/pass_a_tv.cuh`` instead where it serves
(``tv_body``: ``tv_lacks`` empty, and in 2D no periodic axis; in 3D
solid-free scenes too: the flagship, natural convection, the 3D cavities,
the 3D vortex and the 3D blob; ``_two_body_launch``).  All of them also
carry the continuum species (the C rows in, a species table, the flux Q
out) for up to ``MAX_SPECIES`` of them, and the SDPD thermal noise
(``thermal``: the e and tag rows in, the random force summed into f; dt,
step and the PRNG key read in the kernel from the state's device tensors).
On a CUDA tensor each wrapper launches its kernel; the plain PyTorch loop
(``ops/pair._pass_a_plain``) runs only on a CPU tensor.  A CUDA call the
routed kernel cannot serve raises and names what is missing; it never
falls back.

On a mesh's slab (``geom`` a ``core/halo.SlabGeometry``, ``pf`` the
ghosted slab's fields) each wrapper runs its kernel, unchanged, over the
ghosted slab and returns the sums of the slab's own cells; the route and
the body are those of the whole grid.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from sph_bvf_tpu_torch import _build
from sph_bvf_tpu_torch.core.halo import (SlabGeometry, grid_3d,
                                         narrow_wrap_axes, periodic_multicell,
                                         wrap_bits)
from sph_bvf_tpu_torch.core.state import Geometry, Params
from sph_bvf_tpu_torch.ops import pair
from sph_bvf_tpu_torch.ops.kernels import lucy_w_coef, lucy_wfd_coef

# K1's, K4's and K3's transport-velocity packed field rows, in the order
# csrc/pass_a_tv.cuh reads them (R_* there); rhoI is staged only when the
# Shepard-filter accumulators are wanted, the Ns rows of C follow it, then
# THERMAL_ROWS under ``thermal``.
PF_ROWS = ("valid", "ptype", "solid", "x", "v", "vest", "rho", "m", "B",
           "P_rho2", "m_rho", "V2", "ASd")
# their accumulator rows (O_* there).
ACC_ROWS = (("num_den", 1), ("ddv", 3), ("f", 3), ("drho", 1), ("de", 1),
            ("phi", 1), ("nw", 3))
FILTER_ACC_ROWS = (("rhoAux1", 1), ("rhoAux2", 1))
# the most continuum species K1, K2 and K3 are instantiated for (kMaxSpecies
# in csrc/pass_a_tv.cuh); their Q rows follow the filter rows
MAX_SPECIES = 4
# the rows the thermal noise reads, last in every kernel's pack; tag travels
# as its int32 bits (``_pack``), so the kernels hash the plain path's words
THERMAL_ROWS = ("e", "tag")

# the full body's packed field rows (R_* in csrc/pass_a_mech.cuh): these,
# then AS and S (elastic) or ASd, then rhoI (filter), then the Ns rows of C,
# then THERMAL_ROWS (thermal).  G0 is the per-particle row of
# ``pair._per_particle`` (softened by the first species under
# ``g0_chem_coupling``).
MECH_PF_ROWS = ("valid", "ptype", "solid", "x", "v", "vest", "rho", "m", "B",
                "P_rho2", "m_rho", "V2", "c0", "inv_rho", "G0")
# its accumulator rows (O_* there): these, then dS (elastic), then the
# filter rows, then the Ns rows of Q.
MECH_ACC_ROWS = (("num_den", 1), ("ddv", 3), ("f", 3), ("drho", 1),
                 ("de", 1), ("phi", 1), ("nw", 3), ("ddx", 3))
# its runtime switches (F_* there); _F_NOSOLIDS: a solid-free scene
# (no artificial-stress force, no BVF phi/nw); _F_G0PAIR: geff of a pair
# from the G0 rows of i and j (``g0_chem_coupling``), not from the type
# table.  The periodic axes travel as their own bits (``halo.wrap_bits``).
_F_PSWITCH, _F_XSPH, _F_FREE, _F_NOSOLIDS, _F_G0PAIR = 1, 2, 4, 8, 16


def uses_rowloop(geom: Geometry) -> bool:
    """K2 or K1: JAX's shape choice for 2D grids (mixed lattice or cap > 24
    take the rowloop kernel)."""
    return geom.base_occ == 0 or geom.cap > 24


def route(geom: Geometry, cfg: "pair.PairConfig"):
    """The wrapper this grid's pass A goes to: ``pass_a_3d`` (K3) for a 3D
    grid, else ``pass_a_2d_rowloop`` (K2), or ``pass_a_2d`` (K1) and, when
    ``cfg.preshift_window`` is set, ``pass_a_2d_preshift`` (K4) in its
    place."""
    if grid_3d(geom):
        return pass_a_3d
    if uses_rowloop(geom):
        return pass_a_2d_rowloop
    return pass_a_2d_preshift if cfg.preshift_window else pass_a_2d


def kernel_unsupported(geom: Geometry, cfg: "pair.PairConfig",
                       kernel=None, n_sdpd: int = 0) -> list:
    """What keeps the wrapper ``kernel`` (by default the one this grid and
    configuration route to) from serving this geometry, configuration and
    count of continuum species.  Every pass-A kernel serves every pair
    configuration on walls and on periodic axes of at least 3 cells (with
    fewer, a stencil would reach one cell twice), for up to
    ``MAX_SPECIES`` species."""
    kernel = kernel or route(geom, cfg)
    is3d = kernel is pass_a_3d
    checks = [
        ("a 2D grid" if is3d else "a 3D grid", grid_3d(geom) != is3d),
    ]
    checks += [(f"a periodic {a} axis with fewer than 3 cells", True)
               for a in narrow_wrap_axes(geom)]
    checks.append((f"more than {MAX_SPECIES} continuum species (n_sdpd = {n_sdpd})",
                   n_sdpd > MAX_SPECIES))
    return [what for what, bad in checks if bad]


_SOLID_FREE = "a solid-free scene (solids_present=False)"


def tv_lacks(cfg) -> list:
    """The pair physics of ``cfg`` that the transport-velocity pair of
    ``csrc/pass_a_tv.cuh`` (the leaner body of K1, K4 and K3) lacks; the
    full body of ``csrc/pass_a_mech.cuh`` has it all."""
    return [what for what, needed in (
        (_SOLID_FREE, not cfg.solids_present),
        ("XSPH (xsph)", cfg.xsph),
        ("the symmetric pressure force (pressure_switch=False)",
         not cfg.pressure_switch),
        ("elastic solids (elastic_present)", cfg.elastic_present),
        ("free solids (free_solids_present)", cfg.free_solids_present),
        ("density diffusion (ampl_damp)", cfg.ampl_damp != 0.0),
    ) if needed]


def _tables(params: Params, cfg, tabs: dict = None) -> torch.Tensor:
    """[6, T*T] f32: inv_h, eta, inv_wdelta, the two r-independent Lucy
    factors and h per type pair — the coefficients the plain path computes
    (inv_wdelta 0 in a solid-free scene, which never reads it), from
    ``tabs`` (``pair.coeff_tables``, made here unless the caller has it)."""
    tabs = tabs or pair.coeff_tables(params, cfg)
    ih = tabs["inv_h"]
    rows = [ih, tabs["eta"], tabs.get("inv_wdelta", torch.zeros_like(ih)),
            lucy_wfd_coef(ih, cfg.dim), lucy_w_coef(ih, cfg.dim), tabs["h"]]
    return torch.stack([r.reshape(-1) for r in rows]).to(torch.float32).contiguous()


def _species_tables(params: Params, cfg, tabs: dict = None) -> torch.Tensor:
    """[4 + Ns, T*T] f32, the species rows of K1, K2 and K3 (S_* in
    csrc/pass_a_tv.cuh): 1/cutc, the r-independent Lucy W' factor of cutc,
    twice the harmonic mass, 0.01 cutc^2, then kappa of each species."""
    tabs = tabs or pair.coeff_tables(params, cfg)
    ihc, hc = tabs["inv_hc"], tabs["hc"]
    rows = [ihc, lucy_wfd_coef(ihc, cfg.dim), 2.0 * tabs["m_harm"],
            0.01 * hc * hc]
    rows += list(params.kappa.movedim(-1, 0))
    return torch.stack([r.reshape(-1) for r in rows]).to(torch.float32).contiguous()


def _mech_tables(params: Params, cfg, tabs: dict) -> torch.Tensor:
    """[7, T*T] f32, the full body's: the six rows of ``_tables``, then the harmonic shear
    modulus geff (0 without elastic solids, and under ``g0_chem_coupling``,
    where the kernel takes it from the G0 rows)."""
    geff = tabs.get("geff", torch.zeros_like(tabs["h"]))
    return torch.cat([_tables(params, cfg, tabs),
                      geff.reshape(1, -1).to(torch.float32)]).contiguous()


# kernel_tables's entries: (table, cfg, device) -> (params' field values,
# their tensors' versions, (tab, stab))
_table_cache: dict = {}


def kernel_tables(params: Params, cfg, table, device) -> tuple:
    """(``table(params, cfg, tabs)``, the species table or None without
    species) on ``device``, from ``pair.coeff_tables``: built once and kept
    while ``params`` holds the same field values, its tensors unedited
    (their ``_version``), so a step's launch adds no device op for them.
    The entry holds the field values themselves, so no identity is
    reused."""
    values = tuple(getattr(params, f.name) for f in dataclasses.fields(params))
    versions = tuple(v._version if isinstance(v, torch.Tensor) else None
                     for v in values)
    key = (table, cfg, device)
    hit = _table_cache.get(key)
    if (hit is None or hit[1] != versions
            or any(a is not b for a, b in zip(hit[0], values))):
        tabs = pair.coeff_tables(params, cfg)
        tab = table(params, cfg, tabs).to(device)
        stab = (_species_tables(params, cfg, tabs).to(device)
                if params.n_sdpd else None)
        if len(_table_cache) >= 16:
            _table_cache.clear()
        hit = _table_cache[key] = (values, versions, (tab, stab))
    return hit[2]


def _check_launch(pf: dict, params: Params, geom: Geometry, cfg, kernel,
                  noise=None):
    """Raise unless the wrapper ``kernel`` can take these fields (and, for
    the thermal noise, the state's (dt, step, key) ``noise``)."""
    missing = kernel_unsupported(geom, cfg, kernel, params.n_sdpd)
    if missing:
        raise NotImplementedError(
            f"pass-A kernel {kernel.__name__} for " + ", ".join(missing)
            + " is ported in a later PR")
    if pf["x"].dtype != torch.float32:
        raise TypeError(f"pass-A kernel takes float32 state, got {pf['x'].dtype}")
    cap, NC = pf["rho"].shape
    if NC != geom.ncells_total or cap != geom.cap:
        raise ValueError(f"fields are [{cap}, {NC}], geometry says "
                         f"[{geom.cap}, {geom.ncells_total}]")
    if cap * NC >= 2**31:
        raise ValueError(f"{cap * NC} slots overflow the kernels' 32-bit index")
    if cfg.thermal:
        if noise is None:
            raise ValueError("thermal noise needs the state's (dt, step, key)")
        dt, step, key = noise
        for what, t, dtype, n in (("dt", dt, torch.float32, 1),
                                  ("step", step, torch.int32, 1),
                                  ("key", key, torch.int64, 2)):
            if (t.dtype != dtype or t.numel() != n or not t.is_contiguous()
                    or t.device != pf["x"].device):
                raise TypeError(f"thermal noise reads {what} as {n} {dtype} on "
                                f"{pf['x'].device}, got {t.numel()} {t.dtype} "
                                f"on {t.device}")


def _noise_args(params: Params, cfg, noise) -> tuple:
    """The kernels' thermal arguments: the switch, the device pointers of
    dt, step and the key, the configuration's seed and -4 kB in f32 (the
    constant the plain path multiplies e by first)."""
    if not cfg.thermal:
        return 0, None, None, None, 0, 0.0
    dt, step, key = noise
    return (1, dt.data_ptr(), step.data_ptr(), key.data_ptr(),
            cfg.rng_seed & 0xFFFFFFFF, float(np.float32(-4.0 * params.boltz)))


_NOISE_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_uint, ctypes.c_float]


def _pack(pf: dict, names, cap: int, NC: int) -> torch.Tensor:
    """The f32 rows of ``names``; the int32 tags keep their bits."""
    return torch.cat([(pf[k].view(torch.float32) if k == "tag"
                       else pf[k].to(torch.float32)).reshape(-1, cap, NC)
                      for k in names])


def _unpack(out: torch.Tensor, accs) -> dict:
    """The accumulator rows of ``out`` by name; Q keeps its [Ns] axis."""
    result, r = {}, 0
    for name, n in accs:
        block = out[r:r + n]
        lead = (n,) if name == "Q" else pair._ACC_LEAD.get(name, ())
        result[name] = block.reshape(lead + block.shape[1:])
        r += n
    return result


def pass_a(pf: dict, params: Params, geom: Geometry, cfg, noise=None) -> dict:
    """Pass A accumulators (``pair.PASS_A_ACCS``) from the per-particle dict
    ``pf`` (``pair._per_particle``) through the wrapper ``route`` picks: its
    kernel on CUDA, the plain loop on CPU.  ``noise``: the state's (dt,
    step, key) (``pair.noise_inputs``), which the thermal noise reads."""
    return route(geom, cfg)(pf, params, geom, cfg, noise)


def _finish(result: dict, out_device, cap: int, NC: int) -> dict:
    """``result`` with zeros for every pass-A accumulator the kernel did not
    write (Q without species, the filter rows, ddx and dS): views of one
    zero-filled tensor, one device op."""
    zeros = {"Q": (0,), "rhoAux1": (), "rhoAux2": (), "ddx": (3,), "dS": (3, 3)}
    missing = {name: lead for name, lead in zeros.items() if name not in result}
    rows = [math.prod(lead) for lead in missing.values()]
    block = torch.zeros((sum(rows), cap, NC), dtype=torch.float32,
                        device=out_device)
    for (name, lead), part in zip(missing.items(), block.split(rows)):
        result[name] = part.reshape(lead + (cap, NC))
    return result


# K1's and K4's tile of cells per block, (along x, along y), by body
# (``tv_body``: True, the transport-velocity pair; False, the full body),
# then the smaller tiles it falls back to, in order, where a window of that
# tile would not fit a block's shared memory (many rows at a deep window).
# A window holds (tx + 2)(ty + 2) cells x the pack's rows x its depth (the
# grid's largest tail, ``tail_index``) f32; it may hold at most K4_SHARED
# bytes (``win2d::kMaxShared``: the 232,448 bytes of shared memory a block
# may hold on the H100, less the kernel's 528 static bytes) and 128 cells
# (one per thread of a block).  4 x 8 is the fastest
# of seven tiles on the H100 for both bodies (tools/torch_pass_a3d_timing.py
# ``tiles``, PERF.md): a warp's lanes are one slot row of the tile's 32
# cells.
K4_TILE = {True: (4, 8), False: (4, 8)}
K4_FALLBACK = ((4, 4), (2, 4), (2, 2), (1, 2), (1, 1))
K4_SHARED = 232_448 - 528


def k4_tile(rows: int, depth: int, tv: bool) -> tuple:
    """K1's and K4's tile (cells along x, along y) for a pack of ``rows``
    rows and a window ``depth`` slots deep: ``K4_TILE[tv]``, or the first
    of ``K4_FALLBACK`` whose window fits ``K4_SHARED`` bytes."""
    for tx, ty in (K4_TILE[tv],) + K4_FALLBACK:
        if 4 * rows * depth * (tx + 2) * (ty + 2) <= K4_SHARED:
            return tx, ty
    raise ValueError(f"no K4 window of {rows} rows {depth} slots deep fits "
                     f"{K4_SHARED} bytes")


def _library(wrapper) -> str:
    """The library (``csrc/<name>.cu``) and C entry point ``wrapper``
    launches: its own name, but K1's for K4."""
    return "pass_a_2d" if wrapper is pass_a_2d_preshift else wrapper.__name__


def _launch(wrapper, dims, pf: dict, params: Params, geom: Geometry, cfg,
            noise, rows, table, accs, args) -> dict:
    """Pack ``rows`` of ``pf``, launch ``wrapper``'s kernel
    (``csrc/<name>.cu``, ``_library``) over the grid ``dims`` and unpack
    the accumulators ``accs``.  The C entry point takes the pack, the coefficient table
    (``table(params, cfg, tabs)``), the species table, the output, the type
    count, the species count, the advection switch, cap, ``dims``, then
    ``args`` (``(ctypes type, value)`` pairs), the noise's arguments and the
    stream.  K1 and K4 take, first of ``args``, each cell's tail and the
    window's depth (``tail_index_of``), the pack's row count and the tile
    (``k4_tile``); K2 and K3, first of ``args``, their thread and walk index
    (``walk_index_of``)."""
    _check_launch(pf, params, geom, cfg, wrapper, noise)
    name = _library(wrapper)
    cap, NC = pf["rho"].shape
    ns = params.n_sdpd
    PF = _pack(pf, rows + (("C",) if ns else ())
               + (THERMAL_ROWS if cfg.thermal else ()), cap, NC)
    if wrapper in (pass_a_2d, pass_a_2d_preshift):
        tails, depth = tail_index_of(pf["valid"])
        tile = k4_tile(PF.shape[0], depth, table is _tables)
        args = ([(ctypes.c_void_p, tails.data_ptr())]
                + [(ctypes.c_int, n) for n in (PF.shape[0],) + tile + (depth,)]
                + list(args))
    if wrapper in (pass_a_3d, pass_a_2d_rowloop):
        order, lead = walk_index_of(pf["valid"])
        args = [(ctypes.c_void_p, order.data_ptr()),
                (ctypes.c_void_p, lead.data_ptr())] + list(args)
    tab, stab = kernel_tables(params, cfg, table, PF.device)
    accs = accs + ((("Q", ns),) if ns else ())
    out = torch.empty((sum(n for _, n in accs), cap, NC), dtype=torch.float32,
                      device=PF.device)

    lib = _build.load(name)
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * (4 + len(dims))
                   + [t for t, _ in args] + _NOISE_ARGTYPES + [ctypes.c_void_p])
    code = fn(PF.data_ptr(), tab.data_ptr(),
              None if stab is None else stab.data_ptr(), out.data_ptr(),
              params.ntypes, ns, int(bool(cfg.species_advection)), cap, *dims,
              *(v for _, v in args), *_noise_args(params, cfg, noise),
              _build.current_stream(PF.device))
    _build.check(lib, code, name)
    # on a slab (halo.SlabGeometry), the sums of its own cells
    first = geom.strides[0] if isinstance(geom, SlabGeometry) else 0
    out = out[..., first:NC - first]
    return _finish(_unpack(out, accs), PF.device, cap, NC - 2 * first)


def _tv_launch(wrapper, dims, pf: dict, params: Params, geom: Geometry, cfg,
               noise, before=(), after=()) -> dict:
    """The leaner body of K1, K4 or K3 (the transport-velocity pair of
    ``csrc/pass_a_tv.cuh``) over the grid ``dims``: PF_ROWS, then rhoI
    (filter) in, ACC_ROWS, then the filter rows out; the species and
    thermal rows as in ``_launch``; the C arguments ``before`` and
    ``after`` the filter switch."""
    filt = bool(cfg.density_filter_accs)
    return _launch(wrapper, dims, pf, params, geom, cfg, noise,
                   PF_ROWS + (("rhoI",) if filt else ()), _tables,
                   ACC_ROWS + (FILTER_ACC_ROWS if filt else ()),
                   list(before) + [(ctypes.c_int, int(filt))] + list(after))


def _mech_flags(cfg) -> int:
    """The runtime switches (``_F_*``) the full body reads from ``cfg``."""
    return ((_F_PSWITCH if cfg.pressure_switch else 0)
            | (_F_XSPH if cfg.xsph else 0)
            | (_F_FREE if cfg.free_solids_present else 0)
            | (_F_G0PAIR if cfg.g0_chem_coupling else 0)
            | (0 if cfg.solids_present else _F_NOSOLIDS))


def _mech_launch(wrapper, dims, pf: dict, params: Params, geom: Geometry,
                 cfg, noise, before=()) -> dict:
    """The full body (``csrc/pass_a_mech.cuh``: K2's, and K1's, K4's and
    K3's other) over the grid ``dims``, the C arguments ``before`` the
    filter switch: MECH_PF_ROWS,
    then AS and S (elastic) or ASd, then rhoI (filter) in; MECH_ACC_ROWS,
    then dS (elastic), then the filter rows out; the species and thermal
    rows as in ``_launch``."""
    filt = bool(cfg.density_filter_accs)
    elastic = bool(cfg.elastic_present)
    return _launch(
        wrapper, dims, pf, params, geom, cfg, noise,
        MECH_PF_ROWS + (("AS", "S") if elastic else ("ASd",))
        + (("rhoI",) if filt else ()),
        _mech_tables,
        MECH_ACC_ROWS + ((("dS", 9),) if elastic else ())
        + (FILTER_ACC_ROWS if filt else ()),
        list(before) + [(ctypes.c_int, int(filt)), (ctypes.c_int, int(elastic)),
                        (ctypes.c_int, _mech_flags(cfg))] + _wrap_args(geom)
        + [(ctypes.c_float, float(cfg.ampl_damp))])


def _wrap_args(geom: Geometry) -> list:
    """The periodic axes' bits and their extents in f32, the constants the
    plain path's minimum image rounds them to (read on the wrapping axes
    only), as ``(ctypes type, value)`` pairs."""
    return [(ctypes.c_int, wrap_bits(geom))] + [
        (ctypes.c_float, float(np.float32(geom.hi[ax] - geom.lo[ax])))
        for ax in range(3)]


def kernel_attributes(wrapper, filt: bool, ns: int, elastic: bool = False,
                      thermal: bool = False, tv: bool = False) -> tuple:
    """(registers per thread, local-memory bytes per thread: its spills) of
    the instantiation of a pass-A kernel (``wrapper``: ``pass_a_2d``,
    ``pass_a_2d_preshift``, ``pass_a_2d_rowloop`` or ``pass_a_3d``) for
    ``filt``, ``elastic``, ``ns`` species and ``thermal`` (K1, K4 and K3:
    their transport-velocity body with ``tv``), from
    ``cudaFuncGetAttributes``; K4's are K1's."""
    name = _library(wrapper)
    switches = (int(filt), int(elastic))
    if wrapper is not pass_a_2d_rowloop:
        switches = (0 if tv else 1,) + switches
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_attributes")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * (len(switches) + 2)
                   + [ctypes.POINTER(ctypes.c_int)] * 2)
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib, fn(*switches, ns, int(thermal), ctypes.byref(regs),
                         ctypes.byref(local)), f"{name}_attributes")
    return regs.value, local.value


def pass_a_2d(pf: dict, params: Params, geom: Geometry, cfg, noise=None) -> dict:
    """Pass A accumulators from ``pf`` through K1 on CUDA (the plain loop on
    CPU) on a 2D grid: every pair configuration (as ``pass_a_3d``), walls or
    periodic x and y of at least 3 cells, with up to ``MAX_SPECIES``
    continuum species, with or without the thermal noise; each block reads
    j from the 3x3 window of its tile (``k4_tile``) staged in shared
    memory, each cell to its tail (``tail_index_of``)."""
    if not pf["x"].is_cuda:
        return pair._pass_a_plain(pf, params, geom, cfg, noise)
    result = _two_body_launch(pass_a_2d, geom.ncells[:2], pf, params, geom,
                              cfg, noise)
    pass_a_2d.launches += 1
    return result


pass_a_2d.launches = 0  # K1 launches in this process


def pass_a_2d_preshift(pf: dict, params: Params, geom: Geometry, cfg,
                       noise=None) -> dict:
    """Pass A accumulators from ``pf`` through K4 on CUDA (the plain loop on
    CPU): the entry point of K1's library (``_library``) with K1's tile, so
    K1's sums, bitwise; this wrapper counts its own launches.  ``route``
    sends K1's grids here under ``preshift_window``."""
    if not pf["x"].is_cuda:
        return pair._pass_a_plain(pf, params, geom, cfg, noise)
    result = _two_body_launch(pass_a_2d_preshift, geom.ncells[:2], pf, params,
                              geom, cfg, noise)
    pass_a_2d_preshift.launches += 1
    return result


pass_a_2d_preshift.launches = 0  # K4 launches in this process


def tv_body(geom: Geometry, cfg) -> bool:
    """Whether K1, K4 and K3 run the transport-velocity pair (``tv_lacks``
    empty; in 2D also no periodic axis: K1's and K4's leaner body takes
    walls only) rather than the full body.  K3 runs it for solid-free
    scenes too (the 3D vortex, the 3D blob): with no solid its artificial
    stress carries the table's inv_wdelta of 0 and its BVF terms never
    run, so it adds the terms the full body adds under ``F_NOSOLIDS``,
    with fewer registers (``PERF.md``: as fast as the full body on the
    vortex, 2% faster on the blob)."""
    lacks = tv_lacks(cfg)
    if grid_3d(geom):
        return all(what == _SOLID_FREE for what in lacks)
    return not lacks and not periodic_multicell(geom)


def walk_index(valid: torch.Tensor) -> tuple:
    """K2's and K3's thread and walk index from the [cap, NC] validity:
    ``order``, int32 [cap * NC], the flat slot s = slot * NC + c of every
    valid slot in cell-major order (cell by cell, each cell's slots in
    order), then -1 to the end; ``lead``, int32 [NC], the count of each
    cell's leading valid slots (a cell's j walk stops at its first empty
    slot).  Thread t takes slot ``order[t]``, so the lanes of a warp share
    a cell and walk the same candidates; no list here can overflow:
    ``order`` has a place for every slot.  Nine torch ops."""
    cap, NC = valid.shape
    v = valid.bool()
    lead = v.cumprod(0).sum(0, dtype=torch.int32)
    by_cell = v.t().reshape(-1)  # flat c * cap + slot
    slot_of = torch.arange(cap * NC, dtype=torch.int32,
                           device=v.device).view(cap, NC).t().reshape(-1)
    # the valid slots to places 1.. by rank, the rest to the spill place 0
    rank = torch.where(by_cell, torch.cumsum(by_cell, 0), 0)
    order = torch.full((cap * NC + 1,), -1, dtype=torch.int32, device=v.device)
    order.scatter_(0, rank, slot_of)
    return order[1:], lead


def tail_index(valid: torch.Tensor) -> tuple:
    """K1's and K4's tails from the [cap, NC] validity: ``tails``, int32
    [NC], one past each cell's last valid slot (0 for an empty cell), so a
    cell's j walk stops there on any layout, compacted or not; and their
    largest, the depth of every window (a host int: one readback)."""
    cap = valid.shape[0]
    slots = torch.arange(1, cap + 1, dtype=torch.int32, device=valid.device)
    tails = (valid.bool() * slots[:, None]).amax(0).to(torch.int32)
    return tails, int(tails.max()) if tails.numel() else 0


# index function -> (valid, its _version, function(valid)), the last of each
_index_cache: dict = {}


def _kept_index(build, valid: torch.Tensor) -> tuple:
    """``build(valid)``, kept while ``valid`` is the same tensor and
    unchanged: a state's validity changes only at a rebin, which makes a
    new tensor, so an index is built once a rebin, not once a call.  The
    cache holds the tensor itself, so its identity cannot be taken by
    another, and its ``_version``, which an in-place edit bumps."""
    hit = _index_cache.get(build)
    if hit is None or hit[0] is not valid or hit[1] != valid._version:
        hit = _index_cache[build] = (valid, valid._version, build(valid))
    return hit[2]


def walk_index_of(valid: torch.Tensor) -> tuple:
    """``walk_index(valid)``, built once a rebin (``_kept_index``): K2's
    and K3's."""
    return _kept_index(walk_index, valid)


def tail_index_of(valid: torch.Tensor) -> tuple:
    """``tail_index(valid)``, built once a rebin (``_kept_index``): K1's
    and K4's, whose window depth is its one host readback a rebin."""
    return _kept_index(tail_index, valid)


def pass_a_3d(pf: dict, params: Params, geom: Geometry, cfg, noise=None) -> dict:
    """Pass A accumulators from ``pf`` through K3 on CUDA (the plain loop on
    CPU) on a 3D grid: every pair style (transport-velocity, mechanics,
    fsi), XSPH, fixed, free and elastic solids, solid-free scenes, walls or
    periodic axes (x, y, z, at least 3 cells each: the neighbour cell wraps
    by index, the pair offset takes the minimum image), with up to
    ``MAX_SPECIES`` continuum species, with or without the thermal noise
    (on the fluid branch).  The configurations the transport-velocity pair
    serves (``tv_body``: the 3D cavities and the solid-free scenes) run
    that leaner body, the rest the full one."""
    if not pf["x"].is_cuda:
        return pair._pass_a_plain(pf, params, geom, cfg, noise)
    result = _two_body_launch(pass_a_3d, geom.ncells, pf, params, geom, cfg,
                              noise)
    pass_a_3d.launches += 1
    return result


def _two_body_launch(wrapper, dims, pf: dict, params: Params, geom: Geometry,
                     cfg, noise) -> dict:
    """K1, K4 or K3 over the grid ``dims`` with the body this grid and
    ``cfg`` need: the transport-velocity pair where it serves (``tv_body``),
    else the full one."""
    if not tv_body(geom, cfg):
        return _mech_launch(wrapper, dims, pf, params, geom, cfg, noise,
                            [(ctypes.c_int, 1)])
    # the C entry point's arguments are the full body's either way: body 0,
    # filter, elastic 0, flags 0, the periodic axes, ampl 0
    return _tv_launch(
        wrapper, dims, pf, params, geom, cfg, noise,
        before=[(ctypes.c_int, 0)],
        after=[(ctypes.c_int, 0), (ctypes.c_int, 0)] + _wrap_args(geom)
        + [(ctypes.c_float, 0.0)])


pass_a_3d.launches = 0  # K3 launches in this process


def pass_a_2d_rowloop(pf: dict, params: Params, geom: Geometry, cfg,
                      noise=None) -> dict:
    """Pass A accumulators from ``pf`` through K2 on CUDA (the plain loop on
    CPU): K3's physics and walk (``pass_a_3d``) on a 2D grid, periodic in x
    and y."""
    if not pf["x"].is_cuda:
        return pair._pass_a_plain(pf, params, geom, cfg, noise)
    result = _mech_launch(pass_a_2d_rowloop, geom.ncells[:2], pf, params, geom,
                          cfg, noise)
    pass_a_2d_rowloop.launches += 1
    return result


pass_a_2d_rowloop.launches = 0  # K2 launches in this process
