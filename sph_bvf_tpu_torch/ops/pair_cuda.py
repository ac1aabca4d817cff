"""K1: the 2D pass-A pair kernel (``csrc/pass_a_2d.cu``) and its wrapper.

Port of ``sph_bvf_tpu/ops/pair_pallas.py`` for the flagship's grouped 2D
kernel.  ``pass_a_2d`` launches the CUDA kernel on a CUDA tensor and runs
the plain PyTorch loop (``ops/pair._pass_a_plain``) only on a CPU tensor.
A CUDA call the kernel cannot serve raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from sph_bvf_tpu_torch import _build
from sph_bvf_tpu_torch.core.halo import periodic_multicell
from sph_bvf_tpu_torch.core.state import Geometry, Params
from sph_bvf_tpu_torch.ops import pair
from sph_bvf_tpu_torch.ops.kernels import lucy_w_coef, lucy_wfd_coef

# Packed field rows, in the order csrc/pass_a_2d.cu reads them (R_* there);
# rhoI is staged only when the Shepard-filter accumulators are wanted.
PF_ROWS = ("valid", "ptype", "solid", "x", "v", "vest", "rho", "m", "B",
           "P_rho2", "m_rho", "V2", "ASd")
# Accumulator rows the kernel writes (O_* there).
ACC_ROWS = (("num_den", 1), ("ddv", 3), ("f", 3), ("drho", 1), ("de", 1),
            ("phi", 1), ("nw", 3))
FILTER_ACC_ROWS = (("rhoAux1", 1), ("rhoAux2", 1))


def kernel_unsupported(geom: Geometry, cfg: "pair.PairConfig") -> list:
    """What keeps K1 from serving this geometry and configuration."""
    return [what for what, bad in (
        ("a 3D grid", geom.dim != 2 or geom.ncells[2] != 1),
        ("a periodic axis", periodic_multicell(geom)),
        ("a solid-free scene (solids_present=False)", not cfg.solids_present),
    ) if bad]


def _tables(params: Params, cfg) -> torch.Tensor:
    """[5, T*T] f32: inv_h, eta, inv_wdelta and the two r-independent Lucy
    factors per type pair — the coefficients the plain path computes."""
    tabs = pair.coeff_tables(params, cfg)
    ih = tabs["inv_h"]
    rows = [ih, tabs["eta"], tabs["inv_wdelta"],
            lucy_wfd_coef(ih, cfg.dim), lucy_w_coef(ih, cfg.dim)]
    return torch.stack([r.reshape(-1) for r in rows]).to(torch.float32).contiguous()


def pass_a_2d(pf: dict, params: Params, geom: Geometry, cfg) -> dict:
    """Pass A accumulators (``pair.PASS_A_ACCS``) from the per-particle dict
    ``pf`` (``pair._per_particle``): K1 on CUDA, the plain loop on CPU."""
    if not pf["x"].is_cuda:
        return pair._pass_a_plain(pf, params, geom, cfg)
    pair.check_ported(params, cfg)
    missing = kernel_unsupported(geom, cfg)
    if missing:
        raise NotImplementedError(
            "pass-A kernel for " + ", ".join(missing) + " is ported in a later PR")
    if pf["x"].dtype != torch.float32:
        raise TypeError(f"pass-A kernel takes float32 state, got {pf['x'].dtype}")
    cap, NC = pf["rho"].shape
    if NC != geom.ncells_total or cap != geom.cap:
        raise ValueError(f"fields are [{cap}, {NC}], geometry says "
                         f"[{geom.cap}, {geom.ncells_total}]")
    filt = bool(cfg.density_filter_accs)
    names = PF_ROWS + (("rhoI",) if filt else ())
    PF = torch.cat([pf[k].reshape(-1, cap, NC).to(torch.float32) for k in names])
    tab = _tables(params, cfg).to(PF.device)
    accs = ACC_ROWS + (FILTER_ACC_ROWS if filt else ())
    out = torch.empty((sum(n for _, n in accs), cap, NC), dtype=torch.float32,
                      device=PF.device)
    for t in (PF, tab, out):
        if not t.is_contiguous() or t.device != PF.device:
            raise ValueError("pass-A kernel buffers must be contiguous on one device")

    lib = _build.load("pass_a_2d")
    fn = lib.pass_a_2d
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(PF.device):
        stream = torch.cuda.current_stream().cuda_stream
    code = fn(PF.data_ptr(), tab.data_ptr(), out.data_ptr(), params.ntypes,
              cap, geom.ncells[0], geom.ncells[1], int(filt), stream)
    _build.check(lib, code, "pass_a_2d")
    pass_a_2d.launches += 1

    result, r = {}, 0
    for name, n in accs:
        result[name] = out[r] if n == 1 else out[r:r + n]
        r += n
    if not filt:
        zero = torch.zeros((cap, NC), dtype=torch.float32, device=PF.device)
        result["rhoAux1"] = zero
        result["rhoAux2"] = zero
    return result


pass_a_2d.launches = 0  # kernel launches in this process
