#!/usr/bin/env python3
"""The rebin moves in the tree this runs from, on one CUDA card: the
registers and local bytes ptxas and the runtime report for K5's, K6's and
K7's kernels, then each move's ms per call as called (CUDA events, 50
calls) and on the device (torch.profiler, 50 calls), its bound and a
SHA-256 of its outputs, on the packs the main path's rebin hands it:

- after build and setup: K5 on the cavity at N=200 (4,761 cells, cap 14),
  on the same state sort-rebinned into x columns of alternating widths 7/8
  and 9/8 of a cell (``chip_smoke._synthetic_edges``, the grid of its ``K5
  edges`` phase) and on the flagship cavity at N=1000 (1,010,037
  particles), K7 on the 3D cavity at N=100 (1.19M particles, cap 38);
- with DIR, on the states ``tools/torch_pass_a3d_timing.py save DIR``
  wrote: K5 on the flagship and the mechanics cavity at N=1000 (walls) and
  the 2D Taylor-Green vortex at N=1000 (periodic x and y), each at step
  1000; K6 on the balanced 2D blob s=20 (``x_edges`` on a periodic x), the
  released FSI beam nx=60 (periodic x) and cell polarization at nx=100 and
  nx=1000 (periodic x and y); K7 on the 3D vortex N=100 at step 1000, the
  balanced 3D blob s=8, the released 3D FSI beam nx=60 (cap 296), the
  spanwise-periodic cavity N=100 and the 3D cavity N=100.

    python3 tools/torch_move_timing.py LABEL [DIR] [--only NAMES] [--cells]

from the root of a checkout: it imports the package found there, so two
checkouts timed in turns in one call (parent / change / change / parent,
the other tree unpacked under build/parent and run from its root with this
file's path) compare their kernels on one card, their hashes showing
whether the outputs are bitwise the same.  ``--only`` takes
comma-separated parts of state names (``2D``, ``3D``, ``setup``).
``--cells`` also builds the 2D move (``csrc/rebin_move_2d.cu``) from copies
of the sources with each variant of ``SWEEP`` written over its constants
(target cells a block, rows a thread of the copy loads at once, blocks an
SM holds) and with each edit of ``DIAGNOSTICS`` (its walk or its copy left
out: where the move's time goes), and times each on the 2D states.  The
bound is the
bytes the move must move at the state's occupancy (the valid row of every
slot and the other rows of the valid slots read once, every row of every
slot written once) over 3.35 TB/s, as ``chip_smoke.py`` counts them.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

import torch_pass_a3d_timing as saved  # noqa: E402  (this file's directory)
from sph_bvf_tpu_torch import _build  # noqa: E402
from sph_bvf_tpu_torch.core import rebin_cuda  # noqa: E402
from sph_bvf_tpu_torch.core import state as S  # noqa: E402
from sph_bvf_tpu_torch.core.stepper import _rebin_drop, setup  # noqa: E402
from sph_bvf_tpu_torch.models import lid_cavity, lid_cavity3d  # noqa: E402

CALLS = 50
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's memory rate
# the kernels each wrapper may launch, by the names torch.profiler shows (K6
# launches K5's kernel since the two share it; before, its own)
DEVICE_NAMES = {"rebin_move_2d": ("rebin_move_2d_kernel",),
                "rebin_move_2d_gated": ("rebin_move_2d_gated_kernel",
                                        "rebin_move_2d_kernel"),
                "rebin_move_3d": ("rebin_move_3d_kernel",)}
# ``--cells``: the 2D move built with each (target cells a block, rows a
# thread of the copy loads before it stores them, blocks an SM must hold at
# once), written over its constants in csrc/rebin_move_2d.cu
SWEEP_LINE = "constexpr int kCells = {}, kRows = {}, kBlocks = {};"
SWEEP = ((32, 8, 6), (16, 8, 6), (16, 4, 6), (32, 4, 6), (32, 8, 7),
         (32, 8, 8), (8, 4, 8))
# and with these edits of csrc/rebin_move.cuh, which break its output and
# show where its time goes: "walk only" copies nothing (every output slot
# written as zeros), "copy only" walks nothing (every slot of every cell,
# valid or not, copied to itself, every read coalesced)
DIAGNOSTICS = {
    "walk only": (("if (s < kept[cell]) {", "if (s < 0 * kept[cell]) {"),),
    "copy only": ((
        """    const int n =
        rank_matches<PLANE, SLAB>(W, c0 + cell, srcs[warp], lst + cell,
                                  stride);""",
        """    for (int r = threadIdx.x % 32; r < W.cap; r += 32)
      lst[cell + r * stride] = r * W.nc + c0 + cell;
    const int n = W.cap;"""),)}
# the states built here and set up, by name: (build, dt, x columns of
# alternating widths)
AFTER_SETUP = {
    "2D cavity N=200 after setup": (lambda: lid_cavity.build(N=200), 1e-4,
                                    False),
    "2D cavity N=200 x_edges after setup": (
        lambda: lid_cavity.build(N=200), 1e-4, True),
    "2D flagship N=1000 after setup": (
        lambda: lid_cavity.build(N=1000, dt=5e-6), 5e-6, False),
    "3D cavity3d N=100 after setup": (lambda: lid_cavity3d.build(N=100),
                                      1e-4, False),
}


def _packs(state, geom, drop=()):
    fields = {k: v for k, v in S.particle_fields(state).items()
              if k not in drop}
    fields["x"] = S.wrap_pbc(fields["x"], geom)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap,
                                               geom.ncells_total)
    return PF, PI, rebin_cuda._x_row(fmeta)


def _digest(*outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _bound_ms(PF, PI) -> float:
    _, cap, NC = PF.shape
    slots, n_valid = cap * NC, int(torch.count_nonzero(PI[0]))
    rows = PF.shape[0] + PI.shape[0]
    return 4 * (slots + n_valid * (rows - 1) + slots * rows) / HBM_BYTES_PER_S * 1e3


def _device_ms(call, names) -> tuple:
    """Device ms per call of the kernels named ``names`` over CALLS calls
    under torch.profiler, and the kernels' names; a window in which the
    profiler recorded none of them is profiled again, at most twice, and
    then this raises."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                call()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(n in e.key for n in names)]
        count = sum(e.count for e in hits)
        if count:
            return (sum(e.self_device_time_total for e in hits) / count / 1e3,
                    sorted({e.key[:60] for e in hits}))
    raise AssertionError(f"torch.profiler recorded no kernel named {names} "
                         f"in 3 windows of {CALLS} calls")


def _time(label, tag, call, names, PF, PI, geom, what):
    for _ in range(3):
        out = call()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(CALLS):
        call()
    e1.record()
    torch.cuda.synchronize()
    device_ms, keys = _device_ms(call, names)
    print(f"{label} | {tag} | {what} | grid {geom.ncells} cap {geom.cap} | "
          f"as called ms {e0.elapsed_time(e1) / CALLS!r} | device ms per call "
          f"{device_ms!r} | bound ms {_bound_ms(PF, PI)!r} | sha256 "
          f"{_digest(*out)} | {keys}", flush=True)


def _states(root, only):
    """(name, packs, geometry) of each state ``only`` selects: those set up
    here, then with ``root`` the saved ones."""
    parts = [p for p in only.split(",") if p]

    def chosen(name):
        return not parts or any(p in name for p in parts)

    for name, (build, dt, edges) in AFTER_SETUP.items():
        if chosen(name):
            state, params, spec, _ = build()
            state = setup(state, params, spec, dt=dt)
            geom, drop = spec.geom, _rebin_drop(spec)
            if edges:
                from chip_smoke import _synthetic_edges
                geom = _synthetic_edges(geom)
                state = S.rebin(state, geom, drop=drop, use_kernel=False,
                                drift_check=False)
            yield (f"{name}, {int(state.n_valid)} particles",
                   _packs(state, geom, drop), geom)
            del state
    if root:
        for name, (build, _, _, _) in saved._cases().items():
            if chosen(name):
                state, _, spec = saved._loaded(root, name, build)
                yield (f"{name}, step {int(state.step)}, {int(state.n_valid)} "
                       f"particles", _packs(state, spec.geom, _rebin_drop(spec)),
                       spec.geom)
                del state


def _edit(path, edits):
    text = path.read_text()
    for old, new in edits:
        assert text.count(old) == 1, (path.name, old)
        text = text.replace(old, new)
    path.write_text(text)


def _sweep_libraries() -> dict:
    """Variant label -> the 2D move's library built from a copy of csrc/
    with the variant's constants (``SWEEP``) or edits (``DIAGNOSTICS``),
    and its attributes; compiled in parallel beside the package's build."""
    out_dir = _build.BUILD_DIR / "sweep"
    jobs = {f"cells {c} rows {r} blocks {b}":
            ("rebin_move_2d.cu", ((None, SWEEP_LINE.format(c, r, b)),))
            for c, r, b in SWEEP}
    jobs.update({f"diagnostic {name}": ("rebin_move.cuh", edits)
                 for name, edits in DIAGNOSTICS.items()})

    def one(item):
        label, (target, edits) = item
        src = out_dir / ("src-" + label.replace(" ", "-"))
        shutil.copytree(_build.CSRC, src, dirs_exist_ok=True)
        if target == "rebin_move_2d.cu":  # over the constants' line
            text = (src / target).read_text()
            line = [ln for ln in text.splitlines()
                    if ln.startswith(SWEEP_LINE.split("{}")[0])]
            assert len(line) == 1, line
            edits = ((line[0], edits[0][1]),)
        _edit(src / target, edits)
        path = out_dir / ("lib-" + label.replace(" ", "-") + ".so")
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(path), str(src / "rebin_move_2d.cu")],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(path))
        return lib, rebin_cuda.move_2d_attributes(lib)

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        return dict(zip(jobs, pool.map(one, jobs.items())))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label")
    ap.add_argument("root", nargs="?")
    ap.add_argument("--only", default="")
    ap.add_argument("--cells", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_move_timing: no CUDA device", file=sys.stderr)
        return 2
    label = a.label
    print(f"{label} | device {torch.cuda.get_device_name(0)}", flush=True)
    for name in ("rebin_move_2d", "rebin_move_2d_gated", "rebin_move_3d"):
        if not (_build.CSRC / f"{name}.cu").exists():
            continue
        _build.load(name)
        for line in _build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(label, name, line.strip())
    if hasattr(rebin_cuda, "move_2d_attributes"):
        print(f"{label} | rebin_move_2d kernel: "
              f"{rebin_cuda.move_2d_attributes()}", flush=True)
    print(f"{label} | rebin_move_3d kernel (registers, local bytes), lists "
          f"in shared / global memory: {rebin_cuda.k7_attributes(True)} / "
          f"{rebin_cuda.k7_attributes(False)}", flush=True)
    variants = _sweep_libraries() if a.cells else {}
    for variant, (_, attrs) in variants.items():
        print(f"{label} | sweep {variant}: {attrs}", flush=True)
    for what, (PF, PI, xr), geom in _states(a.root, a.only):
        wrapper = rebin_cuda.move_route(geom)
        name = wrapper.__name__
        _time(label, name, lambda: wrapper(PF, PI, geom, xr),
              DEVICE_NAMES[name], PF, PI, geom, what)
        if wrapper is rebin_cuda.rebin_move_3d:
            continue
        own = _build.load("rebin_move_2d")
        try:
            for variant, (lib, _) in variants.items():
                _build._loaded["rebin_move_2d"] = lib
                _time(label, f"{name} {variant}",
                      lambda: wrapper(PF, PI, geom, xr),
                      DEVICE_NAMES[name], PF, PI, geom, what)
        finally:
            _build._loaded["rebin_move_2d"] = own
        del PF, PI
    return 0


if __name__ == "__main__":
    sys.exit(main())
