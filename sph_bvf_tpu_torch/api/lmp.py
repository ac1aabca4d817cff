"""LAMMPS input-script front end (the subset the SPH-BVF examples use)
(PyTorch).

Port of ``sph_bvf_tpu/api/lmp.py``: the same commands, arguments, errors
and citations; the parser is host numpy code and ``run`` drives the port's
``setup``/``simulate`` on the card unless the caller names another device.

The reference is driven by LAMMPS input scripts (input.cpp:854 command
dispatch) with a math-expression variable engine (variable.cpp).  This
module parses that language's SPH-BVF subset and builds the same simulation
through the Scene API, so a reference user can run their .lmp file directly:

    from sph_bvf_tpu_torch.api.lmp import parse_script
    model = parse_script(open("lid_driven_cavity.lmp").read())
    state, params, spec = model.run(max_steps=10_000, out_dir="out")

Supported commands (everything the four example families use):
  dimension, units, boundary, atom_style ssa_tsdpd/atomic Ns Nssa Nrxn,
  variable (equal and atom styles; ${} expansion, v_ references, sqrt, PI,
  count(group)), region (block with EDGE, sphere), create_box, lattice sq,
  create_atoms, delete_atoms, group (region/type/subtract/union/intersect/
  variable), set (type + the ssa_tsdpd/{rho,e,cv,C,Cd,solid_tag} keywords,
  set.cpp:547-613), mass, velocity set, pair_style ssa_tsdpd/bvf/*,
  pair_coeff, fix (integrators, setforce, ssa_tsdpd/{forcing,buffer,
  buoyancy,chem_rxn_mass_action,ssa_rxn_mass_action}, dt/adaptive), compute
  ssa_tsdpd/*/atom, dump vtk/custom, thermo, thermo_style, neighbor,
  newton, timestep,
  run, print.

Arg orders are transcribed from the reference parsers (citations inline).
Unknown commands raise; behavioral no-ops (units si, neighbor bin) are
accepted and recorded.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import shlex
from typing import Dict, List, Optional

import numpy as np

from sph_bvf_tpu_torch.api.scene import Region, Scene, _Block
from sph_bvf_tpu_torch.core import computes as computes_mod
from sph_bvf_tpu_torch.core.fixes import (
    Buffer,
    Buoyancy,
    ChemRxnMassAction,
    DtAdaptive,
    Forcing,
    SetForce,
)
from sph_bvf_tpu_torch.core.ssa import SsaConfig, SsaReaction

_PAIR_STYLES = {
    "ssa_tsdpd/bvf/transportVelocity": "transport_velocity",
    "ssa_tsdpd/bvf/mechanics": "mechanics",
    "ssa_tsdpd/bvf/fsi": "fsi",
}

_INTEGRATOR_FIXES = {
    "ssa_tsdpd/bvf/transportVelocity": "transport_velocity",
    "ssa_tsdpd/bvf/mechanics": "mechanics",
    "ssa_tsdpd/bvf/fsi": "fsi",
    "ssa_tsdpd/bvf": "bvf",
    "ssa_tsdpd/bvf/artificialStress": "artificial_stress",
    "ssa_tsdpd/bvf/zhang": "zhang",
    "ssa_tsdpd/stationary": "stationary",
}

_COMPUTE_STYLES = {
    "ssa_tsdpd/rho/atom": ("rho", 0),
    "ssa_tsdpd/phi/atom": ("phi", 0),
    "ssa_tsdpd/solid_tag/atom": ("solid_tag", 0),
    "ssa_tsdpd/C/atom": ("C", 1),
    "ssa_tsdpd/Cd/atom": ("Cd", 1),
    "ssa_tsdpd/e/atom": ("e", 0),
    "ssa_tsdpd/p/atom": ("p", 0),
    "ssa_tsdpd/stress/atom": ("stress", 2),
    "ssa_tsdpd/numberDensity/atom": ("number_density", 0),
}


class LmpError(ValueError):
    pass


@dataclasses.dataclass
class DumpSpec:
    label: str
    group: str
    every: int
    filename: str
    fields: List[str]
    style: str = "vtk"


@dataclasses.dataclass
class LmpModel:
    """Parsed script: a built-ready Scene plus output/run directives."""

    scene: Scene
    computes: Dict[str, tuple]  # label -> (name, idx tuple)
    dumps: List[DumpSpec]
    thermo_every: int
    nsteps: int
    dt: float
    variables: Dict[str, float]
    thermo_columns: Optional[List[str]] = None
    # `restart N file` (output.cpp:86-91): (every, path template with *)
    restart_spec: Optional[tuple] = None
    # `read_restart file` (read_restart.cpp): checkpoint to resume from
    read_restart_path: Optional[str] = None

    def build(self, device=None):
        """(state, params, spec) on ``device`` (default: the card)."""
        return self.scene.build(device=device)

    def run(self, max_steps: Optional[int] = None, out_dir: str = ".",
            callback=None, thermo=True, log_file: Optional[str] = None,
            device=None):
        """Build on ``device`` (default: the card) and run, honoring the
        dump/thermo/restart cadence (output.cpp analog).

        ``log_file`` mirrors the reference's `-log` CLI flag
        (lammps.cpp:112-192): thermo rows are appended there as well as
        printed to the screen.
        """
        from sph_bvf_tpu_torch.core.stepper import setup, simulate
        from sph_bvf_tpu_torch.utils.thermo import ThermoLogger

        state, params, spec = self.scene.build(device=device)
        if self.read_restart_path is not None:
            from sph_bvf_tpu_torch.io import checkpoint

            # geometry-fingerprint-validated; step/RNG continue from the file
            state = checkpoint.load(self.read_restart_path, spec.geom,
                                    device=state.x.device)
        state = setup(state, params, spec, dt=self.dt)
        nsteps = self.nsteps if max_steps is None else min(self.nsteps, max_steps)
        os.makedirs(out_dir, exist_ok=True)

        cadences = [d.every for d in self.dumps]
        if thermo and self.thermo_every:
            cadences.append(self.thermo_every)
        restart_writer = None
        if self.restart_spec is not None:
            from sph_bvf_tpu_torch.io.checkpoint import Restart

            every, tmpl = self.restart_spec
            cadences.append(every)
            restart_writer = Restart(
                every, os.path.join(out_dir, tmpl.replace("*", "{step}")),
                spec.geom,
            )
        chunk = spec.rebin_every
        g = math.gcd(*cadences) if cadences else chunk
        # the callback fires on chunk boundaries; unless every output cadence
        # is a multiple of the chunk, check every chunk so no frame is missed
        cb_every = g if g % chunk == 0 else chunk
        logger = (
            ThermoLogger(params, columns=self.thermo_columns,
                         dim=self.scene.dim, file=log_file)
            if thermo
            else None
        )

        def emit(st):
            stepno = int(st.step)
            if logger and self.thermo_every and stepno % self.thermo_every == 0:
                logger(st)
            if restart_writer is not None and stepno:
                restart_writer(st)
            for d in self.dumps:
                if stepno % d.every == 0:
                    self._write_dump(st, spec.geom, d, out_dir, stepno)
            if callback is not None:
                callback(st)

        emit(state)
        state = simulate(state, params, spec, nsteps,
                         callback=emit, callback_every=cb_every)
        return state, params, spec

    def _write_dump(self, state, geom, d: DumpSpec, out_dir: str, stepno: int):
        from sph_bvf_tpu_torch.core.state import gather_particles

        out = gather_particles(state, geom,
                               fields=("x", "v", "ptype", "groupmask"))
        sel = (out["groupmask"] & self.scene.groupbit(d.group)) != 0
        out = {k: v[sel] if k != "tag" else v[sel] for k, v in out.items()}
        pd = {}
        for f in d.fields:
            if f == "id":
                pd["id"] = out["tag"].astype(np.int32)
            elif f == "type":
                pd["type"] = (out["ptype"] + 1).astype(np.int32)
            elif f in ("vx", "vy", "vz"):
                pd[f] = out["v"][:, "xyz".index(f[1])]
            elif f in ("x", "y", "z"):
                pd[f] = out["x"][:, "xyz".index(f)]
            elif f.startswith("c_"):
                name, idx = self.computes[f[2:]]
                pd[f] = np.asarray(
                    computes_mod.gather_compute(state, geom, name, *idx)
                )[sel]
            else:
                raise LmpError(f"dump field {f!r} not supported")
        path = os.path.join(out_dir, d.filename.replace("*", str(stepno)))
        if d.style == "custom":
            from sph_bvf_tpu_torch.io.vtk import write_dump_custom

            write_dump_custom(path, stepno, geom, d.fields, out["x"], pd)
        else:
            from sph_bvf_tpu_torch.io.vtk import write_auto, write_bounding_box

            write_auto(path, out["x"], pd)
            # companion domain grid, once per dump series (the reference
            # rewrites the same fixed-name file every dump step —
            # dump_vtk.cpp:992-1005; content is constant)
            base, ext = os.path.splitext(
                os.path.join(out_dir, d.filename.replace("*", ""))
            )
            bext = ".vtk" if ext.lower() == ".vtk" else ".vtr"
            stem = base[:-1] if base.endswith("_") else base
            bpath = f"{stem}_boundingBox{bext}"
            if not hasattr(self, "_bbox_written"):
                self._bbox_written = set()
            if bpath not in self._bbox_written:
                self._bbox_written.add(bpath)
                write_bounding_box(bpath, self.scene.box_lo,
                                   self.scene.box_hi)


# ---------------------------------------------------------------------------
# expression engine (variable.cpp subset)
# ---------------------------------------------------------------------------

_NAME = r"[A-Za-z_][A-Za-z0-9_]*"


class _Evaluator:
    def __init__(self):
        self.values: Dict[str, float] = {}
        self.strings: Dict[str, str] = {}  # index/string-style variables
        self.atom_exprs: Dict[str, str] = {}
        self.count_fn = None  # set by the parser (group counting)

    def substitute(self, line: str) -> str:
        """${name} textual expansion (input.cpp:330)."""
        def repl(m):
            name = m.group(1)
            if name in self.strings:
                return self.strings[name]
            if name not in self.values:
                raise LmpError(f"undefined variable ${{{name}}}")
            return repr(self.values[name])

        prev = None
        while prev != line:
            prev = line
            line = re.sub(r"\$\{(%s)\}" % _NAME, repl, line)
        return line

    def _pythonize(self, expr: str) -> str:
        expr = expr.replace("^", "**")
        expr = re.sub(r"\bcount\((%s)\)" % _NAME, r"count('\1')", expr)
        expr = re.sub(r"\bv_(%s)" % _NAME, r"_v['\1']", expr)
        return expr

    def evaluate(self, expr: str) -> float:
        ns = {
            "_v": self.values,
            "sqrt": math.sqrt,
            "exp": math.exp,
            "ln": math.log,
            "log": math.log10,
            "abs": abs,
            "floor": math.floor,
            "ceil": math.ceil,
            "round": round,
            "sin": math.sin,
            "cos": math.cos,
            "tan": math.tan,
            "asin": math.asin,
            "acos": math.acos,
            "atan": math.atan,
            "atan2": math.atan2,
            "pow": math.pow,
            "PI": math.pi,
            "count": self.count_fn or (lambda g: 0),
            "__builtins__": {},
        }
        try:
            return float(eval(self._pythonize(expr), ns))  # noqa: S307
        except LmpError:
            raise
        except Exception as e:
            raise LmpError(f"cannot evaluate expression {expr!r}: {e}") from e

    def evaluate_atom(self, expr: str, x: np.ndarray) -> np.ndarray:
        """atom-style variable over positions [n, 3] -> per-atom values."""
        ns = {
            "_v": {
                **self.values,
                **{
                    k: self.evaluate_atom(v, x)
                    for k, v in self.atom_exprs.items()
                    if f"v_{k}" in expr
                },
            },
            "x": x[:, 0],
            "y": x[:, 1],
            "z": x[:, 2],
            "sqrt": np.sqrt,
            "abs": np.abs,
            "exp": np.exp,
            "ln": np.log,
            "log": np.log10,
            "sin": np.sin,
            "cos": np.cos,
            "tan": np.tan,
            "floor": np.floor,
            "ceil": np.ceil,
            "PI": math.pi,
            "__builtins__": {},
        }
        return np.asarray(eval(self._pythonize(expr), ns))  # noqa: S307


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


def _split(line: str) -> List[str]:
    """Tokenize one command line, honoring double quotes (input.cpp parse)."""
    lex = shlex.shlex(line, posix=True)
    lex.whitespace_split = True
    lex.commenters = "#"
    return list(lex)


def parse_script(text: str, overrides: Optional[Dict[str, float]] = None) -> LmpModel:
    """Parse an input script into an LmpModel.

    ``overrides`` replaces `variable NAME equal ...` values by name — the
    CLI `-var` mechanism (lammps.cpp:112-192), useful to shrink nt or grid
    sizes for testing.
    """
    ev = _Evaluator()
    overrides = dict(overrides or {})

    sc: Optional[Scene] = None
    pending: Dict[str, object] = dict(
        dim=2, boundary=("f", "f", "p"), n_sdpd=0, n_ssa=0, n_rxn=0
    )
    regions: Dict[str, Region] = {}
    box: Optional[_Block] = None
    computes: Dict[str, tuple] = {}
    dumps: List[DumpSpec] = []
    ssa_reactions: List[SsaReaction] = []
    thermo_every = 0
    thermo_columns = None
    nsteps = 0
    restart_spec = None
    read_restart_path = None
    dt = None
    integ_set = False

    def need_scene() -> Scene:
        nonlocal sc
        if sc is None:
            sc = Scene(
                dim=pending["dim"],
                n_sdpd=pending["n_sdpd"],
                n_ssa=pending["n_ssa"],
                n_rxn=pending["n_rxn"],
                boundary=pending["boundary"],
            )
            ev.count_fn = lambda g: float(sc.in_group(g).sum())
        return sc

    def num(tok: str) -> float:
        return ev.evaluate(tok)

    def resolve_region(args: List[str], style: str, name: str) -> Region:
        # 'side out' keyword (region.cpp options): invert containment
        invert = False
        if "side" in args:
            k = args.index("side")
            invert = args[k + 1] == "out"
            args = args[:k] + args[k + 2 :]
        r = _resolve_region_style(args, style)
        return ~r if invert else r

    def _resolve_region_style(args: List[str], style: str) -> Region:
        if style == "block":
            vals = []
            for i, tok in enumerate(args[:6]):
                if tok == "EDGE":
                    if box is None:
                        raise LmpError("EDGE region before create_box")
                    lohi = (box.lo, box.hi)[i % 2]
                    vals.append(lohi[i // 2])
                else:
                    vals.append(num(tok))
            return Region.block(*vals)
        if style == "sphere":
            cx, cy, cz, r = (num(t) for t in args[:4])
            return Region.sphere(cx, cy, cz, r)
        if style == "cylinder":
            # region ID cylinder dim c1 c2 radius lo hi (region_cylinder.cpp)
            axis = args[0]
            c1, c2, r = (num(t) for t in args[1:4])
            lohi = []
            for i, tok in enumerate(args[4:6]):
                if tok == "EDGE":
                    if box is None:
                        raise LmpError("EDGE region before create_box")
                    lohi.append((box.lo, box.hi)[i]["xyz".index(axis)])
                else:
                    lohi.append(num(tok))
            return Region.cylinder(axis, c1, c2, r, *lohi)
        if style == "cone":
            axis = args[0]
            c1, c2, rlo, rhi, lo, hi = (num(t) for t in args[1:7])
            return Region.cone(axis, c1, c2, rlo, rhi, lo, hi)
        if style == "plane":
            px, py, pz, nx_, ny_, nz_ = (num(t) for t in args[:6])
            return Region.plane(px, py, pz, nx_, ny_, nz_)
        if style == "prism":
            vals = (num(t) for t in args[:9])
            return Region.prism(*vals)
        if style in ("union", "intersect"):
            # region ID union N reg1 ... regN (region_union.cpp)
            n = int(num(args[0]))
            subs = [regions[a] for a in args[1 : 1 + n]]
            return Region.union(*subs) if style == "union" else Region.intersect(*subs)
        raise LmpError(f"region style {style!r} not supported")

    for raw in text.splitlines():
        line = ev.substitute(raw) if "$" in raw else raw
        toks = _split(line)
        if not toks:
            continue
        cmd, args = toks[0], toks[1:]

        if cmd == "dimension":
            pending["dim"] = int(num(args[0]))
        elif cmd == "units":
            if args[0] != "si":
                raise LmpError(f"units {args[0]!r} not supported (si only)")
        elif cmd == "boundary":
            pending["boundary"] = tuple(args[:3])
        elif cmd == "atom_style":
            if args[0] != "ssa_tsdpd/atomic":
                raise LmpError(f"atom_style {args[0]!r} not supported")
            ns_args = [int(num(a)) for a in args[1:4]]
            pending["n_sdpd"], pending["n_ssa"], pending["n_rxn"] = (
                ns_args + [0, 0, 0]
            )[:3]
        elif cmd == "variable":
            name, style = args[0], args[1]
            if style == "equal":
                if name in overrides:
                    ev.values[name] = float(overrides[name])
                else:
                    ev.values[name] = num(" ".join(args[2:]))
            elif style == "atom":
                ev.atom_exprs[name] = " ".join(args[2:])
            elif style in ("index", "loop", "world", "universe", "uloop",
                           "string"):
                # single-partition semantics (variable.cpp): the variable
                # holds its FIRST value — 'loop'/'uloop' start at 1,
                # 'world'/'universe' take value[0] with one partition,
                # 'index'/'string' take the first/only token.  ``-var``
                # overrides win, matching the reference CLI (lammps.cpp).
                # The 'next'/'jump' advancing machinery is unsupported and
                # raises loudly via the unknown-command path — nothing is
                # silently dropped.
                if name in overrides:
                    val = overrides[name]
                elif style in ("loop", "uloop"):
                    val = "1"
                else:
                    val = args[2]
                # ${} expansion must return the RAW token (variable.cpp does
                # textual substitution — 'variable tag string 007' expands as
                # 007, not 7.0), so keep the string always and mirror into
                # the numeric table only for v_-style arithmetic contexts
                ev.strings[name] = str(val)
                try:
                    ev.values[name] = float(val)
                except (TypeError, ValueError):
                    pass
            else:
                raise LmpError(f"variable style {style!r} not supported")
        elif cmd == "region":
            name, style = args[0], args[1]
            rest = [a for a in args[2:] if a not in ("units", "box")]
            regions[name] = resolve_region(rest, style, name)
        elif cmd == "create_box":
            ntypes = int(num(args[0]))
            box = regions[args[1]]
            need_scene().create_box(ntypes, box)
        elif cmd == "lattice":
            if args[0] != "sq":
                raise LmpError(f"lattice {args[0]!r} not supported")
            spacing = num(args[1])
            origin = (0.5, 0.5, 0.0)
            if "origin" in args:
                i = args.index("origin")
                origin = tuple(num(a) for a in args[i + 1 : i + 4])
            need_scene().lattice("sq", spacing, origin=origin)
        elif cmd == "create_atoms":
            t = int(num(args[0]))
            assert args[1] == "region"
            need_scene().create_atoms(t, regions[args[2]])
        elif cmd == "delete_atoms":
            assert args[0] == "region"
            need_scene().delete_atoms(regions[args[1]])
        elif cmd == "group":
            name, style = args[0], args[1]
            s = need_scene()
            if style == "region":
                s.group_region(name, regions[args[2]])
            elif style == "type":
                s.group_type(name, int(num(args[2])))
            elif style == "subtract":
                members = s.in_group(args[2]).copy()
                for other in args[3:]:
                    members &= ~s.in_group(other)
                s.group_expr(name, members)
            elif style == "union":
                members = s.in_group(args[2]).copy()
                for other in args[3:]:
                    members |= s.in_group(other)
                s.group_expr(name, members)
            elif style == "intersect":
                members = s.in_group(args[2]).copy()
                for other in args[3:]:
                    members &= s.in_group(other)
                s.group_expr(name, members)
            elif style == "variable":
                vals = ev.evaluate_atom(ev.atom_exprs[args[2]], s._current_x())
                s.group_expr(name, vals != 0)
            else:
                raise LmpError(f"group style {style!r} not supported")
        elif cmd == "set":
            assert args[0] == "group"
            g, key = args[1], args[2]
            s = need_scene()
            if key == "type":
                s.set_type(g, int(num(args[3])))
            elif key == "ssa_tsdpd/rho":
                s.set(g, rho=num(args[3]))
            elif key == "ssa_tsdpd/e":
                s.set(g, e=num(args[3]))
            elif key == "ssa_tsdpd/cv":
                pass  # heat capacity: carried by the reference, used by no shipped physics
            elif key == "ssa_tsdpd/C":
                s.set(g, C=(int(num(args[3])), num(args[4])))
            elif key == "ssa_tsdpd/Cd":
                s.set(g, Cd=(int(num(args[3])), num(args[4])))
            elif key == "ssa_tsdpd/solid_tag":
                fixed = args[4] == "fixed"
                s.set(g, solid_tag=int(num(args[3])), fixed=fixed)
            else:
                raise LmpError(f"set keyword {key!r} not supported")
        elif cmd == "mass":
            s = need_scene()
            m = num(args[1])
            types = range(1, s.ntypes + 1) if args[0] == "*" else [int(num(args[0]))]
            for t in types:
                s.mass(t, m)
        elif cmd == "velocity":
            assert args[1] == "set"
            vals = [num(a) for a in args[2:5]]
            need_scene().velocity(args[0], *vals)
        elif cmd == "pair_style":
            if args[0] not in _PAIR_STYLES:
                raise LmpError(f"pair_style {args[0]!r} not supported")
            need_scene().pair_style(_PAIR_STYLES[args[0]])
        elif cmd == "pair_coeff":
            s = need_scene()
            ii = range(1, s.ntypes + 1) if args[0] == "*" else [int(num(args[0]))]
            jj = range(1, s.ntypes + 1) if args[1] == "*" else [int(num(args[1]))]
            pairs = sorted({(min(i, j), max(i, j)) for i in ii for j in jj})
            vals = [num(a) for a in args[2:]]
            rho0, c0, eta, h, cutc, g0 = vals[:6]
            rest = vals[6:]
            kap = tuple(rest[: s.n_sdpd])
            kss = tuple(rest[s.n_sdpd : s.n_sdpd + s.n_ssa])
            if s.n_sdpd and not kap:
                kap = (0.0,) * s.n_sdpd
            if s.n_ssa and not kss:
                kss = (0.0,) * s.n_ssa
            for i, j in pairs:
                s.pair_coeff(i, j, rho0, c0, eta, h, cutc, g0,
                             kappa=kap, kappa_ssa=kss)
        elif cmd == "fix":
            _parse_fix(args, need_scene(), ev, ssa_reactions)
            if args[2] in _INTEGRATOR_FIXES:
                integ_set = True
        elif cmd == "compute":
            label, group, style = args[0], args[1], args[2]
            if style not in _COMPUTE_STYLES:
                raise LmpError(f"compute style {style!r} not supported")
            name, nidx = _COMPUTE_STYLES[style]
            idx = tuple(int(num(a)) for a in args[3 : 3 + nidx])
            computes[label] = (name, idx)
        elif cmd == "dump":
            label, group, style = args[0], args[1], args[2]
            if style not in ("vtk", "custom"):
                raise LmpError(f"dump style {style!r} not supported")
            dumps.append(
                DumpSpec(label, group, int(num(args[3])), args[4], args[5:],
                         style=style)
            )
        elif cmd == "thermo":
            thermo_every = int(num(args[0]))
        elif cmd == "thermo_style":
            if args and args[0] == "custom":
                known = {"step", "dt", "press", "temp", "etotal", "ke"}
                thermo_columns = [a for a in args[1:] if a in known]
        elif cmd == "neighbor":
            pass  # skin/bin: superseded by the drift-margin cell sizing
        elif cmd == "timestep":
            dt = num(args[0])
        elif cmd == "run":
            nsteps = int(num(args[0]))
        elif cmd == "restart":
            # restart N file (output.cpp:86-91); N=0 disables
            every = int(num(args[0]))
            restart_spec = (every, args[1]) if every > 0 else None
        elif cmd == "read_restart":
            # read_restart file (read_restart.cpp): resume from a checkpoint.
            # Unlike the reference (which restores the whole system from the
            # file), the scene commands stay in the script — the checkpoint
            # replaces the *initial particle state*, geometry-validated
            # against the rebuilt scene.  `run N` then runs N more steps.
            read_restart_path = args[0]
        elif cmd in ("log", "echo", "processors", "suffix", "package"):
            pass  # host/process-level directives with no analog here
        elif cmd == "newton":
            # full-neighbor pair sums are newton-off by construction
            # (SURVEY L2); "newton on" would halve the reference's pair
            # work but changes nothing here
            pass
        elif cmd == "print":
            print("[lmp]", args[0] if args else "")
        else:
            raise LmpError(f"unsupported command {cmd!r}")

    if sc is None or dt is None:
        raise LmpError("script defines no simulation (missing create_box/timestep)")
    sc.timestep(dt)
    if ssa_reactions:
        sc.ssa(SsaConfig(reactions=tuple(ssa_reactions)))
    if not integ_set:
        raise LmpError("script declares no integrator fix")
    return LmpModel(
        scene=sc,
        computes=computes,
        dumps=dumps,
        thermo_every=thermo_every,
        thermo_columns=thermo_columns,
        nsteps=nsteps,
        dt=dt,
        variables=dict(ev.values),
        restart_spec=restart_spec,
        read_restart_path=read_restart_path,
    )


def _parse_fix(args: List[str], sc: Scene, ev: _Evaluator, ssa_reactions):
    label, group, style = args[0], args[1], args[2]
    rest = args[3:]
    num = ev.evaluate

    if style in _INTEGRATOR_FIXES:
        sc.integrator(_INTEGRATOR_FIXES[style])
        return
    gb = sc.groupbit(group)
    if style == "setforce":
        vals = [None if a == "NULL" else num(a) for a in rest[:3]]
        sc.fix(SetForce(groupbit=gb, fx=vals[0], fy=vals[1], fz=vals[2]))
    elif style == "ssa_tsdpd/forcing":
        # <tsdpd|ssa|velocity> step index <circle cx cy r | rectangle cx cy L W> value
        # (fix_ssa_tsdpd_forcing.cpp:40-101)
        field, step, index, shape = rest[0], int(num(rest[1])), int(num(rest[2])), rest[3]
        if shape == "circle":
            cx, cy, r, value = (num(a) for a in rest[4:8])
            fx = Forcing(groupbit=gb, field=field, index=index, shape="circle",
                         center=(cx, cy), radius=r, value=value, after_step=step)
        else:
            cx, cy, L, W, value = (num(a) for a in rest[4:9])
            fx = Forcing(groupbit=gb, field=field, index=index, shape="rectangle",
                         center=(cx, cy), length=L, width=W, value=value,
                         after_step=step)
        sc.fix(fx)
    elif style == "ssa_tsdpd/buffer":
        # <tsdpd|velocity|density> <x|y> step index cx cy L W value
        # (fix_ssa_tsdpd_buffer.cpp:40-95)
        field, direction = rest[0], rest[1]
        step, index = int(num(rest[2])), int(num(rest[3]))
        cx, cy, L, W, value = (num(a) for a in rest[4:9])
        sc.fix(Buffer(groupbit=gb, field=field, direction=direction,
                      index=index, center=(cx, cy), length=L, width=W,
                      value=value, after_step=step))
    elif style == "ssa_tsdpd/buoyancy":
        # <boussinesq/sdpd|gravity> acceleration dim species C_ref
        # (fix_ssa_tsdpd_buoyancy.cpp:43-47)
        mode = "boussinesq" if rest[0].startswith("boussinesq") else "gravity"
        sc.fix(Buoyancy(groupbit=gb, mode=mode, acceleration=num(rest[1]),
                        dim=int(num(rest[2])), species=int(num(rest[3])),
                        c_ref=num(rest[4])))
    elif style == "ssa_tsdpd/chem_rxn_mass_action":
        # k_rate nR r... nP p... (fix_ssa_tsdpd_chem_rxn_mass_action.cpp:30-52)
        vals = [num(a) for a in rest]
        k = vals[0]
        nr = int(vals[1])
        reactants = tuple(int(v) for v in vals[2 : 2 + nr])
        np_ = int(vals[2 + nr])
        products = tuple(int(v) for v in vals[3 + nr : 3 + nr + np_])
        sc.fix(ChemRxnMassAction(groupbit=gb, k_rate=k,
                                 reactants=reactants, products=products))
    elif style == "ssa_tsdpd/ssa_rxn_mass_action":
        # rxn_index k_rate nR r... nP p... (fix_ssa_tsdpd_ssa_rxn_mass_action.cpp:35-60)
        vals = [num(a) for a in rest]
        k = vals[1]
        nr = int(vals[2])
        reactants = tuple(int(v) for v in vals[3 : 3 + nr])
        np_ = int(vals[3 + nr])
        products = tuple(int(v) for v in vals[4 + nr : 4 + nr + np_])
        ssa_reactions.append(
            SsaReaction(k_rate=k, reactants=reactants, products=products,
                        groupbit=gb)
        )
    elif style == "dt/adaptive":
        # CFL dx_ave tmin tmax (fix_dt_adaptive.cpp)
        sc.fix(DtAdaptive(groupbit=gb, cfl=num(rest[0]), dx_ave=num(rest[1]),
                          tmin=num(rest[2]), tmax=num(rest[3])))
    else:
        raise LmpError(f"fix style {style!r} not supported")
