"""The port's multi-device mesh (``sph_bvf_tpu_torch/parallel/mesh.py``) on
CPU ranks over gloo, against the JAX package.

One group of 4 ranks (``tests/torch_mesh_ranks.py``, which imports no JAX)
runs every leg in processes of its own, each pinned to one thread, while
this process runs the JAX package on the same seeded inputs; the legs
then compare:

1. ``halo.exchange_slabs`` on walls and on a ring at 4 ranks, against the
   JAX package's under ``shard_map`` on 4 of the 8 virtual devices: exact;
2. pass A on 2 slabs (the plain path on the ghosted slab) against JAX's
   unsharded ``compute_forces``, rtol 1e-9: the cavity on walls, the FSI
   beam (periodic x, elastic solids) and the thermal noise;
3. the move on 2 slabs after a seeded drift across the slabs' seam and the
   periodic seam, against JAX's sort ``rebin``: every leaf bitwise;
4. setup and two ``run_chunk`` at 2 ranks against JAX's: x, v and rho by
   tag within 1e-8, overflow and drift equal;
5. the drifting blob with its in-run re-cut at 2 ranks against JAX's
   ``simulate``: ``balance_log`` equal, the fields by tag within 1e-8;
6. ``DtAdaptive`` at 2 ranks: JAX's dt, bitwise;
7. a one-rank mesh (walls, and a ring of one): bitwise the port with no
   mesh;
8. here, with no ranks: the slab moves' plain version against the numpy
   emulation of the kernels' warp walk (``tests/warp_walk.py``, the
   kernels' candidate order) and the sort, and the 3D pass A on a slab
   against the unsharded one;
9. the thermo row at 2 ranks, with the virial press, and the rows a
   ``Halt`` and a ``ThermoLogger`` on the mesh read, against JAX's
   ``thermo_row`` of the whole state, rtol 1e-9; and, with no ranks, the
   outputs that refuse a slab without ``mesh=``.

``tests/test_torch_mesh_ssa.py`` holds the stochastic species, pass B and
the outputs (checkpoint, restart, frame, computes) on the mesh.
"""

import concurrent.futures
import dataclasses
import functools
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import torch_mesh_ranks as R
import warp_walk
from sph_bvf_tpu.api import scene as jscene
from sph_bvf_tpu.core import fixes as jfixes
from sph_bvf_tpu.core import halo as jhalo
from sph_bvf_tpu.core import state as JS
from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.models import fsi as jfsi
from sph_bvf_tpu.models import lid_cavity as jlid
from sph_bvf_tpu.ops import pair as jpair
from sph_bvf_tpu.utils import thermo as jthermo
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.core import computes as tcomputes
from sph_bvf_tpu_torch.core import halo as thalo
from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.io import checkpoint as tcheckpoint
from sph_bvf_tpu_torch.io import vtk as tvtk
from sph_bvf_tpu_torch.models import fsi as tfsi
from sph_bvf_tpu_torch.models import lid_cavity as tlid
from sph_bvf_tpu_torch.models import lid_cavity3d as tlid3
from sph_bvf_tpu_torch.ops import pair as tpair
from sph_bvf_tpu_torch.parallel import launch
from sph_bvf_tpu_torch.parallel import mesh as tmesh
from sph_bvf_tpu_torch.utils import thermo as tthermo


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the 4-rank group at once (it runs beside this process's JAX
    runs); ``ranks()`` waits for it and returns its output directory."""
    out = tmp_path_factory.mktemp("mesh")
    failed = []

    def run():
        try:
            launch.spawn(R.legs, R.RANKS, "gloo", str(out / "init"),
                         args=(str(out),), timeout=600)
        except Exception as e:  # re-raised in the test thread
            failed.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if failed:
            raise failed[0]
        return out

    return wait


def _load(ranks, name):
    return dict(np.load(ranks() / f"{name}.npz"))


def _jax(cls, arrays):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in arrays.items()})


def _jax_inputs(build, seed=None, drift=None):
    """The JAX-built state (f64 numpy, perturbed or drifted as the ranks
    do), its params (f64 numpy) and spec."""
    js, jp, jspec = build()
    s = R.f64(bridge.to_numpy(js))
    if seed is not None:
        s = R.perturbed(s, seed)
    if drift is not None:
        s = R.drifted(s, jspec.geom.cell_size, drift)
    return s, R.f64(bridge.to_numpy(jp)), jspec


def _by_tag(a, name):
    v = a["valid"].reshape(-1)
    tag = a["tag"].reshape(-1)[v]
    f = a[name]
    f = f.reshape(f.shape[:-2] + (-1,))[..., v]
    return f[..., np.argsort(tag)]


def _jax_exchange():
    """Leg 1's JAX halos: (left, right) for walls and the ring."""
    from jax import shard_map

    mesh = JMesh(np.array(jax.devices()[:R.RANKS]), ("x",))
    spec = P(None, None, "x")
    out = {}
    for periodic in (False, True):
        f = shard_map(
            lambda m: jhalo.exchange_slabs(m, R.WIDTH, "x", R.RANKS, periodic),
            mesh=mesh, in_specs=spec, out_specs=(spec, spec))
        out[periodic] = tuple(np.asarray(a)
                              for a in f(jnp.asarray(R.exchange_input())))
    return out


PASS_A = {
    "cavity": (lambda: R.cavity(jlid), False),
    "fsi": (lambda: R.fsi_beam(jfsi), False),
    "thermal": (lambda: R.cavity(jlid), True),
}
_forces = jax.jit(jpair.compute_forces, static_argnames=("geom", "cfg"))
_rebin = jax.jit(JS.rebin, static_argnames=("geom", "use_pallas"))


def _jax_pass_a(case):
    """Leg 2's JAX pass A (jnp path) on the perturbed state, and its
    input."""
    build, thermal = PASS_A[case]
    s, p, jspec = _jax_inputs(build, seed=3)
    cfg = dataclasses.replace(jspec.pair, use_pallas=False)
    if thermal:
        p = R.thermal_params(p)
        cfg = dataclasses.replace(cfg, thermal=True)
    out = _forces(_jax(JS.State, s), _jax(JS.Params, p), jspec.geom, cfg)
    return bridge.to_numpy(out), s, p, jspec, cfg


def _jax_move(case):
    build = {"cavity": lambda: R.cavity(jlid), "fsi": lambda: R.fsi_beam(jfsi)}[case]
    s, p, jspec = _jax_inputs(build, drift=7)
    return bridge.to_numpy(_rebin(_jax(JS.State, s), jspec.geom,
                                  use_pallas=False)), s


def _jax_run_chunk():
    s, p, jspec = _jax_inputs(lambda: R.cavity(jlid))
    js, jp = _jax(JS.State, s), _jax(JS.Params, p)
    js = jstepper.setup(js, jp, jspec, dt=R.DT)
    for _ in range(2):
        js = jstepper.run_chunk(js, jp, jspec, jspec.rebin_every)
    return bridge.to_numpy(js)


def _jax_blob():
    js, jp, jspec = R.drift_blob(jscene).build()
    s, p = R.f64(bridge.to_numpy(js)), R.f64(bridge.to_numpy(jp))
    js, jp = _jax(JS.State, s), _jax(JS.Params, p)
    log = []
    js = jstepper.simulate(jstepper.setup(js, jp, jspec, dt=2e-4), jp, jspec,
                           R.BLOB_STEPS, balance_log=log)
    return bridge.to_numpy(js), json.loads(json.dumps(
        [R.log_entry(e) for e in log]))


def _jax_dt():
    s, p, jspec = _jax_inputs(lambda: R.cavity(jlid), seed=13)
    return float(jfixes.DtAdaptive(**R.DT_FIX).apply(
        _jax(JS.State, s), _jax(JS.Params, p)).dt)


THERMO = {"cavity": lambda: R.cavity(jlid), "fsi": lambda: R.fsi_beam(jfsi)}


def _jax_thermo(case):
    s, p, jspec = _jax_inputs(THERMO[case], seed=3)
    return jthermo.thermo_row(_jax(JS.State, s), _jax(JS.Params, p), dim=2,
                              geom=jspec.geom, pair_cfg=jspec.pair)


@pytest.fixture(scope="module")
def refs():
    """The JAX package's side of every leg, computed in threads beside the
    ranks (compiling and running XLA programs releases the GIL)."""
    jobs = {"exchange": _jax_exchange, "run_chunk": _jax_run_chunk,
            "blob": _jax_blob, "dt": _jax_dt}
    jobs.update({f"pass_a_{c}": functools.partial(_jax_pass_a, c) for c in PASS_A})
    jobs.update({f"move_{c}": functools.partial(_jax_move, c)
                 for c in ("cavity", "fsi")})
    jobs.update({f"thermo_{c}": functools.partial(_jax_thermo, c) for c in THERMO})
    pool = concurrent.futures.ThreadPoolExecutor(3)
    # the longest first
    order = ["blob", "pass_a_fsi", "run_chunk"] + [k for k in jobs if k not in (
        "blob", "pass_a_fsi", "run_chunk")]
    futures = {k: pool.submit(jobs[k]) for k in order}
    yield lambda k: futures[k].result()
    pool.shutdown(wait=True)


def test_exchange_slabs_matches_jax_shard_map(ranks, refs):
    """Leg 1: each rank's halos of a seeded array, one plane wide, at 4
    ranks on walls and on a ring, exactly JAX's ``exchange_slabs`` under
    ``shard_map``."""
    for periodic, (left, right) in refs("exchange").items():
        for r in range(R.RANKS):
            got = _load(ranks, f"exchange_{r}")
            w = slice(r * R.WIDTH, (r + 1) * R.WIDTH)
            np.testing.assert_array_equal(got[f"left_{periodic}"], left[..., w])
            np.testing.assert_array_equal(got[f"right_{periodic}"], right[..., w])
        if not periodic:  # the chain's ends get zeros
            assert not left[..., :R.WIDTH].any() and not right[..., -R.WIDTH:].any()
        else:
            assert left[..., :R.WIDTH].any() and right[..., -R.WIDTH:].any()


def test_one_rank_exchange_degenerates():
    """A one-rank mesh exchanges nothing: its own far edges on a ring,
    zeros on walls (the JAX package's docstring)."""
    from sph_bvf_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(group=None, backend="gloo", rank=0, size=1,
                device=torch.device("cpu"), ranks=(0,))
    M = torch.as_tensor(R.exchange_input())
    left, right = thalo.exchange_slabs(M, R.WIDTH, mesh, True)
    assert torch.equal(left, M[..., -R.WIDTH:]) and torch.equal(right, M[..., :R.WIDTH])
    left, right = thalo.exchange_slabs(M, R.WIDTH, mesh, False)
    assert not left.any() and not right.any()
    (g,) = thalo.ghost_slabs([M], R.WIDTH, mesh, True)
    assert torch.equal(g[..., R.WIDTH:-R.WIDTH], M)


@pytest.mark.parametrize("case", list(PASS_A))
def test_pass_a_on_two_slabs_matches_jax(ranks, refs, case):
    """Leg 2: pass A of each of 2 slabs, joined, against JAX's unsharded
    jnp pass on the same perturbed state, rtol 1e-9.  With the thermal
    noise, f may differ from JAX's by what the port's unsharded pass
    differs (the normals' ulps, ``tests/test_torch_thermal.py``), and the
    slabs hold the unsharded pass to rtol 1e-9."""
    ref, s, p, jspec, cfg = refs(f"pass_a_{case}")
    got = _load(ranks, f"pass_a_{case}")
    np.testing.assert_array_equal(got["tag"], s["tag"])
    extra = {}
    if cfg.thermal:
        one = bridge.state_from_port(tpair.compute_forces(
            bridge.state_to_port(s, device="cpu"),
            bridge.params_to_port(R._Obj(p), device="cpu"), jspec.geom, cfg))
        extra["f"] = np.abs(one["f"] - ref["f"])
        np.testing.assert_allclose(got["f"], one["f"], rtol=1e-9,
                                   atol=1e-11 * np.abs(one["f"]).max())
    for name in ("f", "drho", "ddv", "ddx", "num_den", "phi", "nw", "dS",
                 "rhoAux1", "rhoAux2"):
        a = ref[name]
        scale = max(float(np.abs(a).max()), 1e-300)
        tol = 1e-9 * np.abs(a) + 1e-11 * scale + extra.get(name, 0.0)
        assert (np.abs(got[name] - a) <= tol).all(), (
            name, float(np.abs(got[name] - a).max()))


@pytest.mark.parametrize("case", ["cavity", "fsi"])
def test_move_on_two_slabs_is_the_jax_sort(ranks, refs, case):
    """Leg 3: the slab move after a seeded drift (across the slabs' seam,
    and on the FSI beam across the periodic x seam) gives JAX's sort
    rebin's slots: every leaf bitwise, overflow and drift equal."""
    ref, s = refs(f"move_{case}")
    got = _load(ranks, f"move_{case}")
    assert (s["x"][0] != ref["x"][0]).any()
    for name, a in ref.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)


def test_run_chunk_two_ranks_matches_jax(ranks, refs):
    """Leg 4: setup and two chunks at 2 ranks against JAX's unsharded run:
    the slots bitwise, x, v and rho by tag within 1e-8, overflow and drift
    equal."""
    a, b = refs("run_chunk"), _load(ranks, "run_chunk")
    assert int(b["step"]) == 10
    for name in ("overflow", "drift_violation", "tag", "valid"):
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    for name in ("x", "v", "rho"):
        np.testing.assert_allclose(_by_tag(b, name), _by_tag(a, name), rtol=0,
                                   atol=1e-8, err_msg=name)


def test_drift_blob_recut_two_ranks_matches_jax(ranks, refs):
    """Leg 5: the balanced drifting blob with its in-run re-cut (at step
    100) at 2 ranks against JAX's unsharded ``simulate``: the same
    ``balance_log`` (steps, geometries and metrics), x, v and rho by tag
    within 1e-8."""
    a, jlog = refs("blob")
    with open(ranks() / "blob_log.json") as fh:
        tlog = json.load(fh)
    assert tlog == jlog
    assert [e["step"] for e in tlog if e["geom"] is not None] == [100]
    b = _load(ranks, "blob")
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    np.testing.assert_array_equal(np.sort(b["tag"][b["valid"]]),
                                  np.sort(a["tag"][a["valid"]]))
    for name in ("x", "v", "rho"):
        np.testing.assert_allclose(_by_tag(b, name), _by_tag(a, name), rtol=0,
                                   atol=1e-8, err_msg=name)


def test_dt_adaptive_two_ranks_matches_jax(ranks, refs):
    """Leg 6: ``DtAdaptive``'s dt at 2 ranks (its max reduced over them)
    is JAX's on the whole state, bitwise."""
    got = float(_load(ranks, "dt_adaptive")["dt"])
    assert got == refs("dt") and got < R.DT_FIX["tmax"]


@pytest.mark.parametrize("case", ["cavity", "fsi"])
def test_one_rank_mesh_is_no_mesh(ranks, case):
    """Leg 7: setup and two chunks on a one-rank mesh (walls; the FSI
    beam's ring of one) equal the run with no mesh, every leaf bitwise."""
    got = _load(ranks, "one_rank")
    names = [k[len(case) + 7:] for k in got if k.startswith(f"{case}_plain_")]
    assert "x" in names and "f" in names
    for k in names:
        np.testing.assert_array_equal(got[f"{case}_mesh_{k}"],
                                      got[f"{case}_plain_{k}"], err_msg=k)


# -- leg 8: the slab kernels' plain versions, with no ranks ------------------


def _ghosted(a, slab, plane, periodic):
    """``a`` [..., NC]'s columns of the slab with one halo plane each side
    (zeros past a wall), as the exchange builds them."""
    NC = a.shape[-1]
    lo = slab.x0 * plane
    hi = lo + (slab.ncells[0] - 2) * plane
    idx = torch.arange(lo - plane, hi + plane)
    if periodic:
        return a[..., idx % NC]
    out = a[..., idx.clamp(0, NC - 1)].clone()
    out[..., (idx < 0) | (idx >= NC)] = 0
    return out


def _slab_states():
    cav = tlid.build(N=16, dt=R.DT, ncx_multiple_of=2, device="cpu")
    beam = tfsi.build(nx=12, ncx_multiple_of=2, device="cpu")
    sc3 = tlid3.build(N=6, device="cpu")[3]
    sc3.ncx_multiple_of = 2
    return {"cavity": cav[:3], "fsi": beam[:3], "cavity3d": sc3.build(device="cpu")}


@pytest.mark.parametrize("case", ["cavity", "fsi", "cavity3d"])
def test_slab_move_in_the_kernels_order(case):
    """Leg 8: on each of 2 slabs after a seeded drift, the move's plain
    version (``rebin_move_plain`` with the slab) equals the numpy emulation
    of the kernels' warp walk on the same ghosted packs (K5's plane form on
    walls, K6's on the periodic FSI beam, K7's loop form in 3D) and the
    slab of the sort rebin of the whole grid."""
    s, p, spec = _slab_states()[case]
    geom = spec.geom
    d = R.drifted(bridge.state_from_port(s), geom.cell_size, 21)
    fields = TS.particle_fields(bridge.state_to_port(d, device="cpu"))
    fields["x"] = TS.wrap_pbc(fields["x"], geom)
    NC = geom.ncells_total
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap, NC)
    xr = rebin_cuda._x_row(fmeta)
    ref_f, ref_i = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    sorted_state = TS.rebin(bridge.state_to_port(d, device="cpu"), geom,
                            use_kernel=False)
    assert torch.equal(ref_i[0] != 0, sorted_state.valid)
    plane = geom.ncells[1] * geom.ncells[2]
    planes = geom.ncells[0] // 2
    periodic = thalo.wrap_x(geom)
    for r in range(2):
        slab = thalo.slab_geometry(geom, r * planes, planes)
        gf, gi = (_ghosted(t, slab, plane, periodic) for t in (PF, PI))
        got_f, got_i = rebin_cuda.rebin_move_plain(gf, gi, geom, xr, slab)
        emu_f, emu_i = warp_walk.warp_walk(gf, gi, geom, xr, slab)
        cols = slice(r * planes * plane, (r + 1) * planes * plane)
        assert torch.equal(got_f, ref_f[..., cols]) and torch.equal(got_i, ref_i[..., cols])
        assert torch.equal(emu_f, got_f) and torch.equal(emu_i, got_i)


def test_slab_pass_a_3d_matches_unsharded():
    """Leg 8: the 3D pass A (K3's plain version) of each of 2 slabs with
    their halo planes equals the unsharded pass's columns."""
    s, p, spec = _slab_states()["cavity3d"]
    geom = spec.geom
    st = bridge.state_to_port(R.perturbed(R.f64(bridge.state_from_port(s)), 5),
                              device="cpu")
    p = bridge.params_to_port(R._Obj(R.f64(bridge.to_numpy(p))), device="cpu")
    pf = tpair._per_particle(st, p, spec.pair)
    whole = tpair._pass_a_plain(pf, p, geom, spec.pair)
    plane = geom.ncells[1] * geom.ncells[2]
    planes = geom.ncells[0] // 2
    for r in range(2):
        slab = thalo.slab_geometry(geom, r * planes, planes)
        got = tpair._pass_a_plain(
            {k: _ghosted(v, slab, plane, False) for k, v in pf.items()},
            p, slab, spec.pair)
        cols = slice(r * planes * plane, (r + 1) * planes * plane)
        for name in ("f", "drho", "ddv", "num_den", "phi", "nw"):
            a = whole[name][..., cols]
            scale = float(a.abs().max())
            assert torch.allclose(got[name], a, rtol=1e-9, atol=1e-11 * scale), name


# -- leg 9: thermo over the mesh, and the outputs that refuse a slab ---------


@pytest.mark.parametrize("case", list(THERMO))
def test_thermo_row_two_ranks_matches_jax(ranks, refs, case):
    """Leg 9: ``thermo_row`` on each of 2 slabs (the sums and extremes
    reduced over the ranks, the virial press on the ghosted slabs) is JAX's
    row of the whole perturbed state on both ranks, every column to rtol
    1e-9 and step, n and overflow equal; a ``Halt`` and a ``ThermoLogger``
    on the mesh read the same row (the ``Halt``'s, with no geometry, has
    the Tait ``press``)."""
    want = refs(f"thermo_{case}")
    for r in range(2):
        got = _load(ranks, f"thermo_{r}")
        for src in ("row", "halt", "logger"):
            for k in ("step", "n", "overflow"):
                assert int(got[f"{case}_{src}_{k}"]) == want[k], (src, k)
            for k, v in want.items():
                if src == "halt" and k in ("press", "etotal"):
                    v = want["press_tait"] if k == "press" else want["ke"]
                assert float(got[f"{case}_{src}_{k}"]) == pytest.approx(
                    v, rel=1e-9, abs=1e-300), (src, k)
    assert want["press"] != want["press_tait"]


def test_slab_outputs_refuse_without_the_mesh(tmp_path):
    """A slab reaches no output that would read one rank's particles as the
    whole grid's: ``gather_particles``, ``checkpoint.save``, ``Restart``,
    ``dump_state`` and ``gather_compute`` of a slab without ``mesh=``
    raise and write nothing, as does ``simulate`` under a mesh with a
    ``ThermoLogger`` or ``Halt`` of no mesh; the slabs are cut along x
    only, and NCCL refuses a host tensor."""
    s, p, spec = R.cavity(tlid, device="cpu")
    mesh = tmesh.Mesh(group=None, backend="gloo", rank=0, size=2,
                      device=torch.device("cpu"), ranks=(0, 1))
    slab = tmesh.shard_state(s, mesh, spec.geom)
    assert slab.valid.shape[-1] * 2 == spec.geom.ncells_total
    with pytest.raises(ValueError, match="slab"):
        TS.gather_particles(slab, spec.geom)
    with pytest.raises(ValueError, match="slab"):
        tcheckpoint.save(str(tmp_path / "c.npz"), slab, spec.geom)
    with pytest.raises(ValueError, match="slab"):
        tcheckpoint.Restart(1, str(tmp_path / "r{step}.npz"), spec.geom)(slab)
    with pytest.raises(ValueError, match="slab"):
        tvtk.dump_state(str(tmp_path / "f.vtk"), slab, spec.geom)
    with pytest.raises(ValueError, match="slab"):
        tcomputes.gather_compute(slab, spec.geom, "rho")
    assert not list(tmp_path.iterdir())
    mspec = dataclasses.replace(spec, mesh=mesh)
    for cb in (tthermo.ThermoLogger(p), tthermo.Halt(lambda row: True, p)):
        with pytest.raises(ValueError, match="spec.mesh"):
            tstepper.simulate(slab, p, mspec, 5, callback=cb)
    with pytest.raises(ValueError, match="along x"):
        tmesh.make_mesh(axis="y")
    nccl = dataclasses.replace(mesh, backend="nccl")
    with pytest.raises(ValueError, match="NCCL"):
        thalo._stage(torch.zeros(3), nccl)
