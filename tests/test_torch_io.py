"""The PyTorch port's output and restart against the JAX package.

``sph_bvf_tpu_torch/io/vtk.py`` writes byte for byte what
``sph_bvf_tpu/io/vtk.py`` writes from the same host arrays (legacy ASCII
and binary, native and Python, XML PolyData and UnstructuredGrid, their
parallel collections, the bounding box, ``dump custom`` and
``dump_state``), and both readers read the same; ``core/computes.py``
gathers every registered compute as the JAX package's does from one
bridged state; ``io/checkpoint.py`` files cross between the packages (the
PRNG key's uint32 words kept bit for bit), refuse a wrong geometry,
rebuild a periodic one, are written at the ``Restart`` cadence, and a
resume from step 10 of a 20-step f64 run is bitwise the uninterrupted run.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.core import computes as jcomputes
from sph_bvf_tpu.core import state as JS
from sph_bvf_tpu.io import checkpoint as jcheckpoint
from sph_bvf_tpu.io import vtk as jvtk
from sph_bvf_tpu.models import lid_cavity as jlid
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.core import computes as tcomputes
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.io import checkpoint as tcheckpoint
from sph_bvf_tpu_torch.io import vtk as tvtk
from sph_bvf_tpu_torch.models import lid_cavity as tlid
from sph_bvf_tpu_torch.models import lid_cavity3d as tlid3

# the key words of the states below: both above 2^31, so a signed or
# narrowed conversion would show
KEY = (0xDEADBEEF, 0x9E3779B9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers' OpenMP pools otherwise starve one another)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(cls, arrays):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in arrays.items()})


def _sample(n=203):
    """Seeded points and point data: int and float scalars, a float64
    scalar and a vector (the writers' Python path)."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    pd = {
        "id": np.arange(1, n + 1, dtype=np.int32),
        "type": rng.integers(1, 3, n).astype(np.int32),
        "c_rhoatom": rng.uniform(0.9, 1.1, n).astype(np.float32),
        "c_patom": rng.normal(0.0, 1e-3, n),
        "vel": rng.normal(0.0, 1.0, (n, 3)).astype(np.float32),
    }
    return pts, pd


def _scalars(pd):
    """The 1D entries: the native writer's input (a vector sends the whole
    call down the Python path)."""
    return {k: v for k, v in pd.items() if v.ndim == 1}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


WRITES = {
    "vtk_ascii": lambda m, p, x, d: m.write_vtk(p, x, d, native=False),
    "vtk_binary": lambda m, p, x, d: m.write_vtk(p, x, d, binary=True,
                                                 native=False),
    "vtk_native_ascii": lambda m, p, x, d: m.write_vtk(p, x, _scalars(d)),
    "vtk_native_binary": lambda m, p, x, d: m.write_vtk(p, x, _scalars(d),
                                                        binary=True),
    "vtp_ascii": lambda m, p, x, d: m.write_vtp(p, x, d),
    "vtp_binary": lambda m, p, x, d: m.write_vtp(p, x, d, binary=True),
    "vtu_ascii": lambda m, p, x, d: m.write_vtu(p, x, d),
    "vtu_binary": lambda m, p, x, d: m.write_vtu(p, x, d, binary=True),
    "pvtp": lambda m, p, x, d: m.write_pvtp(p, x, d),
    "pvtu": lambda m, p, x, d: m.write_pvtu(p, x, d, binary=True),
}
EXT = {"vtk": ".vtk", "vtp": ".vtp", "vtu": ".vtu", "pvtp": ".pvtp",
       "pvtu": ".pvtu"}


def _private_jax_native(tmp_path, monkeypatch):
    """Point the JAX package's native writer at a library compiled here,
    into this test's own directory, and forget any earlier load (restored
    afterwards).  Its loader compiles in place under a fixed name, which
    parallel test workers share: a worker may load another's half-written
    library and then fall back to the Python writer for good.  Its own
    loader, on a private copy of its source, cannot race."""
    src = os.path.join(os.path.dirname(jvtk.__file__), "native", "vtkio.cpp")
    native = tmp_path / "jax_native"
    native.mkdir()
    (native / "vtkio.cpp").write_bytes(_read(src))
    monkeypatch.setattr(jvtk, "_NATIVE_DIR", str(native))
    monkeypatch.setattr(jvtk, "_native_lib", None)
    monkeypatch.setattr(jvtk, "_native_tried", False)


@pytest.mark.parametrize("kind", list(WRITES))
def test_writer_bytes_match_jax(tmp_path, monkeypatch, kind):
    """Each writer, port vs JAX package, on the same seeded arrays: the
    files (and a collection's piece) equal byte for byte.  The native
    cases take both packages' native writers (their ASCII differs from the
    Python writers' in its float formatting)."""
    pts, pd = _sample()
    ext = EXT[kind.split("_")[0]]
    if "native" in kind:
        _private_jax_native(tmp_path, monkeypatch)
        assert jvtk._load_native() is not None
        assert tvtk._load_native() is not None
    names = []
    for pkg, mod in (("jax", jvtk), ("torch", tvtk)):
        os.makedirs(tmp_path / pkg)
        path = str(tmp_path / pkg / f"frame{ext}")
        WRITES[kind](mod, path, pts, pd)
        names.append(sorted(os.listdir(tmp_path / pkg)))
    assert names[0] == names[1] and len(names[0]) == (2 if "pv" in kind else 1)
    for name in names[0]:
        a, b = _read(tmp_path / "jax" / name), _read(tmp_path / "torch" / name)
        assert len(a) > 100 and a == b, name


@pytest.mark.parametrize("ext", [".vtk", ".vtp", ".vtu", ".pvtp", ".pvtu"])
def test_write_auto_bytes_match_jax(tmp_path, ext):
    """``write_auto`` dispatches on the extension as the JAX package's
    does: the same bytes for every extension."""
    pts, pd = _sample(37)
    for pkg, mod in (("jax", jvtk), ("torch", tvtk)):
        os.makedirs(tmp_path / pkg)
        mod.write_auto(str(tmp_path / pkg / f"f{ext}"), pts, pd)
    for name in os.listdir(tmp_path / "jax"):
        assert _read(tmp_path / "jax" / name) == _read(tmp_path / "torch" / name)


@pytest.mark.parametrize("ext", [".vtk", ".vtr"])
def test_bounding_box_bytes_match_jax(tmp_path, ext):
    """The companion domain grid, legacy and XML: the same bytes."""
    lo, hi = (-0.03, 0.0, -0.03), (1.03, 1.0, 1.03)
    a, b = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
    jvtk.write_bounding_box(a, lo, hi)
    tvtk.write_bounding_box(b, lo, hi)
    assert _read(a) == _read(b)


def _state_arrays():
    """The JAX-built N=10 cavity as numpy, with every field a compute reads
    seeded from numpy (one species C, one SSA count Cd, S, Pnew, phi, e,
    num_den), a nonzero step and dt, and the key words KEY."""
    js, jp, jspec, _ = jlid.build(N=10)
    s = bridge.to_numpy(js)
    rng = np.random.default_rng(5)
    valid = s["valid"]
    shape = valid.shape
    f32 = lambda a: np.where(valid, a, 0.0).astype(np.float32)
    s["v"] = f32(rng.normal(0, 0.1, (3,) + shape))
    s["C"] = f32(rng.uniform(0, 1, (1,) + shape))
    s["Q"] = np.zeros_like(s["C"])
    s["Cd"] = np.where(valid, rng.integers(0, 50, (1,) + shape), 0).astype(np.int32)
    s["Qd"] = np.zeros_like(s["Cd"])
    s["S"] = f32(rng.normal(0, 1, (3, 3) + shape))
    s["Pnew"] = f32(rng.normal(0, 1, shape))
    s["phi"] = f32(rng.uniform(0, 1, shape))
    s["e"] = f32(rng.uniform(0, 1, shape))
    s["num_den"] = np.where(valid, rng.uniform(0.5, 1.5, shape), 1.0).astype(np.float32)
    s["step"] = np.asarray(7, np.int32)
    s["dt"] = np.asarray(1e-4, np.float32)
    s["key"] = np.asarray(KEY, np.uint32)
    return s, jp, jspec


COMPUTES = [("rho",), ("phi",), ("solid_tag",), ("C", 0), ("Cd", 0), ("e",),
            ("p",), ("number_density",)] + [
    ("stress", m, n) for m in range(3) for n in range(3)]


def test_computes_registry_matches_jax():
    """The same computes under the same names, each with its index count."""
    assert {k: v[1] for k, v in tcomputes.REGISTRY.items()} == \
        {k: v[1] for k, v in jcomputes.REGISTRY.items()}
    assert {c[0] for c in COMPUTES} == set(tcomputes.REGISTRY)


@pytest.mark.parametrize("which", COMPUTES, ids=["/".join(map(str, c))
                                                 for c in COMPUTES])
def test_gather_compute_matches_jax(which):
    """``gather_compute`` of every registered compute, port vs JAX, on one
    bridged state: tag-sorted host arrays equal, dtype included; a wrong
    index count raises in both."""
    s, _, jspec = _state_arrays()
    tg = TS.Geometry(**dataclasses.asdict(jspec.geom))
    name, *idx = which
    a = jcomputes.gather_compute(_jax(JS.State, s), jspec.geom, name, *idx)
    b = tcomputes.gather_compute(bridge.state_to_port(s, device="cpu"), tg,
                                 name, *idx)
    assert a.dtype == b.dtype and a.shape == b.shape == (int(s["valid"].sum()),)
    np.testing.assert_array_equal(a, b)
    assert np.abs(b).max() > 0
    with pytest.raises(ValueError, match="indices"):
        tcomputes.compute(bridge.state_to_port(s, device="cpu"), name, *idx, 0)


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
def test_dump_state_bytes_match_jax(tmp_path, binary):
    """``dump_state`` of one bridged state (DumpVTK field names, valid
    particles by tag): the same bytes; the ASCII frame reads back with both
    readers alike, points and fields by tag."""
    s, _, jspec = _state_arrays()
    tg = TS.Geometry(**dataclasses.asdict(jspec.geom))
    fields = ("v", "rho", "phi", "C")
    a, b = str(tmp_path / "j.vtk"), str(tmp_path / "t.vtk")
    jvtk.dump_state(a, _jax(JS.State, s), jspec.geom, fields, binary=binary)
    tvtk.dump_state(b, bridge.state_to_port(s, device="cpu"), tg, fields,
                    binary=binary)
    assert _read(a) == _read(b)
    if binary:
        return
    (pa, da), (pb, db) = jvtk.read_vtk(a), tvtk.read_vtk(b)
    np.testing.assert_array_equal(pa, pb)
    assert sorted(da) == sorted(db) == sorted(
        ["id", "type", "vx", "vy", "vz", "c_rhoatom", "c_phiatom", "c_C0"])
    for k in da:
        np.testing.assert_array_equal(da[k], db[k])
    n = int(s["valid"].sum())
    assert pb.shape == (n, 3)
    np.testing.assert_array_equal(db["id"], np.arange(1, n + 1))


def test_read_vtk_round_trips(tmp_path):
    """A frame the port writes reads back (points and scalars to the
    writer's 9 significant digits), as the JAX reader reads it."""
    pts, pd = _sample()
    path = str(tmp_path / "a.vtk")
    tvtk.write_vtk(path, pts, pd, native=False)
    rpts, rdata = tvtk.read_vtk(path)
    np.testing.assert_allclose(rpts, pts, atol=1e-6)
    for k in pd:
        np.testing.assert_allclose(rdata[k], pd[k], atol=1e-6)
    jpts, jdata = jvtk.read_vtk(path)
    np.testing.assert_array_equal(jpts, rpts)
    for k in pd:
        np.testing.assert_array_equal(jdata[k], rdata[k])


def test_write_dump_custom_bytes_match_jax(tmp_path):
    """LAMMPS ``dump custom`` text of one gathered frame: the same bytes."""
    s, _, jspec = _state_arrays()
    tg = TS.Geometry(**dataclasses.asdict(jspec.geom))
    st = bridge.state_to_port(s, device="cpu")
    out = TS.gather_particles(st, tg, ("x", "v", "ptype"))
    pd = {"id": out["tag"], "type": out["ptype"] + 1, "x": out["x"][:, 0],
          "y": out["x"][:, 1], "vx": out["v"][:, 0],
          "c_rhoatom": tcomputes.gather_compute(st, tg, "rho")}
    cols = ("id", "type", "x", "y", "vx", "c_rhoatom")
    a, b = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jvtk.write_dump_custom(a, 7, jspec.geom, cols, out["x"], pd)
    tvtk.write_dump_custom(b, 7, tg, cols, out["x"], pd)
    assert _read(a) == _read(b)
    assert _read(b).startswith(b"ITEM: TIMESTEP\n7\n")


def _port_state(s):
    return bridge.state_to_port(s, device="cpu")


def _assert_states_equal(a: dict, b: dict):
    """Every field of two numpy states bitwise, dtypes included."""
    assert sorted(a) == sorted(b)
    for name in a:
        assert np.asarray(a[name]).dtype == np.asarray(b[name]).dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_checkpoint_round_trip_bitwise(tmp_path):
    """Port save, port load: every field bitwise, the key's two words (both
    above 2^31) included, on the device asked for."""
    s, _, jspec = _state_arrays()
    tg = TS.Geometry(**dataclasses.asdict(jspec.geom))
    st = _port_state(s)
    path = str(tmp_path / "ck.npz")
    tcheckpoint.save(path, st, tg)
    back = tcheckpoint.load(path, tg, device="cpu")
    assert back.key.dtype == torch.int64 and back.key.tolist() == list(KEY)
    assert back.x.device.type == "cpu"
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(back, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    with np.load(path) as z:
        assert z["key"].dtype == np.uint32  # the JAX package's key words


def test_checkpoint_from_jax_loads_in_port(tmp_path):
    """A file the JAX package's ``save`` writes loads in the port: equal,
    field for field, to the same state carried by the bridge."""
    s, _, jspec = _state_arrays()
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, _jax(JS.State, s), jspec.geom)
    tg = TS.Geometry(**dataclasses.asdict(jspec.geom))
    got = bridge.state_from_port(tcheckpoint.load(path, tg, device="cpu"))
    _assert_states_equal(got, bridge.state_from_port(_port_state(s)))
    _assert_states_equal(got, s)


def test_checkpoint_from_port_loads_in_jax(tmp_path):
    """A file the port's ``save`` writes loads in the JAX package: equal,
    field for field, to the state the port saved."""
    s, _, jspec = _state_arrays()
    tg = TS.Geometry(**dataclasses.asdict(jspec.geom))
    path = str(tmp_path / "port.npz")
    tcheckpoint.save(path, _port_state(s), tg)
    got = bridge.to_numpy(jcheckpoint.load(path, jspec.geom))
    _assert_states_equal(got, s)


def test_checkpoint_geometry_mismatch(tmp_path):
    """Loading into a geometry of another cap, cell count or dimension
    raises, as the JAX package's ``load`` does."""
    state, _, spec, _ = tlid.build(N=10, device="cpu")
    path = str(tmp_path / "ck.npz")
    tcheckpoint.save(path, state, spec.geom)
    for bad in (dict(cap=spec.geom.cap + 1),
                dict(ncells=(spec.geom.ncells[0] + 1,) + spec.geom.ncells[1:]),
                dict(dim=3)):
        other = dataclasses.replace(spec.geom, **bad)
        with pytest.raises(ValueError, match="geometry mismatch"):
            tcheckpoint.load(path, other, device="cpu")


def test_load_with_geometry_rebuilds_periodic_geom(tmp_path):
    """read_restart analog on the spanwise-periodic 3D cavity: the port and
    the JAX package rebuild the port's geometry, periodic axis included,
    from the file alone."""
    state, _, spec, _ = tlid3.build_spanwise(12, device="cpu")
    path = str(tmp_path / "ck.npz")
    tcheckpoint.save(path, state, spec.geom)
    back, geom = tcheckpoint.load_with_geometry(path, device="cpu")
    assert geom == spec.geom and geom.periodic == (False, True, False)
    assert torch.equal(back.x, state.x) and torch.equal(back.tag, state.tag)
    _, jgeom = jcheckpoint.load_with_geometry(path)
    assert dataclasses.asdict(jgeom) == dataclasses.asdict(spec.geom)


def _f64_cavity(N=10):
    """The port's N-cavity on the CPU, state and params cast to f64."""
    state, params, spec, _ = tlid.build(N=N, rebin_every=5, device="cpu")
    as64 = lambda obj: dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).double()
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
        and getattr(obj, f.name).is_floating_point()})
    return as64(state), as64(params), spec


def test_restart_writes_at_its_cadence(tmp_path):
    """``Restart(every=10)`` as the callback of a 30-step run in chunks of
    5 writes the steps 10, 20 and 30, and nothing between."""
    state, params, spec, _ = tlid.build(N=10, rebin_every=5, device="cpu")
    template = str(tmp_path / "restart_{step}.npz")
    restart = tcheckpoint.Restart(10, template, spec.geom)
    state = tstepper.simulate(tstepper.setup(state, params, spec, dt=1e-4),
                              params, spec, 30, callback=restart)
    assert sorted(os.listdir(tmp_path)) == [
        f"restart_{k}.npz" for k in (10, 20, 30)]
    last = tcheckpoint.load(template.format(step=30), spec.geom, device="cpu")
    assert int(last.step) == 30 and torch.equal(last.x, state.x)


def test_resume_is_bitwise(tmp_path):
    """20 steps at f64 straight, against 10 steps, a ``Restart`` file at
    step 10 and 10 steps from that file: every field bitwise (the filter
    at step 20 follows the loaded step)."""
    state, params, spec = _f64_cavity()
    state = tstepper.setup(state, params, spec, dt=1e-4)
    straight = tstepper.simulate(state, params, spec, 20)
    template = str(tmp_path / "r_{step}.npz")
    tstepper.simulate(state, params, spec, 10,
                      callback=tcheckpoint.Restart(10, template, spec.geom))
    resumed = tcheckpoint.load(template.format(step=10), spec.geom,
                               device="cpu")
    assert int(resumed.step) == 10 and resumed.x.dtype == torch.float64
    resumed = tstepper.simulate(resumed, params, spec, 10)
    for f in dataclasses.fields(straight):
        a, b = getattr(straight, f.name), getattr(resumed, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    assert int(straight.step) == 20 and float(straight.v.abs().max()) > 0
