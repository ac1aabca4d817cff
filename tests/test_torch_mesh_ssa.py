"""The port's x-slab mesh on the stochastic species, pass B and the outputs,
on CPU ranks over gloo, against the JAX package.

One group of 2 ranks (``tests/torch_mesh_ranks.ssa_legs``, which imports
no JAX) runs the lid-driven cavity with a stochastic species
(``examples/lid_cavity_ssa.lmp`` at N=16, its x cells a multiple of 2), as
written and under the zhang integrator (which adds pass B), at f64, while
this process runs the JAX package's unsharded jnp path on the same inputs
(GSPMD makes the JAX package's sharded result its unsharded one); the
legs then compare:

1. ``compute_forces`` on 2 slabs of a perturbed state: Qd exactly JAX's
   (the draws are keyed by the pair's tags, species, step and seed),
   ``vws``/``aws`` to rtol 1e-9; ``compute_ssa_mu_max(mesh=)`` and
   ``gather_compute(mesh=)``;
2. setup and two chunks at 2 ranks: Cd exactly JAX's, x, v and rho by tag
   within 1e-8, overflow and drift 0;
3. ``Restart(mesh=)``: one file a period, every array the single-device
   ``save`` of the gathered state, within 1e-8 of JAX's ``save`` at the
   same step (ints equal); ``load`` then ``shard_state`` resumes bitwise;
   ``dump_state(mesh=)``'s frame byte for byte the single-device frame;
4. here, with no ranks: Qd (the card's ``_pass_a_qd``), pass B and the
   largest hop mean on each slab with its halo planes against the
   unsharded pass's columns, and the reactions on a slab against the
   whole grid's (``tests/test_torch_mesh.py`` holds the outputs that
   refuse a slab without ``mesh=``).
"""

import concurrent.futures
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from sph_bvf_tpu.api import lmp as jlmp
from sph_bvf_tpu.core import computes as jcomputes
from sph_bvf_tpu.core import state as JS
from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.io import checkpoint as jcheckpoint
from sph_bvf_tpu.ops import pair as jpair
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.api import lmp as tlmp
from sph_bvf_tpu_torch.core import halo as thalo
from sph_bvf_tpu_torch.core import ssa as tssa
from sph_bvf_tpu_torch.ops import pair as tpair
from sph_bvf_tpu_torch.parallel import launch
from sph_bvf_tpu_torch.parallel import mesh as tmesh
from test_torch_mesh import _by_tag, _ghosted, _jax

CASES = list(R.SSA_CASES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the 2-rank group at once (it runs beside this process's JAX
    runs); ``ranks()`` waits for it and returns its output directory."""
    out = tmp_path_factory.mktemp("mesh_ssa")
    failed = []

    def run():
        try:
            launch.spawn(R.ssa_legs, 2, "gloo", str(out / "init"),
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


def _jax_model(case):
    """The case's script built by the JAX package: (model, f64 numpy state,
    f64 numpy params, spec on the jnp path)."""
    model = R.ssa_model(jlmp, case)
    js, jp, jspec = model.build()
    jspec = dataclasses.replace(jspec, pair=dataclasses.replace(
        jspec.pair, use_pallas=False))
    return model, R.f64(bridge.to_numpy(js)), R.f64(bridge.to_numpy(jp)), jspec


_forces = jax.jit(jpair.compute_forces, static_argnames=("geom", "cfg"))


def _jax_forces(case):
    """Leg 1's JAX side: compute_forces, the largest hop mean and the
    computes of the perturbed state."""
    _, s, p, jspec = _jax_model(case)
    s = R.perturbed(s, 3)
    js, jp = _jax(JS.State, s), _jax(JS.Params, p)
    out = _forces(js, jp, jspec.geom, jspec.pair)
    mu = float(jpair.compute_ssa_mu_max(js, jp, jspec.geom, jspec.pair))
    comp = {f"compute_{name}{''.join(map(str, idx))}":
            np.asarray(jcomputes.gather_compute(out, jspec.geom, name, *idx))
            for name, idx in R.SSA_COMPUTES}
    return bridge.to_numpy(out), mu, comp


def _jax_run(case, tmp):
    """Legs 2 and 3's JAX side: setup and SSA_STEPS steps, its ``save`` at
    step SSA_EVERY; (the final state, the step-SSA_EVERY file)."""
    model, s, p, jspec = _jax_model(case)
    js, jp = _jax(JS.State, s), _jax(JS.Params, p)
    path = str(tmp / f"jax_{case}_{R.SSA_EVERY}.npz")

    def callback(state):
        if int(state.step) == R.SSA_EVERY:
            jcheckpoint.save(path, state, jspec.geom)

    js = jstepper.simulate(jstepper.setup(js, jp, jspec, dt=model.dt), jp,
                           jspec, R.SSA_STEPS, callback=callback)
    return bridge.to_numpy(js), path


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The JAX package's side of every leg, in threads beside the ranks."""
    tmp = tmp_path_factory.mktemp("mesh_ssa_jax")
    jobs = {}
    for case in CASES:
        jobs[f"run_{case}"] = lambda c=case: _jax_run(c, tmp)
        jobs[f"forces_{case}"] = lambda c=case: _jax_forces(c)
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {k: pool.submit(f) for k, f in jobs.items()}
    yield lambda k: futures[k].result()
    pool.shutdown(wait=True)


def _close(got, want, name, rtol):
    scale = max(float(np.abs(want).max()), 1e-300)
    tol = rtol * np.abs(want) + 1e-11 * scale
    assert (np.abs(got - want) <= tol).all(), (name, float(np.abs(got - want).max()))


@pytest.mark.parametrize("case", CASES)
def test_ssa_forces_on_two_slabs_match_jax(ranks, refs, case):
    """Leg 1: Qd of 2 slabs, joined, exactly JAX's unsharded Qd on the
    same perturbed state, ``vws``/``aws`` (zero but under zhang) and f to
    rtol 1e-9; ``compute_ssa_mu_max(mesh=)`` on each rank JAX's, exactly."""
    ref, mu, _ = refs(f"forces_{case}")
    got = _load(ranks, f"ssa_forces_{case}")
    np.testing.assert_array_equal(got["tag"], ref["tag"])
    np.testing.assert_array_equal(got["Qd"], ref["Qd"])
    assert int(np.abs(got["Qd"]).max()) > 0
    for name in ("f", "vws", "aws"):
        _close(got[name], ref[name], name, 1e-9)
    assert (float(np.abs(got["vws"]).max()) > 0) == (case == "zhang")
    assert float(got["mu"]) == mu and 0.0 < mu < 0.3


@pytest.mark.parametrize("case", CASES)
def test_gather_compute_two_ranks_matches_jax(ranks, refs, case):
    """Leg 1: ``gather_compute(mesh=)`` of the forces' state on 2 slabs is
    JAX's ``gather_compute`` of the whole state on every compute of
    ``SSA_COMPUTES``, tag-sorted, rtol 1e-9."""
    _, _, comp = refs(f"forces_{case}")
    got = _load(ranks, f"ssa_forces_{case}")
    for name, want in comp.items():
        assert got[name].shape == want.shape, name
        _close(got[name], want, name, 1e-9)


@pytest.mark.parametrize("case", CASES)
def test_ssa_runs_two_ranks_match_jax(ranks, refs, case):
    """Leg 2: setup and two chunks (20 steps, the reactions and the hops
    on the slabs) at 2 ranks against JAX's unsharded run: the slots and Cd
    exactly, x, v and rho by tag within 1e-8, overflow and drift 0, the
    molecules moved."""
    a, _ = refs(f"run_{case}")
    b = _load(ranks, f"ssa_run_{case}")
    assert int(b["step"]) == R.SSA_STEPS
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    for name in ("tag", "valid", "Cd", "Qd"):
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    for name in ("x", "v", "rho"):
        np.testing.assert_allclose(_by_tag(b, name), _by_tag(a, name), rtol=0,
                                   atol=1e-8, err_msg=name)
    s0 = R.ssa_model(tlmp, case).build(device="cpu")[0]
    assert not np.array_equal(b["Cd"], bridge.state_from_port(s0)["Cd"])


@pytest.mark.parametrize("case", CASES)
def test_restart_two_ranks_writes_the_single_file(ranks, refs, case):
    """Leg 3: ``Restart(mesh=)`` every 10 steps writes one file a period
    (steps 10 and 20); every array of the step-10 file is the
    single-device ``save`` of the gathered state, bitwise, and JAX's
    ``save`` at step 10: the dtypes (JAX's drift count aside) and the ints
    and bools equal, the floats within 1e-8 of each field's largest
    magnitude (at least 1)."""
    out = ranks()
    files = sorted(p.name for p in out.glob(f"ckpt_{case}_*.npz"))
    assert files == [f"ckpt_{case}_{s}.npz"
                     for s in sorted((R.SSA_EVERY, R.SSA_STEPS), key=str)]
    _, jax_file = refs(f"run_{case}")
    got = dict(np.load(out / f"ckpt_{case}_{R.SSA_EVERY}.npz"))
    single = dict(np.load(out / f"single_{case}_{R.SSA_EVERY}.npz"))
    want = dict(np.load(jax_file))
    assert sorted(got) == sorted(single) == sorted(want)
    for name, a in got.items():
        np.testing.assert_array_equal(a, single[name], err_msg=name)
        b = want[name]
        if name == "__meta__":
            continue
        # the port keeps its counters i32; JAX's drift count is i64 when
        # x64 is on (its sum's promotion): the kinds, and the values, agree
        assert a.dtype.kind == b.dtype.kind and a.shape == b.shape, name
        assert a.dtype == b.dtype or name == "drift_violation", name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-8 * max(1.0, float(np.abs(b).max(initial=0.0))),
                err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(got["step"]) == R.SSA_EVERY


@pytest.mark.parametrize("case", CASES)
def test_resume_two_ranks_is_bitwise(ranks, case):
    """Leg 3: every rank's ``load`` of the step-10 file, ``shard_state``
    and 10 more steps equal the uninterrupted 2-rank run, every leaf
    bitwise."""
    run = _load(ranks, f"ssa_run_{case}")
    back = _load(ranks, f"ssa_resumed_{case}")
    assert sorted(run) == sorted(back)
    for name, a in run.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_frame_two_ranks_is_the_single_frame(ranks, case):
    """Leg 3: ``dump_state(mesh=)`` of the final slabs writes, from rank 0,
    the single-device frame of the gathered state, byte for byte
    (``tests/test_torch_io.py`` holds that writer to JAX's)."""
    out = ranks()
    a = (out / f"frame_mesh_{case}.vtk").read_bytes()
    b = (out / f"frame_single_{case}.vtk").read_bytes()
    assert a == b and b"c_Cd0" in a


# -- leg 4: the slab passes, with no ranks -----------------------------------


def _slab_inputs(case):
    """The perturbed f64 state of the case's script (port objects), its
    params, spec and forces' state."""
    s, p, spec = R.ssa_model(tlmp, case).build(device="cpu")
    st = bridge.state_to_port(R.perturbed(R.f64(bridge.state_from_port(s)), 5),
                              device="cpu")
    pa = bridge.params_to_port(R._Obj(R.f64(bridge.to_numpy(p))), device="cpu")
    return st, pa, spec, tpair.compute_forces(st, pa, spec.geom, spec.pair)


@pytest.mark.parametrize("case", CASES)
def test_slab_qd_pass_b_and_mu_are_the_unsharded_columns(case):
    """Leg 4: on each of 2 slabs with their halo planes (as the exchange
    builds them), the card's Qd pass (``_pass_a_qd``, after a kernel) and
    the plain pass's inline draws equal the unsharded Qd's columns,
    exactly; pass B on the ghosted f/m equals the unsharded pass B's
    columns to rtol 1e-9; the largest hop mean of the slabs' own pairs,
    the larger of the two, is the unsharded one, exactly."""
    st, pa, spec, whole = _slab_inputs(case)
    geom, cfg = spec.geom, spec.pair
    pf = tpair._per_particle(st, pa, cfg)
    noise = tpair.noise_inputs(st)
    qd = tpair._pass_a_qd(pf, pa, geom, cfg, noise)
    assert torch.equal(qd, whole.Qd) and int(qd.abs().max()) > 0
    fom = whole.f / pf["m"][None]
    plane = geom.ncells[1] * geom.ncells[2]
    planes = geom.ncells[0] // 2
    mus = []
    for r in range(2):
        slab = thalo.slab_geometry(geom, r * planes, planes)
        gh = {k: _ghosted(v, slab, plane, False) for k, v in pf.items()}
        cols = slice(r * planes * plane, (r + 1) * planes * plane)
        got = tpair._pass_a_qd(gh, pa, slab, cfg, noise, max_pair_slots=1 << 12)
        assert torch.equal(got, whole.Qd[..., cols])
        inline = tpair._pass_a_plain(gh, pa, slab, cfg, noise)["Qd"]
        assert torch.equal(inline, whole.Qd[..., cols])
        if cfg.weighted_solid:
            b = tpair._pass_b(gh, _ghosted(fom, slab, plane, False), pa, slab, cfg)
            for name in ("vws", "aws"):
                want = getattr(whole, name)[..., cols]
                scale = float(getattr(whole, name).abs().max())
                assert scale > 0 and torch.allclose(
                    b[name], want, rtol=1e-9, atol=1e-11 * scale), name
        mus.append(float(tpair._mu_max(
            {k: gh[k] for k in tpair._MU_FIELDS}, pa, slab, cfg, st.dt)))
    assert max(mus) == float(tpair.compute_ssa_mu_max(st, pa, geom, cfg))


def test_ssa_reactions_on_a_slab_are_the_whole_grids():
    """Leg 4: the reactions (``ssa_reactions``, per particle and keyed by
    tag) of each of 2 slabs equal the whole grid's columns, bitwise; the
    decay fired."""
    st, pa, spec, _ = _slab_inputs("ssa")
    ssa = spec.ssa
    assert ssa is not None and ssa.reactions
    whole = tssa.ssa_reactions(st, pa, ssa)
    assert not torch.equal(whole.Cd, st.Cd)
    for r in range(2):
        mesh = tmesh.Mesh(group=None, backend="gloo", rank=r, size=2,
                          device=torch.device("cpu"), ranks=(0, 1))
        part = tssa.ssa_reactions(tmesh.shard_state(st, mesh, spec.geom), pa, ssa)
        n = st.valid.shape[-1] // 2
        assert torch.equal(part.Cd, whole.Cd[..., r * n:(r + 1) * n])
