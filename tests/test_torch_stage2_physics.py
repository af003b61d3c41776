"""The port's physics providers (holoscene_tpu_torch/physics) and scene
graph (holoscene_tpu_torch/stage2/scene_graph.py) against the JAX
package's on the same numpy meshes: host code (numpy, scipy, mujoco), so
the results are equal — bitwise for the stability results, graphs and
inside tests, within 1e-6 for the translations (the port's inside test
finds the candidate (point, face) pairs through a y/z grid instead of a
dense broadcast; the pairs, and so the sums, are the same). MuJoCo runs
where it imports; the quasi-static oracle always."""

import numpy as np
import pytest
from torch_stage2_cases import box

import holoscene_tpu.physics.sim as jsim
import holoscene_tpu.stage2.scene_graph as jsg
import holoscene_tpu_torch.physics.sim as tsim
import holoscene_tpu_torch.stage2.scene_graph as tsg
from holoscene_tpu.utils.mesh import Mesh as JMesh
from holoscene_tpu_torch.utils.mesh import Mesh as TMesh

try:
    import mujoco  # noqa: F401
    PROVIDERS = ("quasistatic", "mujoco")
except ImportError:
    PROVIDERS = ("quasistatic",)


def _pair(v, f):
    return JMesh(np.asarray(v, np.float64), np.asarray(f)), \
        TMesh(np.asarray(v, np.float64), np.asarray(f))


def _scene():
    """(JAX meshes, port meshes): a floor slab, a box resting on it, a box
    hovering above it, and a box overhanging the floor's edge (y down)."""
    parts = [box((0, 0.55, 0), (1.0, 0.05, 1.0)),
             box((0, 0.3, 0), (0.2, 0.2, 0.2)),
             box((0.5, -0.3, 0.3), (0.1, 0.1, 0.1)),
             box((1.05, 0.4, 0.0), (0.2, 0.1, 0.2))]
    pairs = [_pair(v, f) for v, f in parts]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _same_result(a, b):
    assert a.drift_deg == b.drift_deg and a.stable == b.stable
    np.testing.assert_array_equal(a.translation, b.translation)


@pytest.mark.parametrize("provider", PROVIDERS)
def test_sim_validation_and_scene_match_jax(monkeypatch, provider):
    monkeypatch.setenv("HOLOSCENE_PHYSICS", provider)
    monkeypatch.setattr(jsim, "_PROVIDER", None)
    monkeypatch.setattr(tsim, "_PROVIDER", None)
    jm, tm = _scene()
    for cand in (1, 2, 3):
        _same_result(jsim.sim_validation([jm[0], jm[cand]]),
                     tsim.sim_validation([tm[0], tm[cand]]))
    for a, b in zip(jsim.sim_scene(jm), tsim.sim_scene(tm)):
        _same_result(a, b)
    rep = tsim.provider_report()
    assert rep["provider"] == provider
    assert ("quasistatic_fallbacks" in rep) == (provider == "mujoco")


def test_settle_drop_matches_jax():
    jm, tm = _scene()
    for cand in (2, 3):
        np.testing.assert_array_equal(
            tsim.settle_drop(tm[cand], [tm[0]]),
            jsim.settle_drop(jm[cand], [jm[0]]))
    assert tsim.settle_drop(tm[2], [tm[0]])[1] > 0.3


def test_explicit_mujoco_without_the_package_raises(monkeypatch):
    """HOLOSCENE_PHYSICS=mujoco never downgrades silently; auto falls back
    to the quasi-static oracle and says which one runs."""
    import builtins

    real_import = builtins.__import__

    def no_mujoco(name, *a, **kw):
        if name == "mujoco":
            raise ImportError("no mujoco here")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mujoco)
    monkeypatch.setattr(tsim, "_PROVIDER", None)
    monkeypatch.setenv("HOLOSCENE_PHYSICS", "mujoco")
    with pytest.raises(ImportError):
        tsim.get_provider()
    monkeypatch.setenv("HOLOSCENE_PHYSICS", "auto")
    assert tsim.provider_report() == {"provider": "quasistatic"}


def test_points_inside_mesh_matches_jax():
    """The even-odd test on points around and inside an icosphere-like
    closed mesh and a box: the grid of candidate pairs gives the dense
    broadcast's answers."""
    from holoscene_tpu_torch.stage2.remesh import icosphere

    rng = np.random.default_rng(0)
    sphere = icosphere(0.4, (0.1, 0.0, -0.1), subdivisions=3)
    jsph = JMesh(sphere.vertices, sphere.faces)
    pts = rng.uniform(-0.6, 0.6, (3000, 3))
    got = tsg.points_inside_mesh(pts, sphere, chunk=1024)
    np.testing.assert_array_equal(got, jsg.points_inside_mesh(pts, jsph,
                                                              chunk=1024))
    assert 0.05 < got.mean() < 0.5
    jb, tb = _pair(*box((0, 0, 0), (0.3, 0.2, 0.1)))
    np.testing.assert_array_equal(tsg.points_inside_mesh(pts, tb),
                                  jsg.points_inside_mesh(pts, jb))


def test_scene_graph_and_solve_intersection_match_jax():
    """Adjacency and BFS tree from surface proximity, and the translations
    that push two interpenetrating boxes out of each other and of the
    floor."""
    parts = [box((0, 0.55, 0), (1.0, 0.05, 1.0)),
             box((0, 0.35, 0), (0.2, 0.2, 0.2)),
             box((0.25, 0.35, 0.05), (0.15, 0.15, 0.15))]
    pairs = [_pair(v, f) for v, f in parts]
    jm = [p[0] for p in pairs]
    tm = [p[1] for p in pairs]
    jg = jsg.create_scene_graph_from_meshes(jm)
    tg = tsg.create_scene_graph_from_meshes(tm)
    assert tg == jg and tg[0]["root"]
    jt = jsg.solve_intersection(jm, jg)
    tt = tsg.solve_intersection(tm, tg)
    assert set(tt) == set(jt)
    for k in jt:
        np.testing.assert_allclose(tt[k], jt[k], rtol=0, atol=1e-6)
    assert np.linalg.norm(tt[2]) > 1e-3
