"""Physical-stability validation providers (the port's own copy of
holoscene_tpu/physics/sim.py: numpy / scipy / mujoco on the host; the port
imports nothing of the JAX package). Each provider names itself (`name`),
and MuJoCoProvider counts the candidates it handed to the quasi-static
oracle (`n_fallbacks`), so a run can report which physics ran.

Reference semantics: utils/sim.py — Isaac Sim/PhysX headless simulation:
`sim_validation(mesh_list) -> max orientation drift (deg) + translation`
(all meshes static except the last, 1 s settle @ 60 Hz, :606-636; the
Stage-2 acceptance threshold is drift < 8 deg,
training/holoscene_train_post.py:767) and `sim_scene` full-scene settling
(:638-708).

Isaac Sim is CUDA/x86-specific and not available here, so validation runs
through a provider interface (`get_provider`, HOLOSCENE_PHYSICS to force):

  * `MuJoCoProvider` (default when the `mujoco` package imports) — dynamic
    rigid-body settle mirroring the reference's PhysX flow.
  * `QuasiStaticProvider` (fallback) — a dependency-free static-equilibrium
    oracle: find the candidate's support contacts against the other meshes
    (and the global up direction), build the support polygon in the gravity
    plane, and test whether the center of mass projects inside it. The
    returned "drift" is 0 when stable and the tipping angle (angle by which
    the COM overhangs the nearest support-polygon edge) when not — so the
    reference's `deg < 8` acceptance test carries over unchanged.

The quasi-static test is the physically-meaningful core of the reference's
oracle (objects whose COM is supported settle with ~0 drift in PhysX; those
that aren't tip over), without a 60 Hz solver in the loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import cKDTree

from holoscene_tpu_torch.utils.mesh import Mesh

GRAVITY_AXIS = 1  # y-down scenes (cameras normalized, y points down in CV)


@dataclasses.dataclass
class StabilityResult:
    drift_deg: float
    translation: np.ndarray
    stable: bool
    contact_points: np.ndarray | None = None


def _center_of_mass(mesh: Mesh) -> np.ndarray:
    """Surface-area-weighted centroid (uniform shell assumption)."""
    tri = mesh.vertices[mesh.faces]
    centers = tri.mean(axis=1)
    areas = mesh.face_areas
    w = areas / max(areas.sum(), 1e-12)
    return (centers * w[:, None]).sum(axis=0)


def _support_contacts(
    candidate: Mesh,
    supports: list[Mesh],
    up: np.ndarray,
    contact_eps: float,
    n_samples: int = 4000,
    seed: int = 0,
) -> np.ndarray:
    """Points of the candidate within contact_eps of any support mesh and on
    the candidate's lower (anti-up) side."""
    rng = np.random.default_rng(seed)
    pts = candidate.sample_surface(n_samples, rng)
    heights = pts @ up
    # lower band: within 15% of the candidate's extent from its lowest point
    extent = heights.max() - heights.min()
    lower = pts[heights <= heights.min() + max(0.15 * extent, contact_eps)]
    if len(lower) == 0:
        return np.zeros((0, 3))

    contacts = []
    for sup in supports:
        if sup is None or len(sup.faces) == 0:
            continue
        sup_pts = sup.sample_surface(min(20000, 4 * n_samples), rng)
        tree = cKDTree(sup_pts)
        d, _ = tree.query(lower, k=1)
        contacts.append(lower[d < contact_eps])
    if not contacts:
        return np.zeros((0, 3))
    return np.concatenate(contacts) if any(len(c) for c in contacts) else np.zeros((0, 3))


def _point_in_hull_2d(point: np.ndarray, pts: np.ndarray) -> tuple[bool, float]:
    """(inside?, signed margin to the hull boundary; >0 inside)."""
    from scipy.spatial import ConvexHull, QhullError

    if len(pts) < 3:
        if len(pts) == 0:
            return False, -np.inf
        d = np.linalg.norm(pts - point[None], axis=1).min()
        return d < 1e-3, -d
    try:
        hull = ConvexHull(pts)
    except QhullError:
        d = np.linalg.norm(pts - point[None], axis=1).min()
        return d < 1e-3, -d
    # hull.equations: [a, b, c] with a*x + b*y + c <= 0 inside
    margins = -(hull.equations[:, :2] @ point + hull.equations[:, 2])
    return bool(np.all(margins >= 0)), float(margins.min())


class QuasiStaticProvider:
    name = "quasistatic"

    def __init__(self, contact_eps: float = 0.01):
        self.contact_eps = contact_eps

    def sim_validation(self, mesh_list: list[Mesh]) -> StabilityResult:
        """mesh_list: supports..., candidate (reference sim.py:606: all
        static except last)."""
        candidate = mesh_list[-1]
        supports = [m for m in mesh_list[:-1] if m is not None]
        up = np.zeros(3)
        up[GRAVITY_AXIS] = -1.0  # y-down world: "up" is -y

        com = _center_of_mass(candidate)
        contacts = _support_contacts(
            candidate, supports, up, self.contact_eps
        )
        if len(contacts) < 3:
            # no support: treat as free fall -> unstable with max drift
            return StabilityResult(90.0, np.zeros(3), False, contacts)

        # project COM and contacts onto the gravity plane
        plane_axes = [i for i in range(3) if i != GRAVITY_AXIS]
        com_2d = com[plane_axes]
        contacts_2d = contacts[:, plane_axes]
        inside, margin = _point_in_hull_2d(com_2d, contacts_2d)
        if inside:
            return StabilityResult(0.0, np.zeros(3), True, contacts)

        # tipping angle: atan(overhang / COM height above contacts)
        contact_h = (contacts @ up).max()
        com_h = max(float(com @ up - contact_h), 1e-6)
        tip_deg = float(np.degrees(np.arctan2(-margin, com_h)))
        # at least past the threshold when the COM is unsupported
        tip_deg = max(tip_deg, 10.0)
        return StabilityResult(tip_deg, np.zeros(3), False, contacts)

    def sim_scene(self, mesh_list: list[Mesh]) -> list[StabilityResult]:
        """Full-scene settle check (reference sim_scene, sim.py:638): each
        non-background object validated against all others."""
        results = []
        for i in range(1, len(mesh_list)):
            others = [m for j, m in enumerate(mesh_list) if j != i]
            results.append(self.sim_validation([*others, mesh_list[i]]))
        return results


class MuJoCoProvider:
    """Dynamic rigid-body validation through MuJoCo (the in-image physics
    engine; reference counterpart: Isaac Sim/PhysX `sim_validation`,
    utils/sim.py:606-636 — all meshes static except the last, ~1 s settle,
    max orientation drift in degrees + translation).

    Differences from PhysX worth knowing:
      * collision geometry is the convex hull per mesh (MuJoCo convexifies
        mesh geoms). A static mesh whose hull would SWALLOW the candidate
        (the room/background) is replaced by a floor plane at the support
        height under the candidate's footprint;
      * unlike the quasi-static oracle this catches dynamic failures —
        rolling, sliding, and multi-step tipping.
    """

    name = "mujoco"

    def __init__(self, sim_seconds: float = 1.0, timestep: float = 0.002):
        import mujoco  # noqa: F401  (raises if unavailable)

        self.n_fallbacks = 0
        self.sim_seconds = sim_seconds
        self.timestep = timestep
        self._fallback = QuasiStaticProvider()

    def sim_validation(self, mesh_list: list[Mesh]) -> StabilityResult:
        try:
            return self._simulate(mesh_list)
        except Exception as e:
            # resilience: never block the Stage-2 ladder on solver issues —
            # but say so, or a broken mesh silently downgrades the whole
            # ladder to the weaker single-frame oracle
            import logging

            logging.getLogger(__name__).warning(
                "MuJoCo sim failed (%s: %s); falling back to the "
                "quasi-static oracle for this candidate",
                type(e).__name__, e,
            )
            self.n_fallbacks += 1
            return self._fallback.sim_validation(mesh_list)

    def _simulate(self, mesh_list: list[Mesh]) -> StabilityResult:
        import mujoco

        candidate = mesh_list[-1]
        supports = [m for m in mesh_list[:-1] if m is not None]
        if candidate is None or len(candidate.faces) == 0:
            return StabilityResult(0.0, np.zeros(3), True, None)

        cand_b = candidate.bounds
        spec = mujoco.MjSpec()
        spec.option.timestep = self.timestep
        gravity = np.zeros(3)
        gravity[GRAVITY_AXIS] = 9.81                 # down = +y
        spec.option.gravity = gravity

        floor_planes = 0
        for i, sup in enumerate(supports):
            sb = sup.bounds
            encloses = np.all(sb[0] <= cand_b[0] + 1e-6) and np.all(
                sb[1] >= cand_b[1] - 1e-6
            )
            if encloses:
                # room-like support: its convex hull would swallow the
                # candidate — use the floor height under the footprint
                v = sup.vertices
                in_xz = np.ones(len(v), bool)
                for ax in range(3):
                    if ax == GRAVITY_AXIS:
                        continue
                    in_xz &= (v[:, ax] >= cand_b[0][ax] - 0.1) & (
                        v[:, ax] <= cand_b[1][ax] + 0.1
                    )
                vv = v[in_xz] if in_xz.any() else v
                floor_h = float(vv[:, GRAVITY_AXIS].max())
                zaxis = np.zeros(3)
                zaxis[GRAVITY_AXIS] = -1.0
                pos = np.zeros(3)
                pos[GRAVITY_AXIS] = floor_h
                spec.worldbody.add_geom(
                    type=mujoco.mjtGeom.mjGEOM_PLANE, size=[10, 10, 0.1],
                    pos=pos, zaxis=zaxis,
                )
                floor_planes += 1
            else:
                m = spec.add_mesh(name=f"sup{i}")
                m.uservert = np.asarray(sup.vertices, np.float64).ravel()
                m.userface = np.asarray(sup.faces, np.int32).ravel()
                spec.worldbody.add_geom(
                    type=mujoco.mjtGeom.mjGEOM_MESH, meshname=f"sup{i}",
                )
        if not supports:
            return StabilityResult(90.0, np.zeros(3), False, None)

        c = np.asarray(candidate.vertices, np.float64)
        centroid = c.mean(axis=0)
        m = spec.add_mesh(name="cand")
        m.uservert = (c - centroid).ravel()
        m.userface = np.asarray(candidate.faces, np.int32).ravel()
        body = spec.worldbody.add_body(name="cand", pos=centroid)
        body.add_geom(type=mujoco.mjtGeom.mjGEOM_MESH, meshname="cand")
        body.add_freejoint()

        model = spec.compile()
        data = mujoco.MjData(model)
        n_steps = int(self.sim_seconds / self.timestep)
        mujoco.mj_step(model, data, nstep=n_steps)

        quat = np.asarray(data.qpos[3:7])
        quat = quat / max(np.linalg.norm(quat), 1e-12)
        drift_deg = float(
            2.0 * np.degrees(np.arccos(np.clip(abs(quat[0]), -1.0, 1.0)))
        )
        translation = np.asarray(data.qpos[:3]) - centroid
        if not np.isfinite(drift_deg) or not np.all(np.isfinite(translation)):
            self.n_fallbacks += 1
            return self._fallback.sim_validation(mesh_list)
        return StabilityResult(
            drift_deg, translation.astype(np.float64), drift_deg < 8.0, None
        )

    def sim_scene(self, mesh_list: list[Mesh]) -> list[StabilityResult]:
        results = []
        for i in range(1, len(mesh_list)):
            others = [m for j, m in enumerate(mesh_list) if j != i]
            results.append(self.sim_validation([*others, mesh_list[i]]))
        return results


_PROVIDER = None


def get_provider():
    """MuJoCo dynamics when available; quasi-static oracle otherwise.
    Override with HOLOSCENE_PHYSICS=quasistatic|mujoco."""
    global _PROVIDER
    if _PROVIDER is None:
        import os

        choice = os.environ.get("HOLOSCENE_PHYSICS", "auto")
        if choice == "quasistatic":
            _PROVIDER = QuasiStaticProvider()
        elif choice == "mujoco":
            # explicit request: a missing/broken mujoco must be an error,
            # not a silent downgrade
            _PROVIDER = MuJoCoProvider()
        else:
            try:
                _PROVIDER = MuJoCoProvider()
            except Exception as e:
                import logging

                logging.getLogger(__name__).warning(
                    "mujoco unavailable (%s); using the quasi-static "
                    "stability oracle", e,
                )
                _PROVIDER = QuasiStaticProvider()
    return _PROVIDER


def provider_report() -> dict:
    """{"provider": the name of the provider that runs, and for MuJoCo
    "quasistatic_fallbacks": the candidates it handed to the quasi-static
    oracle so far}."""
    p = get_provider()
    rep = {"provider": p.name}
    if isinstance(p, MuJoCoProvider):
        rep["quasistatic_fallbacks"] = p.n_fallbacks
    return rep


def sim_validation(mesh_list: list[Mesh]) -> StabilityResult:
    """Reference sim_validation(mesh_list) -> drift; accept when
    result.drift_deg < 8 (holoscene_train_post.py:767)."""
    return get_provider().sim_validation(mesh_list)


def sim_scene(mesh_list: list[Mesh]) -> list[StabilityResult]:
    return get_provider().sim_scene(mesh_list)


def settle_drop(candidate: Mesh, supports: list[Mesh],
                max_drop: float = 1.0, samples: int = 4000,
                seed: int = 0) -> np.ndarray:
    """Quasi-static vertical settle: translate the candidate along gravity
    until first contact (used by scene composition; reference lets PhysX do
    this during sim_scene). Returns the translation vector."""
    rng = np.random.default_rng(seed)
    pts = candidate.sample_surface(samples, rng)
    sup_pts = np.concatenate(
        [m.sample_surface(20000, rng) for m in supports if m is not None]
    )
    # gravity = +y in y-down worlds
    g = np.zeros(3)
    g[GRAVITY_AXIS] = 1.0
    # distance to first support below each candidate point along +y
    tree = cKDTree(sup_pts[:, [i for i in range(3) if i != GRAVITY_AXIS]])
    d2d, idx = tree.query(pts[:, [i for i in range(3) if i != GRAVITY_AXIS]], k=1)
    below = sup_pts[idx][:, GRAVITY_AXIS] - pts[:, GRAVITY_AXIS]
    ok = (d2d < 0.02) & (below > -1e-3)
    if not ok.any():
        return np.zeros(3)
    drop = float(np.clip(below[ok].min(), 0.0, max_drop))
    return g * drop
