"""Stage 3 of the port (holoscene_tpu_torch/training/stage3.py and the
colour field of models/fields.py) against the JAX package on the CPU, from
identical parameters and draws at a tiny width (4 levels, logmap 12, end
64, hidden 32; 32^2 frames, as tests/test_stage3.py), through the plain
versions of H2 (packed) and H1-bwd (no jacobian term).

Tolerances. The colour field: atol 1e-6 (float32 sums of 8 corners and
of the MLP in another order; measured ~1e-7). Gradients and the
parameters after Adam: per tensor, max |port - JAX| <= 1e-5 of that
tensor's largest |JAX| value (float32 sums in another order; Adam's eps
1e-15 turns each gradient into about lr sign(grad), which stays exact
while no gradient sits at rounding level). Losses: rtol 1e-5. The bake's
coverage is a rasterization of the UV layout by each package's own
rasterizer: the masks may differ on the coverage's edge texels (stated
below); the colours of texels both cover are within 1/255 (one step of
the 8-bit PNG)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu.datasets.ns_dataset import NSDataset as JNSDataset
from holoscene_tpu.datasets.synthetic import DEFAULT_SPHERES, generate_scene
from holoscene_tpu.models import fields as jf
from holoscene_tpu.ops.rasterizer import rasterize_mesh as j_rasterize
from holoscene_tpu.training import stage3 as js3
from holoscene_tpu.utils.mc import marching_tetrahedra
from holoscene_tpu.utils.mesh import Mesh as JMesh
from holoscene_tpu.utils.mesh import read_obj as j_read_obj
from holoscene_tpu.utils.uv_atlas import build_chart_atlas
from holoscene_tpu_torch.convert import (
    color_field_params_from_jax,
    color_field_params_to_jax,
)
from holoscene_tpu_torch.datasets.ns_dataset import NSDataset
from holoscene_tpu_torch.datasets.synthetic import sphere_view_packs
from holoscene_tpu_torch.models import fields as tf
from holoscene_tpu_torch.ops.rasterizer import rasterize_mesh
from holoscene_tpu_torch.training import stage3 as ts3
from holoscene_tpu_torch.utils.mesh import Mesh, read_obj

SIZES = dict(num_levels=4, logmap=12, end_size=64, hidden=32)
JCFG, TCFG = jf.ColorFieldConfig(**SIZES), tf.ColorFieldConfig(**SIZES)
M = 512            # pixels a step
OBJ = 1            # the red sphere, instance id 1
REL = 1e-5


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("s3")
    generate_scene(str(root / "scene_0"), n_images=6, img_res=(32, 32))
    return (JNSDataset(str(root), "scene_0", img_res=(32, 32)),
            NSDataset(str(root), "scene_0", img_res=(32, 32)))


@pytest.fixture(scope="module")
def sphere():
    sp = DEFAULT_SPHERES[0]
    axis = np.linspace(-1, 1, 20)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    c = np.asarray(sp["center"]) / 1.3
    sdf = np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) \
        - sp["radius"] / 1.3
    v, f = marching_tetrahedra(sdf, origin=(-1,) * 3, spacing=(2 / 19,) * 3)
    return v, f


@pytest.fixture(scope="module")
def packs():
    out = sphere_view_packs(DEFAULT_SPHERES[0], n_views=3, res=16)
    rng = np.random.default_rng(5)
    for p in out:
        p["rgb"] = rng.uniform(0, 1, p["rgb"].shape).astype(np.float32)
    return out


def _runners(scene, sphere, tmp_path):
    v, f = sphere
    jr = js3.Stage3Runner([None, JMesh(v, f)], scene[0], cfg=JCFG,
                          pixels_per_step=M, out_dir=str(tmp_path / "j"),
                          texture_res=64, quiet=True)
    tr = ts3.Stage3Runner([None, Mesh(v, f)], scene[1], cfg=TCFG,
                          pixels_per_step=M, out_dir=str(tmp_path / "t"),
                          texture_res=64, quiet=True, device="cpu")
    return jr, tr


def _jax_params(seed=0, grid_scale=None):
    p = jf.init_color_field(jax.random.PRNGKey(seed), JCFG)
    if grid_scale is not None:
        rng = np.random.default_rng(seed)
        p["grid"] = jnp.asarray(rng.uniform(-grid_scale, grid_scale,
                                            p["grid"].shape), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, p)


def _port_field(params):
    field = tf.ColorField(TCFG)
    field.load_state_dict(color_field_params_from_jax(params))
    return field


def _assert_tree_close(got: dict, ref: dict, rel=REL, what="",
                       rel_grid=None):
    """Per tensor, max |got - ref| <= rel x max |ref| (the table: rel_grid,
    when given)."""
    for k, r in ref.items():
        if isinstance(r, dict):
            _assert_tree_close(got[k], r, rel, f"{what}{k}.")
            continue
        tol = rel_grid if k == "grid" and rel_grid is not None else rel
        r, g = np.asarray(r), np.asarray(got[k])
        err = np.abs(g - r).max()
        assert err <= tol * np.abs(r).max(), (f"{what}{k}", err,
                                              np.abs(r).max())


def _field_tree(field):
    """The field's parameters as JAX's tree (copies)."""
    return jax.tree_util.tree_map(np.array, color_field_params_to_jax(
        dict(field.named_parameters())))


def _jax_idx(mesh, pose, intr, res, half, target_mask, key):
    """jax.random.choice's draw of the JAX step (rasterized inside a jit
    with a traced pose, as the step is), the valid mask and the world
    positions [HW, 3]."""

    @jax.jit
    def draw(pose):
        out = j_rasterize(jnp.asarray(mesh[0], jnp.float32),
                          jnp.asarray(mesh[1], jnp.int32), pose, intr, res,
                          ortho_half_extent=half)
        valid = out["mask"].reshape(-1) & target_mask.reshape(-1)
        n_valid = valid.sum()
        probs = valid.astype(jnp.float32)
        probs = probs / jnp.maximum(probs.sum(), 1.0)
        probs = jnp.where(n_valid > 0, probs, 1.0 / probs.shape[0])
        return (jax.random.choice(key, probs.shape[0], (M,), p=probs),
                valid, out["world_pos"].reshape(-1, 3))

    idx, valid, wp = draw(jnp.asarray(pose, jnp.float32))
    return torch.as_tensor(np.array(idx), dtype=torch.int64), \
        np.asarray(valid), np.array(wp)


def test_color_field_forward_matches_jax():
    params = _jax_params(1, grid_scale=0.5)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.4, 1.4, (600, 3)).astype(np.float32)
    x[:100, 0] = 1.5                  # x01 = 1 on the x plane
    x[100:150] = 1.5                  # the (1, 1, 1) corner
    x[150:200, 1] = -1.5              # x01 = 0
    x[200:260] *= 1.3                 # some outside [0, 1]
    ref = np.asarray(jf.color_field_forward(params, JCFG, jnp.asarray(x)))
    with torch.no_grad():
        got = tf.color_field_forward(_port_field(params),
                                     torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert np.ptp(ref) > 0.1


def test_color_field_gradients_match_jax():
    params = _jax_params(2, grid_scale=0.5)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.6, 1.6, (700, 3)).astype(np.float32)
    x[:80, 2] = 1.5
    gt = rng.uniform(0, 1, (700, 3)).astype(np.float32)
    ref = jax.grad(lambda p: jnp.mean(
        (jf.color_field_forward(p, JCFG, jnp.asarray(x)) - gt) ** 2))(params)
    field = _port_field(params)
    loss = torch.mean((tf.color_field_forward(field, torch.as_tensor(x))
                       - torch.as_tensor(gt)) ** 2)
    loss.backward()
    got = color_field_params_to_jax({k: p.grad for k, p
                                     in field.named_parameters()})
    _assert_tree_close(got, ref)
    assert np.count_nonzero(np.asarray(ref["grid"])) > 100


def _frame_of(jds):
    return jds.class_id_occurences[OBJ][0]


def _jax_step_args(jds, frame, mask=None):
    h, w = jds.img_res
    inst = (jds.semantic_images[frame].reshape(h, w) == OBJ) \
        if mask is None else mask
    return (jnp.asarray(jds.pose_all[frame]),
            jnp.asarray(jds.rgb_images[frame].reshape(h, w, 3)),
            jnp.asarray(inst))


def test_image_step_matches_jax(scene, sphere, tmp_path):
    jr, tr = _runners(scene, sphere, tmp_path)
    jds = scene[0]
    v, f = sphere
    step, optimizer = jr._make_step(jnp.asarray(v, jnp.float32),
                                    jnp.asarray(f, jnp.int32), 100)
    params = _jax_params(3)
    field = _port_field(params)
    opt, sched = ts3.make_color_optimizer(field, 5e-4, 20.0, 100)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = optimizer.init(jp)
    frame = _frame_of(jds)
    for it, key in enumerate(jax.random.split(jax.random.PRNGKey(7), 2)):
        pose, rgb, inst = _jax_step_args(jds, frame)
        idx, jvalid, _ = _jax_idx((v, f), pose,
                                  jnp.asarray(jds.intrinsics[:3, :3]),
                                  jds.img_res, None, inst, key)
        wp, weights, valid_any, trgb = tr._frame_view(OBJ, frame)
        np.testing.assert_array_equal(weights.numpy() > 0, jvalid)
        jp, js, jloss = step(jp, js, key, pose, rgb, inst)
        loss = ts3.color_step(field, opt, sched, wp, valid_any, trgb, idx)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert float(jloss) > 1e-3
        _assert_tree_close(_field_tree(field), jp, what=f"step {it} ")


def test_empty_instance_mask_step_still_moves_params(scene, sphere,
                                                     tmp_path):
    """A frame whose instance mask is empty: loss 0, uniform draws, and
    Adam still steps (its momentum moves the params as JAX's do)."""
    jr, tr = _runners(scene, sphere, tmp_path)
    jds = scene[0]
    v, f = sphere
    step, optimizer = jr._make_step(jnp.asarray(v, jnp.float32),
                                    jnp.asarray(f, jnp.int32), 50)
    params = _jax_params(4)
    field = _port_field(params)
    opt, sched = ts3.make_color_optimizer(field, 5e-4, 20.0, 50)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = optimizer.init(jp)
    frame = _frame_of(jds)
    h, w = jds.img_res
    empty = np.zeros((h, w), bool)
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    intr = jnp.asarray(jds.intrinsics[:3, :3])
    for key, mask in ((k1, None), (k2, empty)):
        pose, rgb, inst = _jax_step_args(jds, frame, mask)
        idx = _jax_idx((v, f), pose, intr, jds.img_res, None, inst, key)[0]
        if mask is None:
            view = tr._frame_view(OBJ, frame)
        else:
            view = tr._view(OBJ, "empty", jds.pose_all[frame],
                            jds.intrinsics[:3, :3], (h, w), None,
                            jds.rgb_images[frame].reshape(h, w, 3), mask)
            assert not bool(view[2]) and torch.all(view[1] == 1.0)
        before = _field_tree(field)
        jp, js, jloss = step(jp, js, key, pose, rgb, inst)
        loss = ts3.color_step(field, opt, sched, view[0], view[2], view[3],
                              idx)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        _assert_tree_close(_field_tree(field), jp)
    assert float(loss) == 0.0 == float(jloss)
    moved = np.abs(_field_tree(field)["mlp"]["lin0"]["w"]
                   - before["mlp"]["lin0"]["w"]).max()
    assert moved > 1e-5


def test_invisible_view_steps_share_the_schedule(scene, sphere, packs,
                                                 tmp_path):
    """Two iterations of image step + invisible-view step against JAX's
    step and invis_step on one optimizer state: the two share Adam's
    moments and the schedule count. The views' rasterizations are held to
    JAX's (mask equal; world positions of the covered pixels within 1e-4:
    barycentric rounding, measured 2.3e-6 in a perspective frame, and up
    to 5.3e-5 at a pixel whose centre sits on the edge two faces share,
    which may go to either) and the steps take JAX's world positions:
    Adam's second update divides by the moments of two steps' gradients,
    which can cancel on a table row, and there it turns a 3e-7 difference
    into more than 1e-5 of the table's scale. For the same reason the
    table is held to 5e-5 of its scale here (the MLP to 1e-5): measured
    1.7e-5, at a row whose two steps' gradients, -4.0e-8 and 9.9e-9, are
    sums of contributions 1e4 times larger."""
    jr, tr = _runners(scene, sphere, tmp_path)
    jds = scene[0]
    v, f = sphere
    vj, fj = jnp.asarray(v, jnp.float32), jnp.asarray(f, jnp.int32)
    step, optimizer = jr._make_step(vj, fj, 40)
    invis = jr._make_invis_step(vj, fj, optimizer, 16)
    params = _jax_params(5)
    field = _port_field(params)
    opt, sched = ts3.make_color_optimizer(field, 5e-4, 20.0, 40)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = optimizer.init(jp)
    frame = _frame_of(jds)
    intr = jnp.asarray(jds.intrinsics[:3, :3])
    keys = jax.random.split(jax.random.PRNGKey(13), 4)
    for it in range(2):
        pose, rgb, inst = _jax_step_args(jds, frame)
        idx, _, jwp = _jax_idx((v, f), pose, intr, jds.img_res, None, inst,
                               keys[2 * it])
        jp, js, _ = step(jp, js, keys[2 * it], pose, rgb, inst)
        wp, w1, valid_any, trgb = tr._frame_view(OBJ, frame)
        cov = w1.numpy() > 0
        np.testing.assert_allclose(wp.numpy()[cov], jwp[cov], rtol=0,
                                   atol=1e-4)
        ts3.color_step(field, opt, sched, torch.as_tensor(jwp), valid_any,
                       trgb, idx)

        pack = packs[it]
        gen_mask = jnp.asarray(pack["mask"], jnp.float32)
        idx2, jvalid, jwp2 = _jax_idx((v, f), jnp.asarray(pack["pose"]),
                                      None, (16, 16),
                                      float(pack["half_extent"]),
                                      gen_mask > 0.5, keys[2 * it + 1])
        jp, js, jloss = invis(jp, js, keys[2 * it + 1],
                              jnp.asarray(pack["pose"], jnp.float32),
                              jnp.asarray(float(pack["half_extent"])),
                              jnp.asarray(pack["rgb"]), gen_mask)
        wp2, w2, any2, rgb2 = tr._pack_view(OBJ, it, pack)
        np.testing.assert_array_equal(w2.numpy() > 0, jvalid)
        np.testing.assert_allclose(wp2.numpy()[jvalid], jwp2[jvalid], rtol=0,
                                   atol=1e-4)
        loss = ts3.color_step(field, opt, sched, torch.as_tensor(jwp2), any2,
                              rgb2, idx2)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert float(jloss) > 1e-3
        _assert_tree_close(_field_tree(field), jp, what=f"iteration {it} ",
                           rel_grid=5e-5)
    assert sched.last_epoch == 4


def test_train_object_draws_jax_frames_and_the_loss_falls(scene, sphere,
                                                          tmp_path,
                                                          monkeypatch):
    jr, tr = _runners(scene, sphere, tmp_path)
    frames = []
    view = tr._frame_view
    monkeypatch.setattr(tr, "_frame_view",
                        lambda o, fr: frames.append(fr) or view(o, fr))
    jlosses = jr.train_object(OBJ, n_iters=60)
    losses = tr.train_object(OBJ, n_iters=60)
    occ = scene[0].class_id_occurences[OBJ]
    rng = np.random.default_rng(0)
    want = [int(rng.choice(occ)) for _ in range(60)]
    assert frames == want
    assert tr.rng.bit_generator.state == jr.rng.bit_generator.state
    assert len(losses) == len(jlosses) == 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert tr.steps[OBJ] == {"image": 60, "invisible": 0}


def _read_png(path):
    return np.asarray(Image.open(path), dtype=np.int16)


@pytest.mark.parametrize("atlas", ["charts", "triangles"])
def test_bake_matches_jax(scene, sphere, tmp_path, atlas):
    jr, tr = _runners(scene, sphere, tmp_path)
    params = _jax_params(6, grid_scale=0.5)
    jr.color_params[OBJ] = jax.tree_util.tree_map(jnp.asarray, params)
    tr.color_fields[OBJ] = _port_field(params)
    res = 128
    jpath = jr.export_mesh_texture(OBJ, texture_res=res, atlas=atlas)
    tpath = tr.export_mesh_texture(OBJ, texture_res=res, atlas=atlas)
    jm, tm = j_read_obj(jpath), read_obj(tpath)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    np.testing.assert_array_equal(tm.uvs, jm.uvs)
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    assert len(tm.uvs) == len(tm.vertices)
    jtex = _read_png(tmp_path / "j" / f"surface_{OBJ}.png")
    ttex = _read_png(tmp_path / "t" / f"surface_{OBJ}.png")
    assert jtex.shape == ttex.shape and np.ptp(ttex) > 20
    if atlas == "triangles":
        # coverage is host numpy in both packages: every texel comparable
        assert np.abs(ttex - jtex).max() <= 1
        return
    v, f = sphere
    _, new_faces, uv_px, _, res = build_chart_atlas(v, f, res)
    uvV = np.concatenate([uv_px - res / 2.0, np.ones((len(uv_px), 1))],
                         -1).astype(np.float32)
    jcov = np.asarray(j_rasterize(uvV, new_faces, np.eye(4, dtype=np.float32),
                                  None, (res, res),
                                  ortho_half_extent=res / 2.0)["face_id"]) >= 0
    tcov = rasterize_mesh(uvV, new_faces, np.eye(4, dtype=np.float32), None,
                          (res, res), ortho_half_extent=res / 2.0)[
        "face_id"].numpy() >= 0
    # the masks may differ only on coverage edges (a texel centre on a UV
    # triangle's edge, decided by the last bit of the edge test): each
    # differing texel has an uncovered 4-neighbour in both masks' union
    diff = jcov != tcov
    assert diff.sum() <= 0.002 * jcov.sum(), (diff.sum(), jcov.sum())
    pad = np.pad(jcov & tcov, 1)
    inner = pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:]
    assert not (diff & inner).any()
    both = jcov & tcov
    assert np.abs(ttex - jtex)[both].max() <= 1
