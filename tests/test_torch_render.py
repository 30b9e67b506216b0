"""The port's rasterizer against the JAX package's, both on the CPU.

The same float32 model and the same body states go to both renderers.
The triangle soup must be equal exactly.  Frames may differ where float32
rounding of an edge function or a depth differs between XLA and PyTorch
(a pixel centre on a triangle edge, two surfaces at equal depth): at most
0.2% of the pixels of a frame may differ by more than 1 in any channel, and
the red cube's centroid must agree to 0.5 px.  Batching must change no
pixel: a batched render equals the per-env renders exactly.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs.gym_env import ASSETS_XML
from gym_so100_tpu.models import scene as jax_scene
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.render.rasterizer import Renderer as JaxRenderer
from gym_so100_tpu_torch.envs import constants as C
from gym_so100_tpu_torch.envs import core
from gym_so100_tpu_torch.models.builder import build_model
from gym_so100_tpu_torch.render.rasterizer import Renderer

OBS_TRIS, OBS_CHUNK = 100, 128     # the pixel env's renderer
N_STATES = 4
FRAME_TOL = 0.002                  # share of pixels allowed > 1 LSB apart
CENTROID_TOL = 0.5                 # px


@pytest.fixture(scope="module")
def models():
    mj, aux_j = jax_build_model(ASSETS_XML, max_contacts=16)
    m, aux = build_model(max_contacts=16, device="cpu", dtype=torch.float32)
    return mj.astype(jnp.float32), aux_j, m, aux


@pytest.fixture(scope="module")
def renderers(models):
    mj, aux_j, m, aux = models
    return (JaxRenderer(mj, aux_j, max_tris_per_mesh=OBS_TRIS, tri_chunk=OBS_CHUNK),
            Renderer(m, aux, max_tris_per_mesh=OBS_TRIS, tri_chunk=OBS_CHUNK))


def seeded_states(m, n=N_STATES, seed=0):
    """Reset states with seeded cube spawns; all but the first with the arm
    joints moved by up to 0.4 rad."""
    rng = np.random.RandomState(seed)
    box = C.sample_so100_box_poses(n, torch.Generator().manual_seed(seed),
                                   torch.float32, "cpu")
    s = core.reset(m, box).physics
    qpos = s.qpos.clone()
    qpos[1:, :6] += torch.from_numpy(rng.uniform(-0.4, 0.4, (n - 1, 6)).astype(np.float32))
    return s.replace(qpos=qpos)


def jax_state(s, i):
    """Env i of the port's batched State as a JAX State."""
    return jax_scene.State(**{
        f.name: jnp.asarray(getattr(s, f.name)[i].numpy())
        for f in dataclasses.fields(s) if getattr(s, f.name) is not None})


def red_centroid(img):
    rgb = img.astype(np.int32)
    red = (rgb[..., 0] > 1.5 * rgb[..., 1]) & (rgb[..., 0] > 1.5 * rgb[..., 2])
    if red.sum() < 4:
        return None
    ys, xs = np.nonzero(red)
    return xs.mean(), ys.mean()


def assert_frames_agree(ours, theirs):
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype == np.uint8
    off = np.abs(ours.astype(np.int32) - theirs.astype(np.int32)).max(-1) > 1
    assert off.mean() <= FRAME_TOL, (int(off.sum()), off.size)
    c_ours, c_theirs = red_centroid(ours), red_centroid(theirs)
    assert (c_ours is None) == (c_theirs is None)
    if c_ours is not None:
        assert np.abs(np.subtract(c_ours, c_theirs)).max() <= CENTROID_TOL, (c_ours, c_theirs)
    return c_ours


@pytest.mark.parametrize("tris,chunk", [(OBS_TRIS, OBS_CHUNK), (700, 1024)])
def test_soup_matches_jax(models, tris, chunk):
    """The decimated, padded triangle soup: verts, vbody, faces, colours."""
    mj, aux_j, m, aux = models
    rj = JaxRenderer(mj, aux_j, max_tris_per_mesh=tris, tri_chunk=chunk)
    rt = Renderer(m, aux, max_tris_per_mesh=tris, tri_chunk=chunk)
    for ours, theirs in ((rt.verts, rj._verts), (rt.vbody, rj._vbody),
                         (rt.faces, rj._faces), (rt.fcol, rj._fcol)):
        assert ours.shape == theirs.shape
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert rt.npad_valid == rj._npad_valid
    assert rt.faces.shape[0] % chunk == 0
    assert rt.cam == rj._cam


@pytest.mark.parametrize("camera", ["top", "front_close"])
@pytest.mark.parametrize("size", [(48, 64), (96, 128)])
def test_frames_match_jax(models, renderers, size, camera):
    _, _, m, _ = models
    rj, rt = renderers
    H, W = size
    s = seeded_states(m)
    frames = rt.render_batch(s, H, W, camera).numpy()
    assert frames.shape == (N_STATES, H, W, 3)
    for i in range(N_STATES):
        theirs = np.asarray(rj.render(jax_state(s, i), H, W, camera))
        assert_frames_agree(frames[i], theirs)
    if camera == "top":
        assert red_centroid(frames[0]) is not None, "the cube is in view at reset"


def test_camera_modes_match_jax(models, renderers):
    """Every camera of the scene in both modes (targetbody and fixed), and
    the straight-down fallback: position and axes to float32 rounding."""
    mj, _, m, _ = models
    rj, rt = renderers
    from gym_so100_tpu.ops import smooth as jax_smooth
    from gym_so100_tpu_torch.ops import smooth_lanes

    s = seeded_states(m)
    d = smooth_lanes.kinematics(m, s)
    poses = [(dj.xpos.astype(jnp.float32), dj.xquat.astype(jnp.float32))
             for dj in (jax_smooth.kinematics(mj, jax_state(s, i)) for i in range(N_STATES))]
    assert set(m.cam_mode) == {"targetbody"}
    # the scene's cameras all track a body; the fixed mode is the same
    # cameras with their mode switched (the renderers read the mode only)
    fixed = ("fixed",) * m.ncam
    pairs = [(rt, rj), (copy.copy(rt), copy.copy(rj))]
    pairs[1][0].m = m.replace(cam_mode=fixed)
    pairs[1][1]._m = dataclasses.replace(mj, cam_mode=fixed)
    for ours_r, theirs_r in pairs:
        for cam_id in range(m.ncam):
            ours = ours_r.camera(d.xpos, d.xquat, cam_id)
            for i in range(N_STATES):
                theirs = theirs_r._camera(*poses[i], cam_id, jnp.float32)
                for a, b in zip(ours, theirs):
                    np.testing.assert_allclose(a[i].numpy(), np.asarray(b), atol=2e-6)
    # a target straight below the camera: up falls back to +y
    xpos = d.xpos.clone()
    tb, cb = m.cam_targetbodyid[rt.cam["top"]], m.cam_bodyid[rt.cam["top"]]
    cpos = rt.camera(d.xpos, d.xquat, rt.cam["top"])[0]
    xpos[:, tb] = cpos - torch.tensor([0.0, 0.0, 0.5])
    assert tb != cb
    _, right, up, fwd = rt.camera(xpos, d.xquat, rt.cam["top"])
    torch.testing.assert_close(fwd, torch.tensor([0.0, 0.0, -1.0]).expand(N_STATES, 3))
    torch.testing.assert_close(up, torch.tensor([0.0, 1.0, 0.0]).expand(N_STATES, 3))
    torch.testing.assert_close(right, torch.tensor([1.0, 0.0, 0.0]).expand(N_STATES, 3))


def test_default_renderer_matches_jax(models):
    """The renderer at the JAX defaults (700 triangles per mesh, chunks of
    1024), as eval videos use it, on one state."""
    mj, aux_j, m, aux = models
    s = seeded_states(m, n=2)
    ours = Renderer(m, aux).render(s.index(1), 96, 128, "top").numpy()
    theirs = np.asarray(JaxRenderer(mj, aux_j).render(jax_state(s, 1), 96, 128, "top"))
    assert assert_frames_agree(ours, theirs) is not None


@pytest.mark.parametrize("chunk_elems", [None, 128 * 500])
def test_batched_render_equals_per_env(models, chunk_elems):
    """5 envs in one render, with the default block budget and with one so
    small that each block holds part of one env's pixels, equal the five
    one-env renders exactly."""
    _, _, m, aux = models
    r = Renderer(m, aux, max_tris_per_mesh=OBS_TRIS, tri_chunk=OBS_CHUNK)
    if chunk_elems is not None:
        r.chunk_elems = chunk_elems      # blocks of part of one env's pixels
    s = seeded_states(m, n=5, seed=1)
    batched = r.render_batch(s, 48, 64, "top")
    alone = Renderer(m, aux, max_tris_per_mesh=OBS_TRIS, tri_chunk=OBS_CHUNK)
    for i in range(5):
        assert torch.equal(batched[i], alone.render(s.index(i), 48, 64, "top"))


def test_cube_centroid_is_its_projection(models, renderers):
    """The red cube's silhouette lies where the renderer's own camera
    projects the cube's world centre (as the JAX package's renderer test
    checks), and the table hides the sky at the frame's centre."""
    _, _, m, _ = models
    _, rt = renderers
    from gym_so100_tpu_torch.ops import smooth_lanes

    H, W = 96, 128
    s = seeded_states(m)
    frames = rt.render_batch(s, H, W, "top").numpy()
    cube = smooth_lanes.kinematics(m, s).site_xpos[:, m.site_id("cube_site")]
    px, py = rt.project(s, cube[:, None], H, W, "top")
    seen = 0
    for i in range(N_STATES):
        c = red_centroid(frames[i])       # None where the arm hides the cube
        if c is not None:
            seen += 1
            assert abs(c[0] - float(px[i, 0])) < 4 and abs(c[1] - float(py[i, 0])) < 4
    assert seen >= 2
    sky = np.asarray([183, 204, 226])
    is_sky = np.abs(frames.astype(int) - sky).sum(-1) < 12
    assert is_sky[:, H // 2 - H // 8:H // 2 + H // 8, W // 2 - W // 8:W // 2 + W // 8].mean() < 0.05


def test_float64_model_renders_in_float32(models):
    """The render runs in float32 whatever the model's dtype: a float64
    model's frames agree with the float32 model's within the frame
    tolerance."""
    _, _, m, aux = models
    m64 = m.to(dtype=torch.float64)
    s = seeded_states(m)
    ours = Renderer(m64, aux, OBS_TRIS, OBS_CHUNK).render_batch(
        s.to(dtype=torch.float64), 48, 64).numpy()
    ref = Renderer(m, aux, OBS_TRIS, OBS_CHUNK).render_batch(s, 48, 64).numpy()
    for a, b in zip(ours, ref):
        assert_frames_agree(a, b)


def test_unsupported_geom_type_raises(models):
    _, _, m, aux = models
    aux = dict(aux, render_geoms=[*aux["render_geoms"], dict(
        aux["render_geoms"][0], type="sphere", group=0, rgba=(1, 1, 1, 1))])
    with pytest.raises(NotImplementedError, match="sphere"):
        Renderer(m, aux)
