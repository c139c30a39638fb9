"""The parity pipeline's renders in the PyTorch port against the JAX
package, on the CPU (the JAX side under ``jax.jit``): render_rays with a
near/far override, a warp, an injected field and the curvature term;
geometry_guided_near_far; the parity warp frame of the committed artifact;
and the render CLIs at their new default, ``--sampler parity``.

Tolerances:
* render_rays, each option on tests/test_torch_render_parity.py's fields:
  rgb and depth 1e-5 (the pyramid) or 3e-5 (the hash grid), weights and
  z values 5e-5, gradient_error and curvature_error 1e-4 relative, the
  bounds and causes of that file (f32 MLP sums in other orders, carried
  through the up-sampler's CDF inversion). With the warp: rgb and depth
  5e-5, weights 1e-4, z values 1e-3 (measured 1.6e-5, 3.0e-5 and 6.0e-4).
  The warp's closest face of a sample inside the body, near its medial
  axis, is a near-tie; the JAX package's own render moves by as much
  (1.5e-5, 2.7e-5 and 3.4e-4) when its parameters move by one ulp
  (tests/parity_sensitivity.py prints each sensitivity quoted here);
* geometry_guided_near_far: the +-inf pattern exactly, the bounds within
  1e-6 (three-term f32 sums in other orders); blocked and unblocked
  bitwise equal (min and max are exact in any order);
* the parity warp frame of the artifact at 16x16: all but 3% of the values
  within 2e-3, the bound of the fast warp frame
  (tests/test_torch_warp_render.py), every value within 1e-2 (measured
  4.5e-3, 0.4% of the values above 2e-3, 3 of 768, all on one edge pixel;
  the card against the CPU 4.2e-3 and 1.2%): the kNN resolves near-ties
  to other faces, and the parity frame warps every sample, the body's
  inside included; the JAX package's own frame moves by up to 1.1e-2, and
  2.3% of its values by more than 2e-3, when its parameters or the posed
  vertices move by one ulp;
* render_canonical_cli's parity frame: bitwise the port's
  render_rays_chunked of the same rays.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.cameras import pose2rays as jax_pose2rays
from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.models import smpl as jsmpl
from avatarcraft_tpu.utils.checkpoint import load_params_with_config as jax_load_params_with_config
from avatarcraft_tpu.warp import WarpData as JaxWarpData
from avatarcraft_tpu.warp import geometry_guided_near_far as jax_near_far
from avatarcraft_tpu.warp import make_warp_fn as jax_make_warp_fn
from avatarcraft_tpu.workloads import warp_render as jwr
from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.cameras import default_360_path, pose2rays
from avatarcraft_tpu_torch.cli import render_canonical_cli, render_warp_cli
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.utils.checkpoint import load_params_with_config, save_params_with_config
from avatarcraft_tpu_torch.utils.metrics import integerify_img
from avatarcraft_tpu_torch.warp import WarpData, geometry_guided_near_far, make_warp_fn
from avatarcraft_tpu_torch.workloads import warp_render as twr
from test_torch_render import SMALL_JAX_FCFG
from test_torch_render_parity import BOUND, FIELD_ATOL, HASH_ATOL, HASH_FCFG, HASH_JAX_FCFG, _rays, _surface_field, _t
from test_torch_render_parity import hash_field as _hash_field

FRAME_ATOL = 2e-3
# the parity warp frame: every value within 1e-2, all but 3% within FRAME_ATOL
PARITY_FRAME_ATOL, FRAME_OUTLIER_SHARE = 1e-2, 0.03
# render_rays with the warp: rgb and depth, weights, z values
WARP_ATOL = {"rgb": 5e-5, "depth": 5e-5, "weights": 1e-4, "z_vals": 1e-3}
RES = 16
needs_artifacts = pytest.mark.skipif(
    not all(os.path.exists(p) for p in (bench.ARTIFACT_CKPT, bench.RIG, bench.POSES)),
    reason="committed artifacts not present",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: tier-1 runs six
    pytest workers on the machine's cores. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere_body(n_lat=7, n_lon=12, r=0.9):
    """A UV sphere of radius ``r`` (the surface of the fields' SDF lies near
    0.9) posed by per-vertex rigid transforms: a turn about y that grows
    with the height, and a shift along x. (canonical->posed Ts [V,4,4],
    posed vertices [V,3], faces [F,3])."""
    verts = [[0.0, r, 0.0]]
    for i in range(1, n_lat):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            verts.append([r * np.sin(th) * np.cos(ph), r * np.cos(th), r * np.sin(th) * np.sin(ph)])
    verts.append([0.0, -r, 0.0])
    can = np.asarray(verts, np.float32)
    faces = []
    for j in range(n_lon):
        faces.append([0, 1 + j, 1 + (j + 1) % n_lon])
    for i in range(n_lat - 2):
        for j in range(n_lon):
            a, b = 1 + i * n_lon + j, 1 + i * n_lon + (j + 1) % n_lon
            faces += [[a, a + n_lon, b], [b, a + n_lon, b + n_lon]]
    last = len(can) - 1
    for j in range(n_lon):
        base = 1 + (n_lat - 2) * n_lon
        faces.append([base + j, last, base + (j + 1) % n_lon])
    Ts = np.tile(np.eye(4, dtype=np.float32), (len(can), 1, 1))
    for v, (x, y, z) in enumerate(can):
        a = 0.25 * y
        Ts[v, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        Ts[v, :3, 3] = [0.05, 0.0, 0.0]
    posed = np.einsum("vij,vj->vi", Ts[:, :3, :3], can) + Ts[:, :3, 3]
    return Ts, posed.astype(np.float32), np.asarray(faces, np.int32)


def _fields(kind):
    """(jparams, params, jax FieldConfig, port FieldConfig, rgb/depth atol)."""
    if kind == "pyramid":
        jparams, params, fcfg = _surface_field()
        return jparams, params, SMALL_JAX_FCFG, fcfg, FIELD_ATOL
    jparams, params = _hash_field()
    return jparams, params, HASH_JAX_FCFG, HASH_FCFG, HASH_ATOL


def _near_far(n):
    """Per-ray bounds inside the cube, +inf / -inf on every third / fourth
    ray (those fall back to the cube bounds)."""
    rng = np.random.default_rng(4)
    near = rng.uniform(1.4, 1.9, size=(n, 1)).astype(np.float32)
    far = (near + rng.uniform(1.0, 1.6, size=(n, 1))).astype(np.float32)
    near[::3], far[::4] = np.inf, -np.inf
    return near, far


@pytest.mark.parametrize("option", ["near_far", "warp", "field", "curvature"])
@pytest.mark.parametrize("kind", ["pyramid", "hash"])
def test_render_rays_options_match_jax(kind, option):
    """render_rays with one of the parity pipeline's options, 6+6 samples
    in rounds of 3 (so the warp reaches an up-sampling round's new
    points), against the JAX package's."""
    jparams, params, jfcfg, fcfg, atol = _fields(kind)
    curvature = option == "curvature"
    jrcfg = jnsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=3, perturb=False,
                              curvature_loss=curvature)
    rcfg = nsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=3, perturb=False, curvature_loss=curvature)
    ro, rd = _rays(32)
    key = jax.random.PRNGKey(7)
    jkw, kw = {}, {}
    if option == "near_far":
        nf = _near_far(32)
        jkw["near_far"] = tuple(jnp.asarray(a) for a in nf)
        kw["near_far"] = tuple(_t(a) for a in nf)
    elif option == "warp":
        Ts, posed, faces = _sphere_body()
        jkw["warp_fn"] = jax_make_warp_fn(JaxWarpData.create(posed, faces, Ts))
        kw["warp_fn"] = make_warp_fn(WarpData.create(posed, faces, Ts, "cpu"))
    elif option == "field":
        # the field alone: the port's render reads nothing of params
        jkw["field"] = jnsr.network_field_fns(jparams, jfcfg, BOUND)
        kw["field"] = nsr.network_field_fns(params, fcfg, BOUND, nsr.materialize_field_tables(params, fcfg))
        params = None
    else:
        # JAX's own draw: k_curv is the second split of the render's key
        k_curv = jax.random.split(jax.random.split(key)[0])[1]
        dirs = 2.0 * jax.random.normal(k_curv, (32 * 12, 3)) - 1.0
        kw["curvature_dirs"] = _t(dirs)
    want = jax.jit(lambda a, b, k: jnsr.render_rays(jparams, a, b, k, jfcfg, jrcfg, 1.0, **jkw))(ro, rd, key)
    got = nsr.render_rays(params, _t(ro), _t(rd), fcfg, rcfg, 1.0, **kw)
    tols = WARP_ATOL if option == "warp" else {"rgb": atol, "depth": atol, "weights": 5e-5, "z_vals": 5e-5}
    for k, tol in tols.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=tol, rtol=0, err_msg=k)
    np.testing.assert_allclose(float(got["gradient_error"]), float(want["gradient_error"]), rtol=1e-4)
    if option == "warp":
        # the mask zeroes the samples off the body; rays cross the surface near it
        assert float(got["pts_alpha"].eq(0).float().mean()) > 0.2 and float(got["weight_sum"].max()) > 0.3
    else:
        assert float(got["weight_sum"].mean()) > 0.2  # a share of the rays cross the surface
    if curvature:
        assert float(want["curvature_error"]) > 0
        np.testing.assert_allclose(float(got["curvature_error"]), float(want["curvature_error"]), rtol=1e-4)
    else:
        assert float(got["curvature_error"]) == 0.0


def test_curvature_draw_is_seeded():
    """Without injected directions the curvature term draws 2 N(0, 1) - 1
    from the generator: the same seed, the same term."""
    _, params, fcfg = _surface_field()
    rcfg = nsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=3, curvature_loss=True)
    ro, rd = _rays(8)
    a = nsr.render_rays(params, _t(ro), _t(rd), fcfg, rcfg, generator=torch.Generator().manual_seed(3))
    b = nsr.render_rays(params, _t(ro), _t(rd), fcfg, rcfg, generator=torch.Generator().manual_seed(3))
    dirs = 2.0 * torch.randn((8 * 12, 3), generator=torch.Generator().manual_seed(3)) - 1.0
    c = nsr.render_rays(params, _t(ro), _t(rd), fcfg, rcfg, curvature_dirs=dirs)
    assert torch.equal(a["curvature_error"], b["curvature_error"])
    assert torch.equal(a["curvature_error"], c["curvature_error"]) and float(a["curvature_error"]) > 0


def test_geometry_guided_near_far_matches_jax():
    rng = np.random.default_rng(0)
    verts = (rng.normal(size=(300, 3)) * 0.25).astype(np.float32)
    n = 200
    o = np.tile(np.asarray([[0.0, 0.1, -2.5]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.3 + np.asarray([0, 0, 1], np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    wn, wf = (np.asarray(a) for a in jax.jit(jax_near_far)(o, d, verts))
    gn, gf = geometry_guided_near_far(_t(o), _t(d), _t(verts), block=7)
    un, uf = geometry_guided_near_far(_t(o), _t(d), _t(verts), block=300)
    assert torch.equal(gn, un) and torch.equal(gf, uf)
    assert gn.shape == gf.shape == (n, 1)
    miss = np.isinf(wn)
    assert 0 < miss.sum() < n  # some rays hit no sphere
    np.testing.assert_array_equal(np.isinf(gn.numpy()), miss)
    np.testing.assert_array_equal(gn.numpy()[miss], wn[miss])
    np.testing.assert_array_equal(gf.numpy()[miss], wf[miss])
    np.testing.assert_allclose(gn.numpy()[~miss], wn[~miss], atol=1e-6, rtol=0)
    np.testing.assert_allclose(gf.numpy()[~miss], wf[~miss], atol=1e-6, rtol=0)
    assert (gf.numpy()[~miss] > gn.numpy()[~miss]).all()


@needs_artifacts
def test_warp_frame_renderer_matches_jax():
    """Demo frame 10 of the artifact at 16x16 from the warp bench's camera,
    through the parity frame renderer in two 128-ray chunks (each bounded
    by geometry_guided_near_far), against the JAX package's."""
    model = jsmpl.load_smpl(bench.RIG)
    wv, Ts, _ = jwr.calc_local_trans(model, poses=np.load(bench.POSES)[10:11], max_frames=1, rest_pose="zero")
    jparams, jfcfg = jax_load_params_with_config(bench.ARTIFACT_CKPT)
    params, fcfg = load_params_with_config(bench.ARTIFACT_CKPT, "cpu")
    jro, jrd = jax_pose2rays(RES, RES, bench.warp_view())
    ro, rd = pose2rays(RES, RES, bench.warp_view(), device="cpu")
    want = np.asarray(jwr.make_warp_frame_renderer(jfcfg, jwr.WarpRenderSettings(chunk=128))(
        jparams, jro, jrd, JaxWarpData.create(wv[0], model.faces, Ts[0]))).reshape(RES, RES, 3)
    settings = twr.WarpRenderSettings(chunk=128)
    assert (settings.num_steps, settings.upsample_steps) == (32, 32)
    got = twr.make_warp_frame_renderer(params, fcfg, settings)(
        ro, rd, WarpData.create(wv[0], model.faces, Ts[0], "cpu")).numpy().reshape(RES, RES, 3)
    assert np.isfinite(got).all() and (got < 0.9).any()  # the body, on a white background
    np.testing.assert_allclose(got, want, rtol=0, atol=PARITY_FRAME_ATOL)
    assert float((np.abs(got - want) > FRAME_ATOL).mean()) <= FRAME_OUTLIER_SHARE


# ---------------------------------------------------------------------------
# the render CLIs at their default sampler
# ---------------------------------------------------------------------------


@pytest.mark.skipif(not os.path.exists(bench.ARTIFACT_CKPT), reason="artifact not present")
def test_canonical_cli_parity_equals_render_rays_chunked(tmp_path):
    """The default sampler renders each frame through render_rays_chunked
    (64+64, no jitter, --batch_size chunks, the last one padded) with the
    artifact's provenance normals (fd4): the PNG is bitwise that frame."""
    from test_torch_guards import _read_png

    render_canonical_cli.main(["--weights_path", bench.ARTIFACT_CKPT, "--use_cuda", "false", "--render_h", "8",
                               "--render_w", "8", "--trajectory_resolution", "1", "--batch_size", "24",
                               "--out_dir", str(tmp_path), "--exp_name", "p"])
    out = tmp_path / "canonical_360" / "p"
    assert sorted(os.listdir(out)) == ["p_body_can.gif", "p_body_can_0000.png", "p_head_can.gif", "p_head_can_0000.png"]
    params, fcfg = load_params_with_config(bench.ARTIFACT_CKPT, "cpu")
    pose = default_360_path(np.zeros(3), np.array([0.0, 1.0, 0.0]), render_canonical_cli.CANONICAL_CAMERA_DIST_VAL,
                            1)[0][0]
    ro, rd = pose2rays(8, 8, pose, device="cpu")
    rcfg = nsr.RenderConfig(num_steps=64, upsample_steps=64, bound=1.6, perturb=False, normal_mode="fd4")
    with torch.no_grad():
        rgb = nsr.render_rays_chunked(params, ro, rd, fcfg, rcfg, 1.0, chunk=24)["rgb"]
    want = integerify_img(rgb.reshape(8, 8, 3).numpy())
    img = _read_png(str(out / "p_body_can_0000.png"))
    assert (img < 250).any()  # the body
    np.testing.assert_array_equal(img, want)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("ckpt,extra,mode", [
    ("artifact", [], "fd4"), ("artifact", ["--normal_mode", "fd7"], "fd7"), ("small", [], "fd7"),
    ("small", ["--normal_mode", "analytic"], "analytic"), ("small", ["--sampler", "fast"], "fd4"),
])
def test_canonical_cli_normal_mode_rule(tmp_path, monkeypatch, ckpt, extra, mode):
    """--normal_mode, else the checkpoint's PROVENANCE.json (the artifact's
    fd4, for both samplers, as the JAX CLI honours it), else fd7 for parity
    and fd4 for fast."""
    seen = []

    def capture(params, fcfg, cfg, *args, **kw):
        seen.append(cfg)
        raise _Stop

    monkeypatch.setattr(render_canonical_cli, "make_parity_frame_renderer", capture)
    monkeypatch.setattr(render_canonical_cli, "make_fast_frame_renderer", capture)
    if ckpt == "artifact":
        if not os.path.exists(bench.ARTIFACT_CKPT):
            pytest.skip("artifact not present")
        path = bench.ARTIFACT_CKPT
    else:
        fcfg = nsr.FieldConfig(encoder="hashgrid", grid=nsr.HashGridSpec(num_levels=2, log2_hashmap_size=6,
                                                                         base_resolution=4, desired_resolution=8))
        path = str(tmp_path / "small.pth.tar")
        save_params_with_config(nsr.init_field_params(torch.Generator().manual_seed(0), fcfg), path, fcfg)
    grid = str(tmp_path / "grid.npy")
    np.save(grid, np.zeros((9, 9, 9), np.float32))
    with pytest.raises(_Stop):
        render_canonical_cli.main(["--weights_path", path, "--use_cuda", "false", "--grid_path", grid,
                                   "--out_dir", str(tmp_path)] + extra)
    sampler = "fast" if "fast" in extra else "parity"
    want_cls = nsr.FastRenderConfig if sampler == "fast" else nsr.RenderConfig
    assert isinstance(seen[0], want_cls) and seen[0].normal_mode == mode
    if sampler == "parity":
        assert (seen[0].num_steps, seen[0].upsample_steps, seen[0].perturb) == (64, 64, False)


@pytest.fixture
def warp_inputs(tmp_path):
    """tests/test_torch_cli.py's one-view 128x128 Blender set and a small
    field saved by the port with its sidecar, at narrow MLP widths (the
    parity frame evaluates 64 samples x 7 taps per ray on the CPU)."""
    from test_torch_dataset import write_blender_set

    rng = np.random.default_rng(0)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 2.5
    write_blender_set(str(tmp_path / "set"), rng.integers(0, 256, size=(1, 128, 128, 3), dtype=np.uint8), [pose])
    fcfg = nsr.FieldConfig(encoder="tpu_pyramid", packed_dtype="float32", hidden_dim=16, hidden_dim_color=16,
                           geo_feat_dim=3, pyramid=nsr.PyramidSpec(grid_resolutions=(4, 8), grid_dim=2,
                                                                   plane_resolutions=(17,), plane_dim=2))
    params = nsr.init_field_params(torch.Generator().manual_seed(0), fcfg)
    params["sdf"][-1]["b"][0] -= 0.3
    ckpt = str(tmp_path / "small.pth.tar")
    save_params_with_config(params, ckpt, fcfg)
    return ["--weights_path", ckpt, "--data_path", str(tmp_path / "set"), "--out_dir", str(tmp_path)]


WARP_ARGS = ["--use_cuda", "false", "--smpl_path", "synthetic", "--render_type", "interp_shape", "--max_frames", "1",
             "--resolution", "128", "--render_view", "0"]


def test_warp_cli_parity_renders_pngs_on_cpu(warp_inputs, tmp_path, monkeypatch):
    """render_warp_cli at its default sampler (parity) writes one PNG per
    frame, the body over the white background, and the frame is the parity
    frame renderer's (itself held against JAX's in
    test_warp_frame_renderer_matches_jax)."""
    from test_torch_guards import _read_png

    seen = []
    real = render_warp_cli.make_warp_frame_renderer

    def recording(*args, **kw):
        render = real(*args, **kw)
        return lambda *a: seen.append(render(*a)) or seen[-1]

    monkeypatch.setattr(render_warp_cli, "make_warp_frame_renderer", recording)
    render_warp_cli.main(warp_inputs + WARP_ARGS + ["--exp_name", "w"])
    out = tmp_path / "test_views" / "w"
    assert sorted(os.listdir(out)) == ["w.gif", "w_0000.png"] and len(seen) == 1
    img = _read_png(str(out / "w_0000.png"))
    assert img.shape == (128, 128, 3)
    assert (img < 250).any() and (img == 255).any()  # the body on a white background
    np.testing.assert_array_equal(img, integerify_img(seen[0].reshape(128, 128, 3).numpy()))
