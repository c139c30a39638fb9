"""The animate / reshape workload of the PyTorch port against the JAX
package, on the CPU: calc_local_trans, the AMASS conversion, the derived
warp budget, the fast warped frame of the committed artifact, and the
styled product (the lava delta applied, animated and rendered) against the
committed golden frame.

Tolerances:
- calc_local_trans: 2e-5 on transforms and vertices (SMPL in f32 on both
  sides, composed in numpy f32 on both), and the goldens of
  tests/test_warp_render.py at their own 2e-5;
- the AMASS conversion and the derived budget: equal;
- a 32x32 warped frame of the artifact: 2e-3 against JAX (CARD_VS_CPU_ATOL
  of chip_smoke.py; the budgeted and the unbudgeted render_rays_fast), the
  bf16 tables round the same values on both sides, the kNN may resolve
  near-ties to another face;
- the styled frame: 2e-3 against tests/golden_styled_warp_32.npy, the pin
  tests/test_styled_warp.py holds the JAX package to; the style delta's
  leaves equal the JAX package's apply exactly;
- render_rays_fast with an injected analytic field and per-ray near/far:
  1e-5 (f32 arithmetic in other orders, no tables).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.cameras import pose2rays as jax_pose2rays
from avatarcraft_tpu.data import amass as jamass
from avatarcraft_tpu.models import smpl as jsmpl
from avatarcraft_tpu.utils.checkpoint import load_params_with_config as jax_load_params_with_config
from avatarcraft_tpu.warp import WarpData as JaxWarpData
from avatarcraft_tpu.workloads import warp_render as jwr
from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.cameras import pose2rays
from avatarcraft_tpu_torch.data import amass
from avatarcraft_tpu_torch.models import smpl as tsmpl
from avatarcraft_tpu_torch.utils.checkpoint import load_params_with_config, sorted_leaves
from avatarcraft_tpu_torch.utils.style_delta import apply_delta
from avatarcraft_tpu_torch.warp import WarpData
from avatarcraft_tpu_torch.workloads import warp_render as twr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DELTA = os.path.join(REPO, "artifacts", "styled", "multi_lava_delta.npz")
GOLDEN = os.path.join(REPO, "tests", "golden_styled_warp_32.npy")
RES = 32
FRAME_ATOL = 2e-3
SYNTH = tsmpl.synthetic_smpl_params(0, n_verts=48, n_joints=24)
JSYNTH = jsmpl.synthetic_smpl_params(0, n_verts=48, n_joints=24)

needs_artifacts = pytest.mark.skipif(
    not all(os.path.exists(p) for p in (bench.ARTIFACT_CKPT, bench.RIG, bench.POSES, DELTA, GOLDEN)),
    reason="committed artifacts not present",
)


def _close_frames(got, want, atol=2e-5):
    (gv, gT, gn), (wv, wT, wn) = got, want
    assert gn == wn and len(gv) == len(wv) == len(gT) == len(wT) == gn
    for a, b in zip(gv + gT, wv + wT):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_da_pose_equal():
    np.testing.assert_array_equal(twr.da_pose(72), jwr.da_pose(72))
    np.testing.assert_array_equal(twr.da_pose(21), jwr.da_pose(21))


@pytest.mark.parametrize("rest_pose", ["da", "zero"])
def test_calc_local_trans_animate(rest_pose):
    poses = np.random.default_rng(5).normal(scale=0.3, size=(3, 24, 3)).astype(np.float32)
    _close_frames(twr.calc_local_trans(SYNTH, poses=poses, max_frames=3, rest_pose=rest_pose),
                  jwr.calc_local_trans(JSYNTH, poses=poses, max_frames=3, rest_pose=rest_pose))


@pytest.mark.parametrize("rest_pose", ["da", "zero"])
def test_calc_local_trans_interp_shape(rest_pose):
    rng = np.random.default_rng(6)
    shape_from = rng.normal(size=(1, 10)).astype(np.float32)
    _close_frames(
        twr.calc_local_trans(SYNTH, render_type="interp_shape", shape_from=shape_from, max_frames=4,
                             rest_pose=rest_pose),
        jwr.calc_local_trans(JSYNTH, render_type="interp_shape", shape_from=shape_from, max_frames=4,
                             rest_pose=rest_pose),
    )
    _close_frames(twr.calc_local_trans(SYNTH, render_type="interp_shape", max_frames=10, rest_pose=rest_pose),
                  jwr.calc_local_trans(JSYNTH, render_type="interp_shape", max_frames=10, rest_pose=rest_pose))


def test_calc_local_trans_refuses_unknown():
    with pytest.raises(ValueError, match="pose sequence"):
        twr.calc_local_trans(SYNTH, render_type="animate")
    with pytest.raises(NotImplementedError):
        twr.calc_local_trans(SYNTH, render_type="dance")


def test_animate_zero_rest_pose_identity_and_golden():
    """tests/test_warp_render.py:199-245 reproduced by the port: the
    identity frame and the pinned mid-wave frame of the demo pose tool."""
    sys.path.insert(0, REPO)
    from tools.make_demo_poseseq import make_wave_sequence

    rng = np.random.default_rng(3)
    V, J, B = 60, 7, 4
    v = rng.uniform(-0.4, 0.4, (V, 3)).astype(np.float32)
    v[:, 1] = np.linspace(-0.8, 0.8, V)
    w = rng.dirichlet(np.ones(J) * 0.5, V).astype(np.float32)
    reg = rng.dirichlet(np.ones(V) * 0.5, J).astype(np.float32)
    model = tsmpl.SMPLParams(
        v_template=v, shapedirs=np.zeros((V, 3, B), np.float32), posedirs=np.zeros(((J - 1) * 9, V * 3), np.float32),
        J_regressor=reg, parents=np.array([-1, 0, 1, 1, 1, 0, 0], np.int32), lbs_weights=w,
        faces=np.stack([np.arange(V - 2), np.arange(1, V - 1), np.arange(2, V)], 1).astype(np.int32),
    )
    wv, Ts, n = twr.calc_local_trans(model, render_type="animate", poses=make_wave_sequence(12), max_frames=12,
                                     rest_pose="zero")
    assert n == 12
    np.testing.assert_allclose(wv[0], v, atol=1e-6)
    np.testing.assert_allclose(wv[7][0], [-0.406849, -0.766187, 0.191712], atol=2e-5)
    np.testing.assert_allclose(wv[7][30], [0.147257, -0.002716, 0.082188], atol=2e-5)
    np.testing.assert_allclose(Ts[7][5, 0], [1.095582, 0.095794, -0.083089, 0.011829], atol=2e-5)


def test_amass_equal(tmp_path):
    poses = np.random.default_rng(0).normal(size=(55, 156)).astype(np.float32)
    np.testing.assert_array_equal(amass.convert_amass_poses(poses, 10), jamass.convert_amass_poses(poses, 10))
    np.testing.assert_array_equal(amass.convert_amass_poses(poses, 3), jamass.convert_amass_poses(poses, 3))
    src = str(tmp_path / "seq.npz")
    np.savez(src, poses=poses)
    got = amass.convert_amass_file(src, str(tmp_path / "port.npy"), stride=4)
    want = jamass.convert_amass_file(src, str(tmp_path / "jax.npy"), stride=4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(amass.load_pose_sequence(str(tmp_path / "port.npy")),
                                  jamass.load_pose_sequence(str(tmp_path / "jax.npy")))


@pytest.fixture(scope="module")
def artifact():
    """The artifact on both sides and demo frames 9-11 of the demo rig (JAX
    model, world_verts, Ts)."""
    if not all(os.path.exists(p) for p in (bench.ARTIFACT_CKPT, bench.RIG, bench.POSES, DELTA, GOLDEN)):
        pytest.skip("committed artifacts not present")
    model = jsmpl.load_smpl(bench.RIG)
    wv, Ts, _ = jwr.calc_local_trans(model, poses=np.load(bench.POSES)[9:12], max_frames=3, rest_pose="zero")
    return {
        "port": load_params_with_config(bench.ARTIFACT_CKPT, "cpu"),
        "jax": jax_load_params_with_config(bench.ARTIFACT_CKPT),
        "model": model, "world_verts": wv, "Ts": Ts,
    }


def _rays():
    port = pose2rays(RES, RES, bench.warp_view(), device="cpu")
    jax_rays = jax_pose2rays(RES, RES, bench.warp_view())
    np.testing.assert_allclose(port[1].numpy(), np.asarray(jax_rays[1]), atol=1e-6)
    return port, jax_rays


@needs_artifacts
def test_derive_warp_budget_equal(artifact):
    (ro, rd), (jro, jrd) = _rays()
    chunk = RES * RES // 4  # 4 chunks per frame, 3 frames
    got = twr.derive_warp_budget(artifact["world_verts"], ro, rd, twr.WarpRenderSettings(chunk=chunk))
    want = jwr.derive_warp_budget(artifact["world_verts"], jro, jrd, jwr.WarpRenderSettings(chunk=chunk))
    assert got == want > 0


def _port_frame(params, fcfg, wv, Ts, faces, budget):
    ro, rd = pose2rays(RES, RES, bench.warp_view(), device="cpu")
    render = twr.make_warp_frame_renderer_fast(params, fcfg, twr.WarpRenderSettings(chunk=RES * RES), budget)
    return render(ro, rd, WarpData.create(wv, faces, Ts, "cpu")).numpy().reshape(RES, RES, 3)


@needs_artifacts
@pytest.mark.parametrize("budgeted", [True, False])
def test_warp_frame_matches_jax(artifact, budgeted):
    """Demo frame 10 at 32x32; budgeted: the derived budget (the compacted
    survivors warped as one pseudo-ray); unbudgeted: a budget of every slot,
    so render_rays_fast warps the [N, K] samples ray by ray."""
    (params, fcfg), (jparams, jfcfg) = artifact["port"], artifact["jax"]
    wv, Ts, faces = artifact["world_verts"][1], artifact["Ts"][1], artifact["model"].faces
    settings = jwr.WarpRenderSettings(chunk=RES * RES)
    _, (jro, jrd) = _rays()
    budget = jwr.derive_warp_budget([wv], jro, jrd, settings) if budgeted else RES * RES * twr.K_SAMPLES
    want = np.asarray(jwr.make_warp_frame_renderer_fast(jfcfg, settings, 1.0, sample_budget=budget)(
        jparams, jro, jrd, JaxWarpData.create(wv, faces, Ts))).reshape(RES, RES, 3)
    got = _port_frame(params, fcfg, wv, Ts, faces, budget if budgeted else 0)
    assert np.isfinite(got).all() and (got < 0.9).any()  # the body, on a white background
    np.testing.assert_allclose(got, want, rtol=0, atol=FRAME_ATOL)


@needs_artifacts
def test_renderer_refuses_ragged_chunks(artifact):
    params, fcfg = artifact["port"]
    render = twr.make_warp_frame_renderer_fast(params, fcfg, twr.WarpRenderSettings(chunk=100), 1000)
    ro, rd = pose2rays(RES, RES, bench.warp_view(), device="cpu")
    wd = WarpData.create(artifact["world_verts"][1], artifact["model"].faces, artifact["Ts"][1], "cpu")
    with pytest.raises(ValueError, match="not a whole number"):
        render(ro, rd, wd)


@needs_artifacts
def test_style_delta_leaves_match_jax(artifact):
    """The delta's leaf indices count in JAX's sorted-key order: the port's
    apply lands every entry (dense:0..5 on the color MLP, idx/val:6..11 on
    the tables, dense:12..18 on the SDF MLP and the variance) on the same
    tensor as tests/test_styled_warp.py's apply, value for value."""
    from test_styled_warp import _styled_params_and_fcfg

    styled, fcfg, grid = apply_delta(artifact["port"][0], DELTA)
    jstyled, jfcfg, _ = _styled_params_and_fcfg()
    got, want = sorted_leaves(styled), jax.tree_util.tree_leaves(jstyled)
    assert len(got) == len(want) == 19
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"leaf {i}")
    with np.load(DELTA) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        np.testing.assert_array_equal(grid, z["grid"].astype(np.float32))
    assert [t["path"] for t in meta["tensors"][:7]][6] == "['grids'][0]"
    assert styled["grids"][0].shape == (32, 32, 32, 4) and list(styled) == list(artifact["port"][0])
    assert fcfg == artifact["port"][1]


@needs_artifacts
def test_styled_warp_golden_frame(artifact):
    """tests/test_styled_warp.py for the port: the lava delta applied by the
    port, demo frame 10 animated and rendered at 32x32 with the derived
    budget, against the committed golden; red-dominant foreground; differs
    from the bare field through the same renderer."""
    params, fcfg = artifact["port"]
    styled, sfcfg, _ = apply_delta(params, DELTA)
    model = tsmpl.load_smpl(bench.RIG)
    wv, Ts, _ = twr.calc_local_trans(model, poses=np.load(bench.POSES)[10:11], max_frames=1, rest_pose="zero")
    ro, rd = pose2rays(RES, RES, bench.warp_view(), device="cpu")
    budget = twr.derive_warp_budget(wv, ro, rd, twr.WarpRenderSettings(chunk=RES * RES))
    img = _port_frame(styled, sfcfg, wv[0], Ts[0], model.faces, budget)
    assert np.isfinite(img).all()
    fg = img[np.abs(img - 1.0).sum(-1) > 0.15]
    assert fg.shape[0] > 30, "frame must contain foreground"
    assert float(fg[:, 0].mean()) > float(fg[:, 2].mean()) + 0.1, "lava foreground must be red-dominant"
    bare = _port_frame(params, fcfg, wv[0], Ts[0], model.faces, budget)
    assert float(np.abs(img - bare).mean()) > 0.01
    np.testing.assert_allclose(img, np.load(GOLDEN), rtol=0, atol=FRAME_ATOL)


@pytest.mark.parametrize("budget", [0, 300])
def test_render_rays_fast_field_and_near_far_match_jax(budget):
    """render_rays_fast with an injected analytic field (a sphere of radius
    0.5, colour from position) and per-ray near/far that replace the cube
    bounds where finite, against the JAX package's; within 1e-5 (f32
    arithmetic in other orders, no tables)."""
    from avatarcraft_tpu.models import instant_nsr as jnsr
    from avatarcraft_tpu_torch.models import instant_nsr as nsr

    rng = np.random.default_rng(1)
    n = 64
    ro = np.concatenate([rng.normal(scale=0.2, size=(n, 2)), np.full((n, 1), 1.4)], 1).astype(np.float32)
    rd = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    near = rng.uniform(0.3, 0.6, size=(n, 1)).astype(np.float32)
    far = (near + 1.5).astype(np.float32)
    near[::3], far[::4] = np.inf, -np.inf  # fall back to the cube bounds
    grid = np.full((17, 17, 17), 50.0, np.float32)
    cfg = dict(n_probes=48, k_samples=12, bound=1.6, sample_budget=budget)

    def tfield(x):
        return torch.cat([torch.linalg.norm(x, dim=-1, keepdim=True) - 0.5, torch.zeros_like(x)], -1)

    def jfield(x):
        return jnp.concatenate([jnp.linalg.norm(x, axis=-1, keepdims=True) - 0.5, jnp.zeros_like(x)], -1)

    port = nsr.FieldFns(sdf=tfield, color=lambda x, d, nn, f: torch.sigmoid(x + nn), inv_s=lambda: torch.tensor(20.0))
    ref = jnsr.FieldFns(sdf=jfield, color=lambda x, d, nn, f: jax.nn.sigmoid(x + nn), inv_s=lambda: jnp.asarray(20.0))
    got = nsr.render_rays_fast(None, torch.as_tensor(ro), torch.as_tensor(rd), None, nsr.FastRenderConfig(**cfg),
                               torch.as_tensor(grid), 0.5, port, (torch.as_tensor(near), torch.as_tensor(far)))
    want = jax.jit(lambda o, d, g, nf: jnsr.render_rays_fast(None, o, d, None, jnsr.FastRenderConfig(**cfg), g, 0.5,
                                                             ref, nf))(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(grid), (jnp.asarray(near), jnp.asarray(far)))
    for k in ("rgb", "depth", "weights", "weight_sum", "normal", "gradient_error"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)
    assert float(got["weight_sum"].max()) > 0.5  # rays cross the sphere
