"""The legacy models of the PyTorch port against the JAX package, on the
CPU: the frequency and SH encoders, NeuS (``models/neus.py``), NeRF
(``models/nerf.py``), ``use_viewdirs`` of the instant-NSR field under both
samplers, and ``render_canonical_cli --implicit_model neus|nerf`` (its
init, its warning line and the flags it does not read). The JAX side runs
under ``jax.jit``; inputs come from numpy generators; the legacy trees are
drawn by the port and carried to JAX as numpy arrays (the JAX inits draw
from ``PRNGKey``s, the port's from ``torch.Generator``s).

Tolerances:
* the encoders and the MLP outputs (``neus_sdf``, ``neus_color``,
  ``nerf_forward``): 1e-5 x max(1, max|JAX|) (f32 sums in other orders;
  sin and cos of arguments up to 2^9 x 1.6 under the NeRF's 10 bands);
* ``raw2outputs`` and ``render_nerf_rays``: 1e-5 on rgb and acc, 1e-4 on
  depth (a sum of weights x z over 128 samples in [1, 4]);
* ``render_rays`` with ``build_neus`` and with a ``use_viewdirs`` field:
  tests/test_torch_render_parity.py's tolerances (rgb and depth 1e-5,
  weights and z values 5e-5); the fast sampler with view directions:
  tests/test_torch_render.py's 2e-3 render pin.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.models import nerf as jnerf
from avatarcraft_tpu.models import neus as jneus
from avatarcraft_tpu.ops import freq_encoder as jfreq
from avatarcraft_tpu.ops.sh_encoder import sh_encode as jax_sh_encode
from avatarcraft_tpu_torch.cli import render_canonical_cli
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.models import nerf, neus
from avatarcraft_tpu_torch.ops import freq_encoder as freq
from avatarcraft_tpu_torch.ops.sh_encoder import sh_encode
from avatarcraft_tpu_torch.utils.checkpoint import map_leaves, params_from_jax
from test_torch_render import RENDER_ATOL, SMALL_JAX_FCFG, _small_field, _small_scene
from test_torch_render_parity import BOUND, _rays

NEUS = neus.NeuSConfig(d_hidden=32, n_layers=4, skip_layer=2, d_feature=32)
JNEUS = jneus.NeuSConfig(**dataclasses.asdict(NEUS))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: tier-1 runs six
    pytest workers on the machine's cores. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree):
    return map_leaves(tree, lambda t: t.detach().numpy())


def _close(got, want, rel=1e-5, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=rel * max(1.0, float(np.abs(want).max())),
                               rtol=0, err_msg=msg)


def _dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode_matches_jax(rng, degree):
    d = _dirs(rng, 300)
    got = sh_encode(_t(d), degree)
    assert got.shape == (300, degree**2)
    _close(got, jax.jit(lambda x: jax_sh_encode(x, degree))(d))


@pytest.mark.parametrize("degree", [0, 9])
def test_sh_encode_degree_check(degree):
    with pytest.raises(ValueError, match=r"degree must be in \[1, 8\]"):
        sh_encode(torch.zeros(2, 3), degree)
    with pytest.raises(ValueError, match=r"degree must be in \[1, 8\]"):
        jax_sh_encode(jnp.zeros((2, 3)), degree)


@pytest.mark.parametrize("multires,include_input", [(4, True), (10, True), (6, False)])
def test_freq_encoders_match_jax(rng, multires, include_input):
    x = rng.uniform(-1.6, 1.6, size=(200, 3)).astype(np.float32)
    assert freq.freq_encode_dim(multires, 3, include_input) == jfreq.freq_encode_dim(multires, 3, include_input)
    got = freq.freq_encode(_t(x), multires, include_input)
    assert got.shape[-1] == freq.freq_encode_dim(multires, 3, include_input)
    _close(got, jax.jit(lambda a: jfreq.freq_encode(a, multires, include_input))(x))
    np.testing.assert_array_equal(freq.rotated_fourier_bvals(multires), jfreq.rotated_fourier_bvals(multires))
    got = freq.freq_encode_rotated(_t(x), multires, include_input)
    _close(got, jax.jit(lambda a: jfreq.freq_encode_rotated(a, multires, include_input))(x))


def test_neus_init_tree_matches_jax_and_is_a_sphere():
    """The port's SAL init has the JAX init's tree, shapes, dtypes and
    structural zeros, and the SDF the JAX package's own test checks
    (tests/test_legacy_models.py:24-35): negative inside the radius-0.5
    sphere, positive and growing outside it, at the narrow width and at
    the reference's 8 x 256."""
    want = jax.tree_util.tree_map(np.asarray, jneus.init_neus_params(jax.random.PRNGKey(0), JNEUS))
    got = neus.init_neus_params(torch.Generator().manual_seed(0), NEUS)
    assert jax.tree_util.tree_structure(_np(got)) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(_np(got)), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    last = got["sdf"][-1]
    assert float(last["b"][0]) == -0.5 and not last["b"][1:].any() and not last["w"][1:].any()
    assert not got["sdf"][0]["w"][:, 3:].any() and got["sdf"][0]["w"][:, :3].all()
    assert not got["sdf"][NEUS.skip_layer]["w"][:, NEUS.d_hidden + 3:].any()
    xs = torch.tensor([[0.0, 0.0, 0.0], [0.2, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.5]])
    for cfg in (NEUS, neus.NeuSConfig()):
        sdf = neus.neus_sdf(neus.init_neus_params(torch.Generator().manual_seed(1), cfg), xs, cfg)[:, 0]
        assert sdf[0] < 0 and sdf[1] < 0 and 0 < sdf[2] < sdf[3]


def test_neus_sdf_and_color_match_jax(rng):
    params = neus.init_neus_params(torch.Generator().manual_seed(0), NEUS)
    # move the weights off their structural zeros so every input counts
    params = map_leaves(params, lambda t: t + 0.05 * torch.randn(t.shape, generator=torch.Generator().manual_seed(3)))
    jp = _np(params)
    x = rng.uniform(-1.2, 1.2, size=(256, 3)).astype(np.float32)
    d, n = _dirs(rng, 256), _dirs(rng, 256)
    feat = rng.normal(size=(256, NEUS.d_feature)).astype(np.float32)
    _close(neus.neus_sdf(params, _t(x), NEUS), jax.jit(lambda p, a: jneus.neus_sdf(p, a, JNEUS))(jp, x))
    _close(neus.neus_color(params, _t(x), _t(d), _t(n), _t(feat), NEUS),
           jax.jit(lambda p, *a: jneus.neus_color(p, *a, JNEUS))(jp, x, d, n, feat))
    field, jfield = neus.build_neus(params, NEUS), jneus.build_neus(jp, JNEUS)
    np.testing.assert_allclose(float(field.inv_s()), float(jfield.inv_s()), rtol=1e-6)


@pytest.mark.parametrize("normal_mode", ["fd7", "fd4"])
def test_render_rays_with_neus_matches_jax(normal_mode):
    """render_rays with field=build_neus(...), no jitter: the SAL sphere
    of the port's init, the rays aimed inside it."""
    params = neus.init_neus_params(torch.Generator().manual_seed(0), NEUS)
    jp = _np(params)
    kw = dict(num_steps=8, upsample_steps=8, upsample_round=4, perturb=False, normal_mode=normal_mode)
    rng = np.random.default_rng(5)
    ro = np.tile(np.asarray([[0.05, -0.1, -2.0]], np.float32), (24, 1))
    rd = rng.uniform(-0.3, 0.3, size=(24, 3)).astype(np.float32) - ro  # aimed inside the sphere
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    want = jax.jit(lambda p, a, b: jnsr.render_rays(
        {}, a, b, jax.random.PRNGKey(0), SMALL_JAX_FCFG, jnsr.RenderConfig(**kw), 1.0,
        field=jneus.build_neus(p, JNEUS)))(jp, ro, rd)
    got = nsr.render_rays({}, _t(ro), _t(rd), None, nsr.RenderConfig(**kw), 1.0, field=neus.build_neus(params, NEUS))
    for k, atol in (("rgb", 1e-5), ("depth", 1e-5), ("weights", 5e-5), ("z_vals", 5e-5)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0, err_msg=k)
    assert float(got["weight_sum"].mean()) > 0.5  # the rays cross the sphere


NERF_KW = dict(depth=4, width=32, skip_layer=2, multires=10)


@pytest.mark.parametrize("mapping,use_viewdirs", [("identity", True), ("rotate", True), ("rotate", False),
                                                  ("identity", False)])
def test_nerf_forward_matches_jax(rng, mapping, use_viewdirs):
    cfg = nerf.NeRFConfig(mapping=mapping, use_viewdirs=use_viewdirs, **NERF_KW)
    jcfg = jnerf.NeRFConfig(**dataclasses.asdict(cfg))
    params = nerf.init_nerf_params(torch.Generator().manual_seed(0), cfg)
    jp = _np(params)
    want_tree = jax.tree_util.tree_map(np.asarray, jnerf.init_nerf_params(jax.random.PRNGKey(0), jcfg))
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(want_tree)
    assert [a.shape for a in jax.tree_util.tree_leaves(jp)] == [a.shape for a in jax.tree_util.tree_leaves(want_tree)]
    x = rng.uniform(-1.6, 1.6, size=(200, 3)).astype(np.float32)
    d = _dirs(rng, 200)
    got = nerf.nerf_forward(params, _t(x), _t(d) if use_viewdirs else None, cfg)
    want = jax.jit(lambda p, a, b: jnerf.nerf_forward(p, a, b, jcfg))(jp, x, d if use_viewdirs else None)
    assert got.shape == (200, 4)
    _close(got, want)


@pytest.mark.parametrize("white_bkg", [True, False])
def test_raw2outputs_matches_jax(rng, white_bkg):
    n, t = 40, 24
    raw = rng.normal(size=(n, t, 4)).astype(np.float32) * 3.0
    z = np.sort(rng.uniform(1.0, 4.0, size=(n, t)).astype(np.float32), axis=-1)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    got = nerf.raw2outputs(_t(raw), _t(z), _t(d), white_bkg=white_bkg)
    want = jax.jit(lambda *a: jnerf.raw2outputs(*a, white_bkg=white_bkg))(raw, z, d)
    for k, atol in (("rgb", 1e-5), ("acc", 1e-5), ("weights", 1e-5), ("depth", 1e-4)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["disp"].numpy(), np.asarray(want["disp"]), rtol=1e-4)


@pytest.mark.parametrize("mapping", ["identity", "rotate"])
def test_render_nerf_rays_matches_jax(mapping):
    cfg = nerf.NeRFConfig(mapping=mapping, **NERF_KW)
    jcfg = jnerf.NeRFConfig(**dataclasses.asdict(cfg))
    params = nerf.init_nerf_params(torch.Generator().manual_seed(0), cfg)
    ro, rd = _rays(16)
    got = nerf.render_nerf_rays(params, _t(ro), _t(rd), cfg)
    want = jax.jit(lambda p, a, b: jnerf.render_nerf_rays(p, a, b, jcfg))(_np(params), ro, rd)
    for k, atol in (("rgb", 1e-5), ("acc", 1e-5), ("depth", 1e-4)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0, err_msg=k)


def _viewdirs_field():
    jfcfg = dataclasses.replace(SMALL_JAX_FCFG, use_viewdirs=True, sh_degree=3)
    jparams = jnsr.init_field_params(jax.random.PRNGKey(0), jfcfg)
    _, small, fcfg = _small_field()
    jparams = {**jax.tree_util.tree_map(np.asarray, jparams), "grids": _np(small["grids"]),
               "planes": _np(small["planes"])}
    jparams["sdf"][-1]["b"] = jparams["sdf"][-1]["b"] - 1.0  # a closed surface, as _surface_field's
    return jparams, params_from_jax(jparams, device="cpu"), jfcfg, dataclasses.replace(fcfg, use_viewdirs=True,
                                                                                         sh_degree=3)


def test_use_viewdirs_matches_jax_under_both_samplers(rng):
    """The color MLP takes [x, sh(d), n, feat] when use_viewdirs: the
    init's wider first color layer, forward_color, the parity render and
    the fast render, each against JAX."""
    jparams, params, jfcfg, fcfg = _viewdirs_field()
    assert fcfg.color_in_dim == jfcfg.color_in_dim == 21 + 9
    port_init = nsr.init_field_params(torch.Generator().manual_seed(0), fcfg)
    assert port_init["color"][0]["v"].shape == jparams["color"][0]["v"].shape == (64, 30)
    x = rng.uniform(-1, 1, size=(128, 3)).astype(np.float32)
    d, n = _dirs(rng, 128), _dirs(rng, 128)
    feat = rng.normal(size=(128, 15)).astype(np.float32)
    _close(nsr.forward_color(params, _t(x), _t(d), _t(n), _t(feat), fcfg),
           jax.jit(lambda p, *a: jnsr.forward_color(p, *a, jfcfg))(jparams, x, d, n, feat))

    kw = dict(num_steps=6, upsample_steps=6, upsample_round=3, perturb=False)
    ro, rd = _rays(32)
    want = jax.jit(lambda p, a, b: jnsr.render_rays(p, a, b, jax.random.PRNGKey(7), jfcfg, jnsr.RenderConfig(**kw),
                                                    1.0))(jparams, ro, rd)
    got = nsr.render_rays(params, _t(ro), _t(rd), fcfg, nsr.RenderConfig(**kw), 1.0)
    for k, atol in (("rgb", 1e-5), ("depth", 1e-5), ("weights", 5e-5), ("z_vals", 5e-5)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0, err_msg=k)
    # the directions reach the color: flipped ones give another frame
    flipped = nsr.render_rays(params, _t(ro), _t(rd), fcfg, nsr.RenderConfig(**kw), field=nsr.FieldFns(
        sdf=lambda p: nsr.forward_sdf(params, p, fcfg, BOUND),
        color=lambda p, dd, nn, ff: nsr.forward_color(params, p, -dd, nn, ff, fcfg),
        inv_s=lambda: nsr.forward_variance(params)))
    assert not torch.equal(flipped["rgb"], got["rgb"])

    grid, o, dd = _small_scene(rng, 48)
    cfg = nsr.FastRenderConfig(n_probes=48, k_samples=8)
    got = nsr.render_rays_fast(params, _t(o), _t(dd), fcfg, cfg, _t(grid), 1.0)
    want = jax.jit(lambda p, a, b, g: jnsr.render_rays_fast(p, a, b, jfcfg, jnsr.FastRenderConfig(n_probes=48,
                                                                                                   k_samples=8),
                                                            g, 1.0))(jparams, o, dd, grid)
    for k in ("rgb", "depth", "weight_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=RENDER_ATOL, rtol=0, err_msg=k)


def test_canonical_cli_legacy_init_and_unread_flags(tmp_path, monkeypatch, capsys):
    """Without an orbax directory the legacy branches render the model's
    init (the port's generator, seeded 0) and print the JAX CLI's warning
    line. The NeRF branch builds NeRFConfig(mapping=--can_posenc) alone:
    like the JAX CLI, it reads neither --nerf_depth, --nerf_width nor
    --use_viewdirs (the frames with and without them are equal)."""
    seen = []
    tiny_nerf = functools.partial(nerf.NeRFConfig, depth=2, width=16, skip_layer=1, multires=4)

    def spy(**kw):
        seen.append(kw)
        return tiny_nerf(**kw)

    monkeypatch.setattr(render_canonical_cli, "NeRFConfig", spy)
    monkeypatch.setattr(render_canonical_cli, "NeuSConfig", lambda: NEUS)
    base = ["--use_cuda", "false", "--render_h", "8", "--render_w", "8", "--trajectory_resolution", "1",
            "--batch_size", "64", "--out_dir", str(tmp_path)]
    frames = {}
    for name, extra in (("nerf", []), ("nerf_flags", ["--nerf_depth", "2", "--nerf_width", "16",
                                                      "--use_viewdirs", "false"]), ("neus", [])):
        model = name.split("_")[0]
        render_canonical_cli.main(base + ["--implicit_model", model, "--exp_name", name] + extra)
        png = tmp_path / "canonical_360" / name / f"{name}_body_can_0000.png"
        frames[name] = png.read_bytes()
    out = capsys.readouterr().out
    assert "[render] WARNING: no orbax NeRF checkpoint; random init" in out
    assert "[render] WARNING: no orbax NeuS checkpoint; SAL sphere init" in out
    assert seen == [{"mapping": "rotate"}] * 2
    assert frames["nerf"] == frames["nerf_flags"]
