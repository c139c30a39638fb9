"""The port's stylize CLI against the JAX package's, on the CPU: the
derived sample budget on the committed artifact (exact, at 128x128 and
64x64), its refusals (each writes nothing), ``--implicit_model`` parsed
and not read as in the JAX package,
and two-step CPU runs of the fast sampler whose final checkpoints load: with the stand-in
guidance, with Stable Diffusion loaded by --sd_weights from tiny
state-dict files, and with --i_mesh exports (the lattice patched from
512^3 to 16^3) whose .ply bytes equal the JAX package's save_ply of the
same mesh, which is the JAX package's native extraction of its own
lattice (the lattice within 1e-5 absolute, the triangles exactly, the
vertices within 1e-4)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.cli import stylize_cli as jcli
from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.ops.grid_encoder import PyramidSpec as JaxPyramidSpec
from avatarcraft_tpu.workloads import stylize as jsty
from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.cli import stylize_cli
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.ops import occupancy as occ
from avatarcraft_tpu_torch.utils.checkpoint import leaves, load_params_with_config, map_leaves, params_from_jax
from avatarcraft_tpu_torch.workloads import stylize
from avatarcraft_tpu_torch.workloads.reconstruct import make_grid_update_fn

needs_artifact = pytest.mark.skipif(
    not (os.path.exists(bench.ARTIFACT_CKPT) and os.path.exists(bench.ARTIFACT_GRID)),
    reason="artifact not present",
)
JAX_FCFG = jnsr.FieldConfig(
    encoder="tpu_pyramid",
    pyramid=JaxPyramidSpec(grid_resolutions=(4, 8), grid_dim=2, plane_resolutions=(17,), plane_dim=2),
    packed_dtype="float32",
)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: tier-1 runs six
    pytest workers on the machine's cores, and workers whose torch ops each
    spread over every core oversubscribe it (a CPU-heavy test then runs up
    to ten times slower than alone). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifact():
    params, fcfg, grid, cfg = bench.load_artifact("cpu")
    return params, fcfg, grid, cfg


def _small_field():
    """A small field with a surface whose SDF depends on its tables, as
    the port's tree with its FieldConfig."""
    rng = np.random.default_rng(0)
    jparams = jnsr.init_field_params(jax.random.PRNGKey(0), JAX_FCFG)
    for key in ("grids", "planes"):
        jparams[key] = [jnp.asarray(rng.normal(size=t.shape).astype(np.float32) * 0.3) for t in jparams[key]]
    v = rng.normal(size=jparams["sdf"][0]["v"].shape).astype(np.float32) * 0.3
    jparams["sdf"][0] = {**jparams["sdf"][0], "v": jnp.asarray(v), "g": jnp.linalg.norm(v, axis=1)}
    jparams["sdf"][-1]["b"] = jparams["sdf"][-1]["b"].at[0].add(-1.0)
    fcfg = nsr.FieldConfig(**{
        **dataclasses.asdict(JAX_FCFG),
        "grid": nsr.HashGridSpec(**dataclasses.asdict(JAX_FCFG.grid)),
        "pyramid": nsr.PyramidSpec(**dataclasses.asdict(JAX_FCFG.pyramid)),
    })
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"), fcfg


@pytest.fixture(scope="module")
def refreshed_grid(artifact):
    """The grid the CLI derives its budget from by default: the artifact's
    field refreshed into an empty grid."""
    params, fcfg, _, cfg = artifact
    return make_grid_update_fn(fcfg, cfg.bound)(params, occ.init_density_grid(129))


@needs_artifact
@pytest.mark.parametrize("res,chunk", [(128, 4096), (64, 1024)])
def test_derive_sample_budget_matches_jax(artifact, refreshed_grid, res, chunk):
    """The schedule's 48 poses at res x res in chunk-ray calls (the CLI's
    256x256 frames cost four times the 128x128 case's 12 s here; the
    function is the same at every size)."""
    _, _, _, cfg = artifact
    probe = dataclasses.replace(cfg, sample_budget=0)
    scfg, jscfg = stylize.StylizeConfig(H=res, W=res), jsty.StylizeConfig(H=res, W=res)
    got = stylize_cli.derive_sample_budget(scfg, refreshed_grid, probe, chunk)
    want = jcli.derive_sample_budget(jscfg, jnp.asarray(refreshed_grid.numpy()),
                                     jnsr.FastRenderConfig(**dataclasses.asdict(probe)), chunk)
    assert got == want and 0 < got < chunk * probe.k_samples


# --sampler parity and --encoder hashgrid, refused here before the parity
# pipeline was ported, run in tests/test_torch_parity_stylize.py
# --implicit_model neus, refused here before the legacy models were ported,
# is parsed and not read, as in the JAX package: test_cli_implicit_model_is_not_read
REFUSALS = [
    (["--guidance_type", "clip"], "JAX package refuses"),
    (["--guidance_type", "toy", "--tgt_text", "zombie", "--i_mesh", "100000"], "trained toy style"),
]


def test_cli_implicit_model_is_not_read(tmp_path, monkeypatch, capsys):
    """--implicit_model neus: the JAX package's stylize CLI parses the flag
    and never reads it (cli/stylize_cli.py:37, it always stylizes the
    instant-NSR field); the port says so in one line and sets up the same
    run as without the flag (setup stopped before it loads anything)."""
    import inspect

    base = ["--weights_path", bench.ARTIFACT_CKPT, "--use_cuda", "false", "--out_dir", str(tmp_path / "out")]
    assert jcli.build_parser().parse_args(base + ["--implicit_model", "neus"]).implicit_model == "neus"
    assert "implicit_model" not in inspect.getsource(jcli.main)
    seen = []

    class Stop(Exception):
        pass

    def setup(opt, *a, **k):
        seen.append(vars(opt).copy())
        raise Stop

    monkeypatch.setattr(stylize_cli, "setup", setup)
    for extra in ([], ["--implicit_model", "neus"]):
        with pytest.raises(Stop):
            stylize_cli.main(base + extra)
    assert "[stylize] --implicit_model neus has no effect here" in capsys.readouterr().out
    assert seen[1].pop("implicit_model") == "neus" and seen[0].pop("implicit_model") == "instant_nsr"
    assert seen[0] == seen[1]


@pytest.mark.parametrize("argv,msg", REFUSALS)
def test_cli_refusals_write_nothing(tmp_path, argv, msg):
    out = tmp_path / "out"
    base = ["--weights_path", bench.ARTIFACT_CKPT, "--use_cuda", "false", "--out_dir", str(out)]
    with pytest.raises(SystemExit, match=msg):
        stylize_cli.main(base + argv)
    assert not out.exists()


def _cli_run(tmp_path, *extra):
    """A two-step CPU run of the CLI's fast sampler on a small field, its
    density grid from --grid_path and a small explicit budget; (trainer,
    the field)."""
    params, fcfg = _small_field()
    from avatarcraft_tpu_torch.utils.checkpoint import save_params_with_config

    ckpt = str(tmp_path / "field.pth.tar")
    save_params_with_config(params, ckpt, fcfg)
    grid_path = str(tmp_path / "grid.npy")
    np.save(grid_path, np.where(np.random.default_rng(0).random((17, 17, 17)) < 0.4, 50.0, 0.5).astype(np.float32))
    trainer = stylize_cli.main([
        "--weights_path", ckpt, "--use_cuda", "false", "--out_dir", str(tmp_path / "out"), "--exp_name", "t",
        "--max_steps", "2", "--i_val", "100", "--i_mesh", "100000", "--sample_budget", "4096",
        "--grid_path", grid_path, "--sampler", "fast", *extra,
    ])
    return trainer, params, fcfg


def _assert_final_checkpoint(out, trainer, params, fcfg):
    files = sorted(os.listdir(out / "t"))
    assert files == ["t_args.txt", "t_final.pth.tar", "t_final.pth.tar.fieldcfg.json"]
    loaded, lcfg = load_params_with_config(str(out / "t" / "t_final.pth.tar"), device="cpu")
    assert dataclasses.asdict(lcfg) == dataclasses.asdict(fcfg)
    for a, b in zip(leaves(loaded), leaves(trainer.params())):
        assert torch.equal(a, b)
    assert not torch.equal(loaded["sdf"][0]["v"], params["sdf"][0]["v"])  # the style moved


def test_cli_runs_with_sd_weights_on_cpu(tmp_path, monkeypatch):
    """--sd_weights: Stable Diffusion 1.5 loaded through the loader from
    unet.pt, vae.pt, text_encoder.pt and tokenizer/ written at the tiny
    width (the loader takes the tiny geometry and a 32x32 image size in
    place of SD 1.5's, which these files do not have), two SDS steps on
    the CPU, the final checkpoint written."""
    from functools import partial

    from avatarcraft_tpu_torch.models import sd
    from tests.test_torch_sd import _write_sd_files

    sd_dir = tmp_path / "sd"
    sd_dir.mkdir()
    jcfgs = _write_sd_files(sd_dir, "1.5")
    pcfgs = [cls(**dataclasses.asdict(c)) for cls, c in zip((sd.UNetConfig, sd.VAEConfig, sd.CLIPTextConfig), jcfgs)]
    calls = []

    def load(path, version, device):
        calls.append((path, version, device))
        return partial(sd.load_stable_diffusion_modules, unet_config=pcfgs[0], vae_config=pcfgs[1],
                       clip_config=pcfgs[2], image_size=32)(path, version, device=device)

    monkeypatch.setattr(stylize_cli, "load_stable_diffusion_modules", load)
    trainer, params, fcfg = _cli_run(tmp_path, "--sd_weights", str(sd_dir))
    assert calls == [(str(sd_dir), "1.5", "cpu")]
    m = trainer.guidance.m
    assert m.image_size == 32 and m.latent_scale == 2 and m.tokenizer is not None and not m.use_depth
    _assert_final_checkpoint(tmp_path / "out", trainer, params, fcfg)


@pytest.mark.parametrize("i_mesh,steps", [("1", (1, 2)), ("2", (2,))])
def test_cli_exports_meshes(tmp_path, monkeypatch, i_mesh, steps):
    """The CLI refuses no --i_mesh (its default command line, 6,000 steps
    with --i_mesh 1000, passes) and exports a mesh on every i_mesh-th step:
    extract_geometry at MESH_RESOLUTION^3 (patched to 16^3 here) through
    the native extractor, then save_ply. The last export, of the final
    parameters, is byte for byte the JAX package's save_ply of the same
    mesh, and that mesh is the JAX package's native extraction of its own
    lattice of those parameters (triangles exactly, vertices within
    1e-4)."""
    from avatarcraft_tpu.models import instant_nsr as jnsr_
    from avatarcraft_tpu.utils import mesh_export as jmesh
    from avatarcraft_tpu.utils import native as jnative

    default = stylize_cli.build_parser().parse_args(["--weights_path", bench.ARTIFACT_CKPT, "--use_cuda", "false"])
    assert default.i_mesh == 1000 and stylize_cli.refusal(default) is None
    monkeypatch.setattr(stylize_cli, "MESH_RESOLUTION", 16)
    trainer, params, fcfg = _cli_run(tmp_path, "--i_mesh", i_mesh)
    exp = tmp_path / "out" / "t"
    plys = sorted(f for f in os.listdir(exp) if f.endswith(".ply"))
    assert plys == [f"t_{s:04d}.ply" for s in steps]
    final = map_leaves(trainer.params(), lambda t: t.numpy())
    jparams = jax.tree_util.tree_map(jnp.asarray, final)
    lattice = jnsr_.extract_sdf_grid(jparams, JAX_FCFG, 1.6, 16)
    np.testing.assert_allclose(nsr.extract_sdf_grid(trainer.params(), fcfg, 1.6, 16), lattice, atol=1e-5, rtol=0)
    verts, faces = nsr.extract_geometry(trainer.params(), fcfg, 1.6, 16)
    jv, jt = jnative.native_marching_cubes(-np.asarray(lattice), 0.0)
    assert len(faces) > 0
    np.testing.assert_array_equal(faces, jt)
    want = str(tmp_path / "jax.ply")
    jmesh.save_ply(verts, faces, want)
    assert (exp / plys[-1]).read_bytes() == open(want, "rb").read()
    np.testing.assert_allclose(verts, jv / 15.0 * 3.2 - 1.6, atol=1e-4, rtol=0)


def test_cli_runs_on_cpu(tmp_path):
    """A two-step CPU run of the CLI on a small field with the stand-in
    guidance, its density grid from --grid_path and a small explicit
    budget (the CPU's cost; the derived budget and the grid refreshed from
    the field are held above and run on the card in chip_smoke.py's
    stylize phase, which also checks the validation PNG): the options file
    and the final checkpoint, which loads as the trainer's parameters."""
    trainer, params, fcfg = _cli_run(tmp_path)
    assert trainer.fast_cfg.normal_mode == "fd4"  # no PROVENANCE.json beside the checkpoint
    assert trainer.fast_cfg.sample_budget == 4096 and tuple(trainer.grid.shape) == (17, 17, 17)
    _assert_final_checkpoint(tmp_path / "out", trainer, params, fcfg)
