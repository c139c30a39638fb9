"""How far the parity pipeline's own results move under one-ulp changes of
their inputs, on the CPU: the measurements behind the tolerances of
tests/test_torch_parity_render.py, tests/test_torch_parity_stylize.py and
chip_smoke.py's parity checks. Not a test; run it from the repository root:

    JAX_PLATFORMS=cpu python tests/parity_sensitivity.py

Each line prints, for the JAX package (jitted) or the port, the largest
change of an output when its parameters (or the posed vertices) are
multiplied by 1 +- 2^-23, elementwise with random signs (three draws), or
when the JAX side runs eagerly instead of jitted.
"""

import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRIALS = 3


def _ulp_np(tree, rng):
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * (1 + rng.choice([-1, 1], size=np.shape(a)) * 2.0**-23)).astype(np.asarray(a).dtype),
        tree)


def _ulp_torch(tree, gen):
    from avatarcraft_tpu_torch.utils.checkpoint import map_leaves

    def one(t):
        s = torch.randint(0, 2, t.shape, generator=gen).double() * 2 - 1
        return (t.double() * (1 + s * 2.0**-23)).float()

    return map_leaves(tree, one)


def _rel(a, b):
    """Per leaf max|a - b| / max|b| of two gradient trees."""
    out = {}
    for (p, x), (_, y) in zip(jax.tree_util.tree_flatten_with_path(a)[0], jax.tree_util.tree_flatten_with_path(b)[0]):
        y = np.asarray(y)
        out[jax.tree_util.keystr(p)] = float(np.abs(np.asarray(x) - y).max() / np.abs(y).max())
    return out


def warp_render():
    """JAX's render_rays with the warp on tests/test_torch_parity_render.py's
    sphere body, params perturbed."""
    import test_torch_parity_render as T
    from avatarcraft_tpu.models import instant_nsr as jnsr
    from avatarcraft_tpu.warp import WarpData, make_warp_fn

    rng = np.random.default_rng(1)
    for kind in ("pyramid", "hash"):
        jparams, _, jfcfg, _, _ = T._fields(kind)
        rcfg = jnsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=3, perturb=False)
        ro, rd = T._rays(32)
        Ts, posed, faces = T._sphere_body()
        warp = make_warp_fn(WarpData.create(posed, faces, Ts))
        f = jax.jit(lambda p, a, b: jnsr.render_rays(p, a, b, jax.random.PRNGKey(7), jfcfg, rcfg, 1.0, warp_fn=warp))
        base = f(jparams, ro, rd)
        worst = {}
        for _ in range(TRIALS):
            out = f(_ulp_np(jparams, rng), ro, rd)
            for k in ("rgb", "depth", "weights", "z_vals"):
                worst[k] = max(worst.get(k, 0.0), float(np.abs(np.asarray(out[k]) - np.asarray(base[k])).max()))
        print(f"JAX render_rays with the warp, {kind} field, one ulp of the parameters: {worst}")


def phase_b():
    """JAX's parity phase B on tests/test_torch_parity_stylize.py's data:
    params perturbed, and (bf16) eager against jitted."""
    import test_torch_parity_stylize as S
    from avatarcraft_tpu.workloads import stylize as jsty

    for enc, dt, opacity in (("tpu_pyramid", "float32", True), ("tpu_pyramid", "float32", False),
                             ("hashgrid", "float32", True), ("tpu_pyramid", "bfloat16", True)):
        rng = np.random.default_rng(42)  # the tests' rng fixture
        jcfg, _, jparams, jgt = S._fields(enc, dt)
        _, o, d = S._scene(rng, 128)
        g_rgb = rng.normal(size=(128, 3)).astype(np.float32) * 0.1
        bg = rng.random((128, 3)).astype(np.float32)
        tx = S._grad_store()
        step = jsty.make_phaseB_step(jcfg, S.JAX_RCFG, tx, 0.01, opacity, 32, 1e5)
        run = lambda p: step(p, jgt, tx.init(p), o, d, g_rgb, bg, jax.random.PRNGKey(0))[1]  # noqa: E731
        base = run(jparams)
        prng, worst = np.random.default_rng(1), {}
        for _ in range(TRIALS):
            for k, v in _rel(run(_ulp_np(jparams, prng)), base).items():
                worst[k] = max(worst.get(k, 0.0), v)
        k = max(worst, key=worst.get)
        line = f"JAX phase B {enc} {dt} opacity={opacity}, one ulp of the parameters: worst leaf {k} {worst[k]:.3g}"
        if dt == "bfloat16":
            with jax.disable_jit():
                eager = _rel(run(jparams), base)
            tables = max(v for k, v in eager.items() if k.startswith(("['grids']", "['planes']")))
            mlp = max(v for k, v in eager.items() if not k.startswith(("['grids']", "['planes']")))
            line += f"; eager against jitted: tables {tables:.3g}, MLP leaves {mlp:.3g}"
        print(line)


def warp_frame():
    """JAX's parity warp frame of the artifact (demo frame 10, 16x16):
    params and posed vertices perturbed."""
    from avatarcraft_tpu.cameras import pose2rays
    from avatarcraft_tpu.models import smpl
    from avatarcraft_tpu.utils.checkpoint import load_params_with_config
    from avatarcraft_tpu.warp import WarpData
    from avatarcraft_tpu.workloads import warp_render
    from avatarcraft_tpu_torch import bench

    model = smpl.load_smpl(bench.RIG)
    wv, Ts, _ = warp_render.calc_local_trans(model, poses=np.load(bench.POSES)[10:11], max_frames=1, rest_pose="zero")
    params, fcfg = load_params_with_config(bench.ARTIFACT_CKPT)
    ro, rd = pose2rays(16, 16, bench.warp_view())
    render = warp_render.make_warp_frame_renderer(fcfg, warp_render.WarpRenderSettings(chunk=128))
    base = np.asarray(render(params, ro, rd, WarpData.create(wv[0], model.faces, Ts[0])))
    rng, worst, share = np.random.default_rng(1), 0.0, 0.0
    for _ in range(TRIALS):
        v = _ulp_np(wv[0], rng)
        p = _ulp_np(params, rng)
        for frame in (render(params, ro, rd, WarpData.create(v, model.faces, Ts[0])),
                      render(p, ro, rd, WarpData.create(wv[0], model.faces, Ts[0]))):
            d = np.abs(np.asarray(frame) - base)
            worst, share = max(worst, float(d.max())), max(share, float((d > 2e-3).mean()))
    print(f"JAX parity warp frame 16x16, one ulp of the parameters or the posed vertices: {worst:.3g}, "
          f"share of the values moved by more than 2e-3 {share:.4f}")


def near_far():
    """geometry_guided_near_far: JAX eager against jitted, and plain f32
    products and sums (the expression evaluated op by op in torch) against
    JAX's jit."""
    from avatarcraft_tpu.warp import geometry_guided_near_far as jax_near_far
    from test_torch_parity_render import _t

    rng = np.random.default_rng(0)  # tests/test_torch_parity_render.py's data
    verts = (rng.normal(size=(300, 3)) * 0.25).astype(np.float32)
    o = np.tile(np.asarray([[0.0, 0.1, -2.5]], np.float32), (200, 1))
    d = rng.normal(size=(200, 3)).astype(np.float32) * 0.3 + np.asarray([0, 0, 1], np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jit = [np.asarray(a) for a in jax.jit(jax_near_far)(o, d, verts)]
    with jax.disable_jit():
        eager = [np.asarray(a) for a in jax_near_far(o, d, verts)]
    ov = _t(verts)[None] - _t(o)[:, None]
    z0 = torch.sum(ov * _t(d)[:, None], -1)
    disc = 0.05**2 - (torch.sum(ov * ov, -1) - z0**2)
    dz = torch.sqrt(torch.clamp_min(disc, 0.0))
    plain = [torch.where(disc >= 0, z0 - dz, torch.inf).amin(1, keepdim=True).numpy(),
             torch.where(disc >= 0, z0 + dz, -torch.inf).amax(1, keepdim=True).numpy()]
    fin = ~np.isinf(jit[0])
    for name, other in (("JAX eager", eager), ("plain f32", plain)):
        print(f"geometry_guided_near_far, {name} against JAX's jit: "
              f"{max(float(np.abs(a[fin] - b[fin]).max()) for a, b in zip(other, jit)):.3g}")


def port_parity():
    """The port's parity frame of the artifact (32x32, f32 tables) and its
    parity SDS step on chip_smoke.py's reduced-width field: params
    perturbed."""
    import dataclasses

    import chip_smoke as cs
    from avatarcraft_tpu_torch import bench
    from avatarcraft_tpu_torch.cameras import pose2rays
    from avatarcraft_tpu_torch.models.instant_nsr import RenderConfig
    from avatarcraft_tpu_torch.utils.checkpoint import load_params_with_config
    from avatarcraft_tpu_torch.workloads.canonical_render import make_parity_frame_renderer

    gen = torch.Generator().manual_seed(1)
    params, fcfg = load_params_with_config(bench.ARTIFACT_CKPT, "cpu")
    fcfg = dataclasses.replace(fcfg, packed_dtype="float32")
    rcfg = RenderConfig(num_steps=64, upsample_steps=64, bound=1.6, perturb=False, normal_mode="fd4")
    ro, rd = pose2rays(32, 32, bench.bench_poses()[0], device="cpu")
    base = make_parity_frame_renderer(params, fcfg, rcfg, chunk=1024)(ro, rd)["rgb"]
    worst, share = 0.0, 0.0
    for _ in range(TRIALS):
        d = (make_parity_frame_renderer(_ulp_torch(params, gen), fcfg, rcfg, chunk=1024)(ro, rd)["rgb"] - base).abs()
        worst, share = max(worst, float(d.max())), max(share, float((d > 1e-4).float().mean()))
    print(f"the port's parity frame 32x32 of the artifact, f32 tables, one ulp of the parameters: {worst:.3g}, "
          f"share of the values moved by more than 1e-4 {share:.4f}")
    noise = torch.randn((1, 3, 64, 64), generator=torch.Generator().manual_seed(4))
    ref = cs._parity_step_record("cpu", lambda device: (cs._small_parity_field(device), cs.PARITY_SMALL_FCFG), noise,
                                 None)
    worst = 0.0
    for _ in range(2):
        rec = cs._parity_step_record(
            "cpu", lambda device: (_ulp_torch(cs._small_parity_field(device), gen), cs.PARITY_SMALL_FCFG), noise, None,
            ref)
        worst = max(worst, float((rec["grad"][(0, "variance")] - ref["grad"][(0, "variance")]).abs().max()
                                 / ref["grad"][(0, "variance")].abs().max()))
    print(f"the port's parity SDS step (chip_smoke's reduced-width field), one ulp of the parameters: the variance's "
          f"gradient moves by {worst:.3g} x max|g|")


if __name__ == "__main__":
    torch.set_num_threads(8)
    torch.cuda.synchronize = lambda *a, **k: None  # chip_smoke's records synchronize; nothing to wait for here
    near_far()
    warp_render()
    phase_b()
    port_parity()
    warp_frame()
