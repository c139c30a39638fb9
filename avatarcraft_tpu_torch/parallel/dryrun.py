"""The port's twin of the JAX package's ``__graft_entry__.dryrun_multichip``
(__graft_entry__.py:39-430): its 8 paths over a mesh of n ranks, at its tiny
shapes, in its order.

    python3 -m avatarcraft_tpu_torch.parallel.dryrun [--n 2] [--device cuda]

1. batch -- the 64+64 train step on the hash grid, the batch sharded
   (``make_train_step`` over the mesh);
2. fast -- the occupancy-guided train step, the batch sharded and the
   parameters replicated (``make_train_step_fast``);
3. stylize -- the parity phase B with each patch's rays sharded
   (``make_phaseB_step`` over the mesh), then Adam;
4. scan -- S sharded steps of ``make_train_scan_fast`` against S sharded
   per-step steps; on the card the scan's CUDA graph of the sharded step
   (the loss psums and the gradient all-reduce on the port's cross-rank
   kernel) is held bitwise against the same scan taken eagerly with the
   same kernels: losses, parameters and Adam's moments;
5. frame -- a 16x16 ``render_rays_fast`` frame, rays sharded, against the
   frame rendered whole on each rank;
6. multi -- P = n prompts, the prompt axis over the ranks: each rank takes
   its prompt's phase-B gradients (``_phaseB_grads_fast``), gathered to
   every rank and held against per-prompt gradients;
7. warp -- path 5 with the warp of the synthetic body;
8. table_mp -- the finest grid row-sharded n ways across the ranks
   (``TableMPTrainStep`` over the mesh), against the replicated SGD step.

Where JAX's dryrun checks only finiteness (paths 1 to 3) the port also
holds the n-rank step against the same step taken by one process on the
whole batch: the loss and every gradient leaf. The fast sampler compacts per
call, and a rank's call is not the global one, so the sharded fast paths
take per-rank budgets that do not clip (each rank's probe count, the largest
over the ranks) and the whole-batch reference n times that. The jitter of a
step is one global draw from a seeded generator, of which each rank takes
its rows.

Tolerances and their causes: sums over ranks add in another order than one
process does (per rank, then over the ranks in rank order), and the
field's MLP gives a row other last bits in a batch of another size; the
64+64 up-sampler's CDF inversion moves a sample by up to 10^4 x such an SDF
difference. So losses agree to ``LOSS_RTOL`` and gradients per leaf to
``GRAD_REL`` x the leaf's max|g| (the worst measured on the CPU: 6.3e-5 at
n = 2, the batch step; 7.3e-5 at n = 4, phase B). JAX's dryrun's own pins
hold the scan (1e-5 losses, 2e-5 parameters), the frames and the
multi-prompt gradients (1e-5) and table-MP (3e-5).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from avatarcraft_tpu_torch.cameras import pose2rays, pose_spherical
from avatarcraft_tpu_torch.models.instant_nsr import (
    FastRenderConfig,
    FieldConfig,
    RenderConfig,
    count_fast_samples,
    init_field_params,
    render_rays,
    render_rays_fast,
)
from avatarcraft_tpu_torch.models.smpl import synthetic_smpl_params
from avatarcraft_tpu_torch.ops.grid_encoder import PyramidSpec
from avatarcraft_tpu_torch.ops.hash_encoder import HashGridSpec
from avatarcraft_tpu_torch.ops.occupancy import voxelize_verts
from avatarcraft_tpu_torch.parallel import ring
from avatarcraft_tpu_torch.parallel.mesh import (
    all_gather_rows_of,
    all_reduce_grads,
    data_sharding,
    launch,
    max_over_ranks,
    one_rank,
)
from avatarcraft_tpu_torch.parallel.table_mp import TableMPTrainStep, gathered_params, trainable_shards
from avatarcraft_tpu_torch.utils.checkpoint import leaves, map_leaves
from avatarcraft_tpu_torch.warp import WarpData, make_warp_fn
from avatarcraft_tpu_torch.workloads import reconstruct as recon
from avatarcraft_tpu_torch.workloads.multi_stylize import _phaseB_grads_fast
from avatarcraft_tpu_torch.workloads.stylize import (
    StylizeConfig,
    backward_through_packing,
    frozen_ground_truth,
    gather_packed,
    make_optimizer,
    make_phaseB_step,
    shard_patches,
)
from avatarcraft_tpu_torch.workloads.warp_render import calc_local_trans

PATHS = ("batch", "fast", "stylize", "scan", "frame", "multi", "warp", "table_mp")
H = W = 16
K = np.array([[20.0, 0, 8.0], [0, 20.0, 8.0], [0, 0, 1]], np.float32)
FCFG = FieldConfig(grid=HashGridSpec(num_levels=4, base_resolution=4, log2_hashmap_size=10, desired_resolution=32))
FCFG_FAST = FieldConfig(
    encoder="tpu_pyramid",
    pyramid=PyramidSpec(grid_resolutions=(4, 8), grid_dim=2, plane_resolutions=(17,), plane_dim=2),
    packed_dtype="float32",
)
# the seeds of JAX's dryrun's init_field_params keys, one per tree
SEEDS = {"batch": 0, "fast": 2, "stylize": 4, "multi_gt": 19, "table_mp": 30}
MULTI_SEED = 20  # prompt i: 20 + i
JITTER_SEED = 1
SCAN_STEPS, SCAN_VIEWS = 3, 2
LOSS_RTOL = 1e-5
GRAD_REL = 2e-4
SCAN_LOSS_ATOL, SCAN_PARAM_ATOL = 1e-5, 2e-5
FRAME_ATOL = 1e-5
MULTI_ATOL = 1e-5
TABLE_MP_ATOL = 3e-5


def _poses() -> np.ndarray:
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[:, 2, 3] = 2.0
    return poses


def batch_data(n: int) -> dict:
    """The dryrun's numpy draws, in its order (np.random.default_rng(0))."""
    B = 8 * n
    rng = np.random.default_rng(0)
    d = {
        "view_idx": rng.integers(0, 2, B).astype(np.int32),
        "pix_idx": rng.integers(0, H * W, B).astype(np.int32),
        "gt": rng.random((B, 3)).astype(np.float32),
        "images_flat": rng.random((SCAN_VIEWS, H * W, 3)).astype(np.float32),
        "masks_flat": (rng.random((SCAN_VIEWS, H * W)) > 0.4).astype(np.float32),
        "vis": rng.integers(0, SCAN_VIEWS, (SCAN_STEPS, B)).astype(np.int32),
        "pis": rng.integers(0, H * W, (SCAN_STEPS, B)).astype(np.int32),
    }
    chunk = 4 * n
    rng2 = np.random.default_rng(1)
    dirs = rng2.normal(size=(2 * chunk, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d.update(
        chunk=chunk,
        rays_o_s=(np.zeros((2 * chunk, 3), np.float32) + np.array([0, 0, -2.0], np.float32)),
        rays_d_s=dirs,
        g_rgb=rng2.normal(size=(2 * chunk, 3)).astype(np.float32),
        bgv=rng2.random((2 * chunk, 3)).astype(np.float32),
    )
    rng3 = np.random.default_rng(3)
    dm = rng3.normal(size=(8, 3)).astype(np.float32)
    dm /= np.linalg.norm(dm, axis=1, keepdims=True)
    d.update(
        rays_o_m=np.zeros((8, 3), np.float32) + np.array([0, 0, -2.0], np.float32),
        rays_d_m=dm,
        bg_m=rng3.random((8, 3)).astype(np.float32),
        g_rgb_m=rng3.normal(size=(n, 8, 3)).astype(np.float32),
    )
    d["gt_mp"] = np.random.default_rng(6).random((2 * chunk, 3)).astype(np.float32)
    return d


def default_inputs(n: int) -> dict:
    """The parameter trees of the 8 paths, drawn by the port from seeded
    CPU generators (the tests pass JAX's instead)."""
    init = lambda cfg, seed: init_field_params(torch.Generator().manual_seed(seed), cfg)  # noqa: E731
    trees = {
        "batch": init(FCFG, SEEDS["batch"]),
        "fast": init(FCFG_FAST, SEEDS["fast"]),
        "stylize": init(FCFG, SEEDS["stylize"]),
        "multi_gt": init(FCFG_FAST, SEEDS["multi_gt"]),
        "table_mp": init(FCFG_FAST, SEEDS["table_mp"]),
        "multi": [init(FCFG_FAST, MULTI_SEED + i) for i in range(n)],
    }
    return map_leaves(trees, lambda t: t.numpy())


# -- helpers -------------------------------------------------------------------


def _tree(tree, device, grad: bool = False) -> dict:
    def one(a):
        t = torch.as_tensor(np.array(a, np.float32, copy=True), device=device)
        return t.requires_grad_() if grad else t

    return map_leaves(tree, one)


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _check_close(what: str, got, want, *, rtol=0.0, atol=0.0) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} against {want.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max |diff| {err} over rtol {rtol}, atol {atol}")
    return err


def _check_grads(what: str, got: dict, want: dict) -> float:
    """Each gradient leaf within GRAD_REL x its max|g|; the worst ratio."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(leaves(got), leaves(want))):
        scale = max(float(np.max(np.abs(b))), 1e-30) if b.size else 1.0
        err = float(np.max(np.abs(a - b))) if b.size else 0.0
        worst = max(worst, err / scale)
        if err > GRAD_REL * scale:
            raise AssertionError(f"{what}: gradient leaf {i} off by {err} (max|g| {scale})")
    return worst


def _replicas_equal(what: str, tensors, mesh) -> None:
    """The replicated tensors bitwise equal on every rank."""
    flat = torch.cat([t.detach().reshape(-1).float().cpu() for t in tensors])
    parts = all_gather_rows_of(flat[None], mesh)
    if not all(torch.equal(p, parts[0]) for p in parts):
        raise AssertionError(f"{what}: the replicas differ across ranks")


def _grad(t: torch.Tensor) -> torch.Tensor:
    return t.grad if t.grad is not None else torch.zeros_like(t)


def _grad_tree(rest: dict, shards, splice) -> dict:
    """The gradient of the whole tree in the parameters' layout: the rest's
    and the table's."""
    return map_leaves(splice(map_leaves(rest, _grad), torch.cat([_grad(s) for s in shards])), _host)


def _no_clip_budget(mesh, counts) -> int:
    """The largest probe count of any rank's calls: a per-rank budget that
    clips nothing (at least 1)."""
    return max(max_over_ranks(max(int(c) for c in counts), mesh), 1)


def _say(mesh, msg: str) -> None:
    if mesh.rank == 0:
        print(f"dryrun_multichip {msg}", flush=True)


# -- the paths -----------------------------------------------------------------


def path_batch(mesh, inputs, data, perturb):
    n, dev = mesh.size, mesh.device
    rcfg = RenderConfig(num_steps=8, upsample_steps=8, upsample_round=8, perturb=perturb)
    cfg = recon.ReconstructConfig(batch_size=8 * n)
    ray_fn = recon.make_batch_ray_fn(K, H, W)
    poses = torch.as_tensor(_poses(), device=dev)

    def run(m):
        params = _tree(inputs["batch"], dev, grad=True)
        opt, sched = recon.make_optimizer(cfg, 10, leaves(params))
        step = recon.make_train_step(FCFG, rcfg, opt, ray_fn, 0.1, 1.0, sched, m)
        batch = recon._shard_batch_arrays(m, data["view_idx"], data["pix_idx"], data["gt"])
        loss, _ = step(params, poses, *batch, torch.Generator(dev).manual_seed(JITTER_SEED))
        return float(loss), params, map_leaves(params, lambda p: _host(_grad(p)))

    loss, params, grads = run(mesh)
    loss1, _, grads1 = run(one_rank(dev))
    _check_close("batch step loss, n ranks against one", loss, loss1, rtol=LOSS_RTOL)
    worst = _check_grads("batch step", grads, grads1)
    _replicas_equal("batch step parameters", leaves(params), mesh)
    _say(mesh, f"OK: {n}-rank mesh, batch {cfg.batch_size}, loss {loss:.4f} (one rank {loss1:.4f}, "
               f"gradients within {worst:.2e} x max|g|)")
    return {"loss": loss, "params": map_leaves(params, _host), "grads": grads, "grad_rel": worst}


def _fast_cfg(budget: int) -> FastRenderConfig:
    return FastRenderConfig(n_probes=16, k_samples=6, bound=1.6, sample_budget=budget)


def path_fast(mesh, inputs, data):
    n, dev = mesh.size, mesh.device
    cfg = recon.ReconstructConfig(batch_size=8 * n)
    ray_fn = recon.make_batch_ray_fn(K, H, W)
    poses = torch.as_tensor(_poses(), device=dev)
    grid = torch.full((17, 17, 17), 100.0, device=dev)
    args = (data["view_idx"], data["pix_idx"], data["gt"])
    vi, pi, _ = recon._shard_batch_arrays(mesh, *args)
    budget = _no_clip_budget(mesh, [count_fast_samples(*ray_fn(poses, vi, pi), _fast_cfg(0), grid)])

    def run(m, fast_cfg):
        rest, shards, splice = trainable_shards(_tree(inputs["fast"], dev))
        opt, sched = recon.make_optimizer(cfg, 10, leaves(rest) + shards)
        step = recon.make_train_step_fast(FCFG_FAST, fast_cfg, opt, ray_fn, 0.1, splice, sched, m)
        loss, _ = step(rest, shards, poses, *recon._shard_batch_arrays(m, *args), grid, 1.0)
        return float(loss), rest, shards, splice, _grad_tree(rest, shards, splice)

    loss, rest, shards, splice, grads = run(mesh, _fast_cfg(budget))
    loss1, _, _, _, grads1 = run(one_rank(dev), _fast_cfg(n * budget))
    _check_close("fast step loss, n ranks against one", loss, loss1, rtol=LOSS_RTOL)
    worst = _check_grads("fast step", grads, grads1)
    _replicas_equal("fast step replicated parameters", leaves(rest) + shards, mesh)
    params = gathered_params(rest, shards, splice)
    _say(mesh, f"fast-path OK: loss {loss:.4f} (one rank {loss1:.4f}), per-rank budget {budget}, "
               f"gradients within {worst:.2e} x max|g|")
    return {"loss": loss, "params": map_leaves(params, _host), "grads": grads, "budget": budget, "grad_rel": worst}


def path_stylize(mesh, inputs, data, perturb):
    n, dev, chunk = mesh.size, mesh.device, data["chunk"]
    rcfg = RenderConfig(num_steps=6, upsample_steps=6, upsample_round=6, perturb=perturb)
    rays = [torch.as_tensor(data[k], device=dev) for k in ("rays_o_s", "rays_d_s", "g_rgb", "bgv")]

    def run(m):
        rest, shards, splice = trainable_shards(_tree(inputs["stylize"], dev))
        opt = make_optimizer(5e-3, leaves(rest) + shards)
        gt = frozen_ground_truth(_tree(inputs["stylize"], dev), FCFG, rcfg.bound)
        params, packed32, tables = gather_packed(rest, shards, splice, FCFG)
        step = make_phaseB_step(FCFG, rcfg, 0.01, True, chunk, generator=torch.Generator(dev).manual_seed(JITTER_SEED),
                                mesh=m)
        loss = step(params, tables, gt, *(shard_patches(m, r, chunk) for r in rays))
        backward_through_packing(packed32, tables)
        all_reduce_grads(leaves(rest) + shards, m)
        grads = _grad_tree(rest, shards, splice)
        opt.step()
        return float(loss), gathered_params(rest, shards, splice), grads, leaves(rest) + shards

    loss, params, grads, owned = run(mesh)
    loss1, _, grads1, _ = run(one_rank(dev))
    _check_close("phase B loss, n ranks against one", loss, loss1, rtol=LOSS_RTOL)
    worst = _check_grads("phase B", grads, grads1)
    _replicas_equal("phase B parameters", owned, mesh)
    _say(mesh, f"stylize phase-B OK: {2 * chunk} rays over {n} ranks (loss {loss:.4f}, gradients within "
               f"{worst:.2e} x max|g|)")
    return {"loss": loss, "params": map_leaves(params, _host), "grads": grads, "grad_rel": worst}


def path_scan(mesh, inputs, data):
    n, dev = mesh.size, mesh.device
    cfg = recon.ReconstructConfig(batch_size=8 * n)
    ray_fn = recon.make_batch_ray_fn(K, H, W)
    poses = torch.as_tensor(_poses(), device=dev)
    grid = torch.full((17, 17, 17), 100.0, device=dev)
    images = torch.as_tensor(data["images_flat"], device=dev)
    masks = torch.as_tensor(data["masks_flat"], device=dev)
    cols = data_sharding(mesh, 8 * n)
    index = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)  # noqa: E731
    counts = [count_fast_samples(*ray_fn(poses, index(data["vis"][s, cols]), index(data["pis"][s, cols])),
                                 _fast_cfg(0), grid) for s in range(SCAN_STEPS)]
    fast_cfg = _fast_cfg(_no_clip_budget(mesh, counts))

    def fresh():
        rest, shards, splice = trainable_shards(_tree(inputs["fast"], dev))
        opt, sched = recon.make_optimizer(cfg, 10, leaves(rest) + shards)
        return rest, shards, splice, opt, sched

    def run_scan(graph):
        rest, shards, splice, opt, sched = fresh()
        scan = recon.make_train_scan_fast(FCFG_FAST, fast_cfg, opt, ray_fn, 0.1, "composite", True, splice,
                                          graph=graph, mesh=mesh)
        losses = scan(rest, shards, poses, images, masks, data["vis"], data["pis"], sched.advance(SCAN_STEPS), grid)
        owned = leaves(rest) + shards
        moments = [opt.state[p][k] for p in owned for k in ("exp_avg", "exp_avg_sq")]
        return losses, gathered_params(rest, shards, splice), moments

    losses, p_scan, moments = run_scan(False)
    graphed = dev.type == "cuda"
    if graphed:  # the graph against the same steps taken eagerly with the same kernels, bitwise
        g_losses, g_params, g_moments = run_scan(None)
        same = torch.equal(g_losses, losses) and all(torch.equal(a, b) for a, b in zip(
            leaves(g_params) + g_moments, leaves(p_scan) + moments))
        if not same:
            raise AssertionError("the graphed sharded scan differs from the same steps taken eagerly")

    rest1, shards1, splice1, opt1, sched1 = fresh()
    step = recon.make_train_step_fast(FCFG_FAST, fast_cfg, opt1, ray_fn, 0.1, splice1, sched1, mesh)
    per_step = []
    for s in range(SCAN_STEPS):
        vi, pi = data["vis"][s], data["pis"][s]
        m = data["masks_flat"][vi, pi][:, None]
        gt = data["images_flat"][vi, pi] * m + (1.0 - m) * 1.0
        loss, _ = step(rest1, shards1, poses, *recon._shard_batch_arrays(mesh, vi, pi, gt), grid, 1.0)
        per_step.append(float(loss))
    p_ref = gathered_params(rest1, shards1, splice1)
    _check_close("scan losses against per-step", _host(losses), per_step, atol=SCAN_LOSS_ATOL)
    for a, b in zip(leaves(p_scan), leaves(p_ref)):
        _check_close("scan parameters against per-step", _host(a), _host(b), atol=SCAN_PARAM_ATOL)
    _say(mesh, f"scan-trainer OK: {SCAN_STEPS}x{8 * n} sharded steps == per-step"
               + ("; the CUDA graph's replays bitwise the eager scan" if graphed else ""))
    return {"losses": _host(losses), "per_step": per_step, "params": map_leaves(p_scan, _host), "graphed": graphed}


def _frame_rays(dev):
    return pose2rays(16, 16, pose_spherical(30.0, -10.0, 2.0), device=dev)


def _sharded_frame(mesh, params, ro, rd, grid, warp_fn=None):
    """The frame rendered in rank shards and gathered, and rendered whole on
    this rank, at no-clip budgets."""
    rows = data_sharding(mesh, ro.shape[0])
    budget = _no_clip_budget(mesh, [count_fast_samples(ro[rows], rd[rows], _fast_cfg(0), grid)])
    with torch.no_grad():
        part = render_rays_fast(params, ro[rows], rd[rows], FCFG_FAST, _fast_cfg(budget), grid, 1.0,
                                warp_fn=warp_fn)["rgb"]
        whole = render_rays_fast(params, ro, rd, FCFG_FAST, _fast_cfg(mesh.size * budget), grid, 1.0,
                                 warp_fn=warp_fn)["rgb"]
    return all_gather_rows_of(part, mesh), whole, budget


def path_frame(mesh, inputs, data):
    dev = mesh.device
    params = _tree(inputs["fast"], dev)
    grid = torch.full((17, 17, 17), 100.0, device=dev)
    sharded, whole, budget = _sharded_frame(mesh, params, *_frame_rays(dev), grid)
    err = _check_close("ray-sharded frame against the whole frame", _host(sharded), _host(whole), atol=FRAME_ATOL)
    _say(mesh, f"sharded-frame OK: 16x16 render_rays_fast over {mesh.size} ranks matches the whole frame "
               f"(max {err:.2e}, per-rank budget {budget})")
    return {"rgb": _host(sharded), "max_err": err}


def path_multi(mesh, inputs, data):
    n, dev = mesh.size, mesh.device
    scfg = StylizeConfig(batch_size=8, sampler="fast")
    fast_cfg = _fast_cfg(4 * 8 * n)
    grid = torch.full((17, 17, 17), 100.0, device=dev)
    ro, rd, bg = (torch.as_tensor(data[k], device=dev) for k in ("rays_o_m", "rays_d_m", "bg_m"))
    gt = frozen_ground_truth(_tree(inputs["multi_gt"], dev), FCFG_FAST, fast_cfg.bound)
    step = _phaseB_grads_fast(FCFG_FAST, fast_cfg, scfg)

    def grads_of(i):
        rest, shards, splice = trainable_shards(_tree(inputs["multi"][i], dev))
        params, packed32, tables = gather_packed(rest, shards, splice, FCFG_FAST)
        step(params, tables, gt, ro, rd, torch.as_tensor(data["g_rgb_m"][i], device=dev), bg, grid)
        backward_through_packing(packed32, tables)
        return torch.cat([g.reshape(-1) for g in (t.grad if t.grad is not None else torch.zeros_like(t)
                                                  for t in leaves(rest) + shards)])

    per_rank = 1  # P = n prompts: one a rank
    mine = torch.stack([grads_of(mesh.rank * per_rank + j) for j in range(per_rank)])
    stacked = all_gather_rows_of(mine, mesh)  # [P, n_params], prompt order
    worst = 0.0
    for i in sorted({0, n - 1}):
        worst = max(worst, _check_close(f"prompt {i}'s sharded gradients against its own",
                                        _host(stacked[i]), _host(grads_of(i)), atol=MULTI_ATOL))
    _say(mesh, f"multi-prompt OK: {n} prompts over {n} ranks match per-prompt phase-B grads (max {worst:.2e})")
    return {"grads": _host(stacked)}


def path_warp(mesh, inputs, data):
    dev = mesh.device
    body = synthetic_smpl_params(0, n_verts=64, n_joints=6)
    pose_seq = np.asarray(np.random.default_rng(5).normal(scale=0.2, size=(1, 6, 3)), np.float32)
    wv, Ts, _ = calc_local_trans(body, render_type="animate", poses=pose_seq, max_frames=1, rest_pose="zero")
    wd = WarpData.create(wv[0], body.faces, Ts[0], device=dev)
    wgrid = voxelize_verts(torch.as_tensor(wv[0], device=dev), 1.6, 17)
    sharded, whole, budget = _sharded_frame(mesh, _tree(inputs["fast"], dev), *_frame_rays(dev), wgrid,
                                            make_warp_fn(wd, 0.25))
    err = _check_close("ray-sharded warped frame against the whole frame", _host(sharded), _host(whole),
                       atol=FRAME_ATOL)
    _say(mesh, f"sharded-warp OK: 16x16 warped render_rays_fast over {mesh.size} ranks matches the whole "
               f"frame (max {err:.2e})")
    return {"rgb": _host(sharded), "max_err": err}


def path_table_mp(mesh, inputs, data):
    n, dev = mesh.size, mesh.device
    rcfg = RenderConfig(num_steps=6, upsample_steps=6, upsample_round=6, perturb=False)
    ro, rd, gt = (torch.as_tensor(data[k], device=dev) for k in ("rays_o_s", "rays_d_s", "gt_mp"))
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.5)  # noqa: E731
    tstep = TableMPTrainStep(_tree(inputs["table_mp"], dev), mesh, FCFG_FAST, rcfg, sgd)
    rows = data_sharding(mesh, ro.shape[0])
    loss = float(tstep(ro[rows], rd[rows], gt[rows]))
    updated = tstep.params()

    ref = _tree(inputs["table_mp"], dev, grad=True)
    out = render_rays(ref, ro, rd, FCFG_FAST, rcfg, 1.0)
    ref_loss = torch.mean((out["rgb"] - gt) ** 2) + 0.1 * out["gradient_error"]
    ref_loss.backward()
    opt = sgd(leaves(ref))
    opt.step()
    worst = 0.0
    for a, b in zip(leaves(updated), leaves(ref)):
        worst = max(worst, _check_close("table-MP step against the replicated step", _host(a), _host(b),
                                        atol=TABLE_MP_ATOL))
    _check_close("table-MP loss against the replicated loss", loss, float(ref_loss.detach()), rtol=LOSS_RTOL)
    _say(mesh, f"table-MP OK: grid rows sharded {n}-way across ranks, ring-gathered step == replicated step "
               f"(loss {loss:.4f}, max {worst:.2e})")
    return {"loss": loss, "params": map_leaves(updated, _host)}


def run_paths(mesh, inputs: dict, perturb: bool = True) -> dict:
    """The 8 paths in this rank, in order: {"results": {path: ...},
    "launches": {path: the table kernels' launches in it}}."""
    ring.launches.update({name: 0 for name in ring.launches})
    data = batch_data(mesh.size)
    fns = {
        "batch": lambda: path_batch(mesh, inputs, data, perturb),
        "fast": lambda: path_fast(mesh, inputs, data),
        "stylize": lambda: path_stylize(mesh, inputs, data, perturb),
        "scan": lambda: path_scan(mesh, inputs, data),
        "frame": lambda: path_frame(mesh, inputs, data),
        "multi": lambda: path_multi(mesh, inputs, data),
        "warp": lambda: path_warp(mesh, inputs, data),
        "table_mp": lambda: path_table_mp(mesh, inputs, data),
    }
    results, launches = {}, {}
    for name in PATHS:
        before = dict(ring.launches)
        results[name] = fns[name]()
        launches[name] = {k: ring.launches[k] - before[k] for k in before}
    return {"results": results, "launches": launches}


def dryrun_multichip(n: int, device: str = "cuda", inputs: dict | None = None, perturb: bool = True) -> dict:
    """Run the dryrun's paths over a mesh of n ranks on ``device`` (every
    check inside raises on failure). Returns rank 0's results per path and
    the table kernels' launches per path, per rank ({path: [rank 0's, ...]})
    and summed over the ranks ("launches_total"). ``inputs``: the parameter
    trees as numpy arrays (``default_inputs``' layout); ``perturb``: the
    64+64 paths' jitter (JAX's dryrun's True)."""
    if inputs is None:
        inputs = default_inputs(n)
    out = launch(run_paths, n, inputs, perturb, device=device)
    per_path = {p: [r["launches"][p] for r in out] for p in PATHS}
    total = {p: {k: sum(c[k] for c in counts) for k in counts[0]} for p, counts in per_path.items()}
    return {"results": out[0]["results"], "launches": per_path, "launches_total": total}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    opt = parser.parse_args(argv)
    out = dryrun_multichip(opt.n, opt.device)
    print(json.dumps({"launches_total": out["launches_total"]}))


if __name__ == "__main__":
    main()
