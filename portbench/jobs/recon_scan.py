"""The reconstruct CLI's fast trainer with ``--scan_steps S``
(``train_fast``): S steps a call of ``make_train_scan_fast``, the dataset on
the card, on the card one step captured as a CUDA graph and replayed. The
field starts from its geometric init with a fully occupied grid, as
``train_fast`` starts; the grid refresh follows ``maybe_refresh`` (no
refresh before ``grid_warmup_steps``).

The seed draws the targets, the field's initial parameters and the pixel
order. The reference (``portbench/reference/train.py``) takes the first
call's S steps from the same inputs."""

from __future__ import annotations

import numpy as np
import torch

from portbench import counts, inputs
from portbench.compare import leaf_norms
from portbench.jobs.base import Job, lowered, table_shape
from portbench.reference import train
from portbench.reference.field import flat_params

BOUND = 1.6  # the canonical cube's half side


class Trainer:
    """``train_fast``'s scan branch, one call at a time: ``call()`` runs the
    next S blocks of the pixel order and the refresh that follows them."""

    def __init__(self, t: dict, field: dict, init: dict, K, poses, images, seed: int, device):
        from avatarcraft_tpu_torch.models import instant_nsr
        from avatarcraft_tpu_torch.parallel import table_mp
        from avatarcraft_tpu_torch.utils import checkpoint
        from avatarcraft_tpu_torch.workloads import reconstruct

        self.t, self.reconstruct, self.table_mp, self.checkpoint = t, reconstruct, table_mp, checkpoint
        self.fcfg = checkpoint.field_config_from_dict(field)
        self.cfg = reconstruct.ReconstructConfig(batch_size=t["batch_size"], lr=t["lr"], epochs=t["epochs"],
                                                 white_bkg=t["white_bkg"], bkg_mode=t["bkg_mode"], seed=seed)
        self.fast_cfg = instant_nsr.FastRenderConfig(n_probes=t["n_probes"], k_samples=t["k_samples"], bound=BOUND,
                                                     sample_budget=t["sample_budget"], normal_mode=t["normal_mode"])
        n_views, res = images.shape[0], images.shape[1]
        self.rest, self.shards, self.splice = table_mp.trainable_shards(init)
        steps_per_epoch = n_views * res * res // self.cfg.batch_size
        self.opt, self.sched = reconstruct.make_optimizer(self.cfg, steps_per_epoch, self.leaves())
        ray_fn = reconstruct.make_batch_ray_fn(K, res, res)
        self.scan = reconstruct.make_train_scan_fast(self.fcfg, self.fast_cfg, self.opt, ray_fn,
                                                     self.cfg.eikonal_weight, self.cfg.bkg_mode,
                                                     self.cfg.white_bkg, self.splice)
        self.images = images.reshape(n_views, -1, 3)
        self.masks = torch.zeros((1, 1), device=device)  # read only by the composite modes
        self.generator = torch.Generator(device).manual_seed(self.cfg.seed)
        self.refresh = reconstruct.make_grid_update_fn(self.fcfg, self.fast_cfg.bound)
        self.grid = torch.full((t["grid_resolution"],) * 3, 100.0, device=device)
        self.poses = torch.as_tensor(np.asarray(poses, np.float32), device=device)
        self.blocks = self._blocks(n_views, res * res, np.random.default_rng(self.cfg.seed))
        self.step = 0

    def _blocks(self, n_views, n_pix, rng):
        while True:
            yield from self.reconstruct.pixel_batches(n_views, n_pix, self.cfg.batch_size, rng)

    def leaves(self) -> list:
        return self.checkpoint.leaves(self.rest) + list(self.shards)

    def names(self) -> list:
        """The leaves' names in the reference's flat layout."""
        table = f"grids.{len(self.rest['grids']) - 1}"
        return list(flat_params(self.rest)) + [table] * len(self.shards)

    def call(self):
        S = self.t["scan_steps"]
        got = [next(self.blocks) for _ in range(S)]
        vis, pis = np.stack([v for v, _ in got]), np.stack([p for _, p in got])
        lrs = self.sched.advance(S)
        losses = self.scan(self.rest, self.shards, self.poses, self.images, self.masks, vis, pis, lrs, self.grid,
                           self.generator)
        prev, self.step = self.step, self.step + S
        self._maybe_refresh(prev)
        return losses

    def _maybe_refresh(self, prev: int) -> None:
        """``train_fast``'s refresh: in place, when the steps crossed a
        refresh boundary past the warm-up (the first from zeros)."""
        every, warm = self.t["grid_update_every"], self.t["grid_warmup_steps"]
        if not every or self.step // every <= prev // every or self.step < warm:
            return
        params = self.table_mp.gathered_params(self.rest, self.shards, self.splice)
        start = torch.zeros_like(self.grid) if self.step < warm + every else self.grid
        self.grid.copy_(self.refresh(params, start))


class ReconScanJob(Job):
    faults = ("half_batch",)

    def __init__(self, ctx):
        super().__init__(ctx)
        t = self.traffic
        if t["bkg_mode"] != "raw" or t["sample_budget"] or t["normal_mode"] != "fd4":
            raise ValueError("the reference trains raw targets, every selected sample, fd4 normals")
        self.K, self.poses, self.images = inputs.recon_targets(self.seed, t["views"], t["res"], self.device)
        self.train_seed = inputs.sub_seed(self.seed, "train")
        self.k10_shape = table_shape(self.config["field"])
        self.init = inputs.field_init(self.seed, self.config["field"], self.device)

    def warm(self):
        self.trainer = Trainer(self.traffic, self.config["field"], self.init, self.K, self.poses, self.images,
                               self.train_seed, self.device)
        if tuple(self.trainer.shards[0].shape) != self.k10_shape:
            raise ValueError(f"the table shard {tuple(self.trainer.shards[0].shape)} is not {self.k10_shape}")
        start = [t.detach().clone() for t in self.trainer.leaves()]
        losses = self.trainer.call()
        leaves, names = self.trainer.leaves(), self.trainer.names()
        state = self.trainer.opt.state
        moments = [state[p]["exp_avg"] if "exp_avg" in state.get(p, {}) else torch.zeros_like(p) for p in leaves]
        # the first call's S losses, Adam's first moment after them and each leaf's change, by name
        self.witness = {"losses": [float(v) for v in losses.cpu()],
                        "grad": dict(zip(names, leaf_norms(moments))),
                        "change": dict(zip(names, leaf_norms([e.detach() - s for s, e in zip(start, leaves)])))}
        del start
        self.trainer.call()  # the graph's replays, warm
        self.losses = []

    def run_one(self) -> int:
        self.losses.append(self.trainer.call())
        return self.traffic["scan_steps"]

    def finish(self):
        counts.sync(self.device)
        n = sum(len(x) for x in self.losses)
        bad = int((~torch.isfinite(torch.cat(self.losses))).sum()) if self.losses else 0
        return n, bad

    def release(self):
        self.trainer = None
        self.losses = []

    def reference(self, variant: str) -> dict:
        t = self.traffic
        res, S = t["res"], t["scan_steps"]
        steps = t["epochs"] * (t["views"] * res * res // t["batch_size"])
        batches = train.pixel_batches(self.train_seed, t["views"], res * res, t["batch_size"], S)
        lrs = [float(np.float32(train.cosine_lr(t["lr"], s, steps))) for s in range(S)]
        grid = torch.full((t["grid_resolution"],) * 3, 100.0, device=self.device)
        poses = torch.as_tensor(self.poses, device=self.device)
        images = self.images.reshape(t["views"], -1, 3)

        def run(batches):
            return train.fast_steps(flat_params(self.init), self.config["field"], BOUND, self.K, poses, images,
                                    grid, batches, lrs, 1.0 if t["white_bkg"] else 0.0, t["n_probes"],
                                    t["k_samples"], table_dtype=lowered(variant)["table_dtype"],
                                    batch_filter=half_batch if variant == "half_batch" else None)

        out = run(batches)
        if variant == "f32" and self.flops_per_unit is None:
            # a step's matrix products, forward and backward, counted over the reference's own step
            _, self.flops_per_unit = counts.count_flops(lambda: run(batches[:1]))
        return out


def half_batch(view, pix):
    """Half of the batch left out, the rest weighted double: the mean over
    the rest (a planted fault)."""
    view, pix = np.array(view), np.array(pix)
    h = len(view) // 2
    view[h: 2 * h], pix[h: 2 * h] = view[:h], pix[:h]
    return view, pix


def build(ctx) -> ReconScanJob:
    return ReconScanJob(ctx)
