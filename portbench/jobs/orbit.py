"""Canonical frames of the root bench's orbit (``avatarcraft_tpu_torch.bench``'s
canonical path): the baked artifact and its density grid, the 16 cameras
of four groups around the body, 192 probes and K = 32 with the sample
budget derived over the 16 views in set-up, one chunk a frame
(``make_fast_frame_renderer``), then the image's copy to the host. The
views loop.

The seed sets the view the window starts at: every seed renders the same
frames in another order. The reference (``portbench/reference/march.py``)
renders a sample of the finished frames, drawn from the seed, from the raw
files: the artifact and the grid."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import compare, counts, inputs
from portbench.jobs.base import Job, lowered, pinned_file, same_field, table_shape
from portbench.reference import cameras, march
from portbench.reference.field import Field, artifact_params

BOUND = 1.6  # the canonical cube's half side


def views(t: dict) -> list:
    """The orbit's cameras (capture convention): group g, view i at azimuth
    first + i step + g group_step, elevation g elevation_step."""
    o = t["orbit"]
    return [cameras.pose_spherical(o["first"] + o["step"] * i + o["group_step"] * g, o["elevation_step"] * g,
                                   o["radius"])
            for g in range(o["groups"]) for i in range(o["per_group"])]


class OrbitJob(Job):
    unit = "frame"

    def __init__(self, ctx):
        super().__init__(ctx)
        art, t = self.config["artifact"], self.traffic
        self.artifact = pinned_file(ctx.root, art["file"], art["sha256"])
        self.grid_file = pinned_file(ctx.root, t["grid"], t["grid_sha256"])
        self.check_units = t["check_frames"]
        self.k10_shape = table_shape(self.config["field"])

    def warm(self):
        from avatarcraft_tpu_torch import cameras as cams
        from avatarcraft_tpu_torch.models import instant_nsr
        from avatarcraft_tpu_torch.utils import checkpoint
        from avatarcraft_tpu_torch.workloads import canonical_render

        t, res = self.traffic, self.traffic["res"]
        params, fcfg = checkpoint.load_params_with_config(self.artifact, self.device)
        same_field(fcfg, self.config["field"])
        self.grid = torch.as_tensor(np.load(self.grid_file), dtype=torch.float32).to(self.device)
        cfg = instant_nsr.FastRenderConfig(n_probes=t["n_probes"], k_samples=t["k_samples"], bound=BOUND,
                                           normal_mode=t["normal_mode"])
        self.rays = [cams.pose2rays(res, res, pose, device=self.device) for pose in views(t)]
        self.count = lambda: max(int(instant_nsr.count_fast_samples(ro, rd, self.cfg, self.grid))
                                 for ro, rd in self.rays)
        self.cfg = cfg
        self.budget = int(self.count() * t["budget_safety"])  # the bench's derivation, over the orbit's views
        self.cfg = dataclasses.replace(cfg, sample_budget=self.budget)
        self.render = canonical_render.make_fast_frame_renderer(params, fcfg, self.cfg, self.grid, chunk=res * res,
                                                               bg_color=t["bg"])
        n = len(self.rays)
        self.k = self.k0 = int(inputs.sub_seed(self.seed, "start") % n)  # the window's first view
        for v in (self.k, (self.k + 1) % n):  # shapes and allocations, warm
            self.frame(v)
        self.frames = {}  # view -> the image as the program answered

    def frame(self, v: int) -> np.ndarray:
        res = self.traffic["res"]
        return self.render(*self.rays[v])["rgb"].reshape(res, res, 3).cpu().numpy()

    def run_one(self) -> int:
        v = self.k % len(self.rays)
        self.frames[v] = self.frame(v)
        self.k += 1
        return 1

    def finish(self):
        counts.sync(self.device)
        # no view may select more samples than the budget (the bench's zero-clip check)
        failed = len(self.rays) if self.count() > self.budget else 0
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "sample"))
        keys = sorted(self.frames)
        pick = rng.choice(keys, size=min(self.traffic["check_frames"], len(keys)), replace=False)
        self.witness = {int(v): self.frames[v] for v in pick}
        return self.k - self.k0, failed

    def release(self):
        self.render = self.rays = self.grid = None
        self.frames = {}

    @torch.no_grad()
    def reference(self, variant: str) -> dict:
        t, res = self.traffic, self.traffic["res"]
        field = Field(artifact_params(self.artifact, self.device), self.config["field"], BOUND,
                      lowered(variant)["table_dtype"])
        grid = torch.as_tensor(np.load(self.grid_file), dtype=torch.float32).to(self.device)
        poses = views(t)

        def frame(v):
            rays_o, rays_d = cameras.canonical_rays(res, res, poses[v], self.device)
            return torch.cat([march.render(field, rays_o[i:i + t["chunk"]], rays_d[i:i + t["chunk"]], grid, t["bg"],
                                           n_probes=t["n_probes"], k=t["k_samples"])["rgb"]
                              for i in range(0, res * res, t["chunk"])])

        out = {v: frame(v).reshape(res, res, 3).cpu().numpy() for v in sorted(self.witness)}
        if variant == "f32" and self.flops_per_unit is None:
            # a frame's matrix products, counted over the reference's own frame
            _, self.flops_per_unit = counts.count_flops(lambda: frame(min(self.witness)))
        return out

    def compare(self, got, ref) -> dict:
        return compare.compare_frames(got, ref)


def build(ctx) -> OrbitJob:
    return OrbitJob(ctx)
