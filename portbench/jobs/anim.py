"""Animated frames of the warp CLI's fast sampler
(``render_warp_cli --sampler fast``): a pose sequence's body transforms
first (``calc_local_trans``), then per frame the posed body's set-up
(``WarpData.create``), the frame (``make_warp_frame_renderer_fast``, the
budget derived over the sequence) and the image's copy to the host. The
sequence loops; its transforms are worked out again at each pass.

The seed sets the frame the window starts at: every seed renders the same
frames in another order. The reference (``portbench/reference/frames.py``)
renders a sample of the finished frames, drawn from the seed, from the raw
files: the artifact, the rig and the poses."""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench import compare, counts, inputs
from portbench.jobs.base import Job, lowered, pinned_file, same_field
from portbench.reference import body, cameras, frames
from portbench.reference.field import Field, artifact_params

BOUND = 1.6  # the canonical cube's half side


class Animator:
    """The warp CLI's animation, as the program sets it up."""

    def __init__(self, root: str, t: dict, artifact: str, device):
        from avatarcraft_tpu_torch import cameras as cams
        from avatarcraft_tpu_torch import warp
        from avatarcraft_tpu_torch.data import amass
        from avatarcraft_tpu_torch.models import smpl
        from avatarcraft_tpu_torch.utils import checkpoint
        from avatarcraft_tpu_torch.workloads import warp_render

        self.t, self.device, self.warp, self.warp_render = t, device, warp, warp_render
        self.params, self.fcfg = checkpoint.load_params_with_config(artifact, device)
        self.model = smpl.load_smpl(os.path.join(root, t["body"]))
        self.sequence = amass.load_pose_sequence(os.path.join(root, t["poses"]))
        view = cams.pose_spherical(t["view"]["theta"], t["view"]["phi"], t["view"]["radius"])
        self.rays = cams.pose2rays(t["res"], t["res"], view, device=device)
        self.settings = warp_render.WarpRenderSettings(chunk=t["chunk"], normal_mode=t["normal_mode"])
        self.world_verts, self.Ts, self.n_frames = self.body()
        self.budget = warp_render.derive_warp_budget(self.world_verts, *self.rays, self.settings)
        self.render = warp_render.make_warp_frame_renderer_fast(self.params, self.fcfg, self.settings, self.budget,
                                                                t["bg"])

    def body(self):
        return self.warp_render.calc_local_trans(self.model, render_type="animate", poses=self.sequence,
                                                 max_frames=self.t["max_frames"], rest_pose=self.t["rest_pose"])

    def posed(self, f: int):
        return self.warp.WarpData.create(self.world_verts[f], self.model.faces, self.Ts[f], self.device)

    def frame(self, f: int) -> np.ndarray:
        return self.render(*self.rays, self.posed(f)).reshape(self.t["res"], self.t["res"], 3).cpu().numpy()

    def clipped(self) -> bool:
        """Whether a chunk of a frame selects more samples than the budget."""
        worst = self.warp_render.warp_worst_count(self.world_verts, *self.rays, self.settings)
        return worst > self.budget


class AnimJob(Job):
    unit = "frame"

    def __init__(self, ctx):
        super().__init__(ctx)
        art = self.config["artifact"]
        self.artifact = pinned_file(ctx.root, art["file"], art["sha256"])
        self.files = {key: pinned_file(ctx.root, self.traffic[key], self.traffic[key + "_sha256"])
                      for key in ("body", "poses")}
        self.check_units = self.traffic["check_frames"]

    def warm(self):
        self.anim = Animator(self.ctx.root, self.traffic, self.artifact, self.device)
        same_field(self.anim.fcfg, self.config["field"])
        wr, t = self.anim.warp_render, self.traffic
        if (wr.N_PROBES, wr.K_SAMPLES, wr.GRID_RESOLUTION, t["normal_mode"]) != (t["n_probes"], t["k_samples"],
                                                                                 129, "fd4"):
            raise ValueError("the program's warp sampler is not the one the traffic names")
        n = self.n_frames = self.anim.n_frames
        self.k = int(inputs.sub_seed(self.seed, "start") % n)  # the window's first frame
        for f in (self.k, (self.k + 1) % n):  # shapes and allocations, warm
            self.anim.frame(f)
        self.frames = {}  # frame -> the image as the program answered
        self.k0 = self.k

    def run_one(self) -> int:
        a, spans = self.anim, self.ctx.spans
        f = self.k % a.n_frames
        if (self.k - self.k0) % a.n_frames == 0:  # a pass of the sequence begins with its transforms
            with spans("body.sequence"):
                a.world_verts, a.Ts, _ = a.body()
        with spans("body.frame"):
            posed = a.posed(f)
        img = a.render(*a.rays, posed).reshape(a.t["res"], a.t["res"], 3).cpu().numpy()
        self.frames[f] = img
        self.k += 1
        return 1

    def finish(self):
        counts.sync(self.device)
        # every frame of the sequence within the budget, or each is counted failed
        self.failed = self.anim.n_frames if self.anim.clipped() else 0
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "sample"))
        keys = sorted(self.frames)
        pick = rng.choice(keys, size=min(self.traffic["check_frames"], len(keys)), replace=False)
        self.witness = {int(f): self.frames[f] for f in pick}
        return self.k - self.k0, self.failed

    def release(self):
        self.anim = None
        self.frames = {}

    def reference(self, variant: str) -> dict:
        t, prec = self.traffic, lowered(variant)
        field = Field(artifact_params(self.artifact, self.device), self.config["field"], BOUND, prec["table_dtype"])
        rig = body.load_rig(self.files["body"])
        poses = np.load(self.files["poses"]).astype(np.float32)
        c2w = cameras.pose_spherical(t["view"]["theta"], t["view"]["phi"], t["view"]["radius"])
        rays_o, rays_d = cameras.canonical_rays(t["res"], t["res"], c2w, self.device)
        out = {}
        for f in sorted(self.witness):
            rgb = frames.render(field, rig, poses[f], t["rest_pose"], rays_o, rays_d, t["bg"], n_probes=t["n_probes"],
                                k=t["k_samples"], chunk=t["chunk"], warp_dtype=prec["warp_dtype"])
            out[f] = rgb.reshape(t["res"], t["res"], 3).cpu().numpy()
        return out

    def compare(self, got, ref) -> dict:
        return compare.compare_frames(got, ref)


def build(ctx) -> AnimJob:
    return AnimJob(ctx)
