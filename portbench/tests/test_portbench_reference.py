"""The whole run of each cell at a size the CPU holds, the chip's look
skipped: the port against the plain reference within the cell's own
limits, and ``correct`` false with the timed path broken underneath, once
for each fault the cell can have (a step that leaves its state unchanged;
half of the batch left out, the mean taken over the rest; a frame altered
where it is produced). The cells run on one chip: none has an exchange
between chips to leave out. The card-marked test reads the lower-precision
control on the card at these sizes: it has to fail the cell's limits."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import compare, harness


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def run(root, cell, seconds=0.5):
    result, rows = harness.run_cell(root, cell, 2**33 + 17, seconds, False, time.perf_counter(),
                                    torch.device("cpu"))
    return result, rows


@pytest.mark.parametrize("name", ["recon_scan.fast", "orbit.fast", "anim.fast"])
def test_the_port_holds_to_the_reference(root, tiny_cells, name):
    result, rows = run(root, tiny_cells[name])
    assert result["correct"], rows
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in tiny_cells[name].metrics_e2e}


@pytest.mark.parametrize("name", ["orbit.fast", "anim.fast"])
def test_the_tiny_frames_show_a_body(root, tiny_cells, name):
    """The frames compared are not the background alone."""
    cell = tiny_cells[name]
    ctx = harness.Context(root=root, cell=cell, seed=7, device=torch.device("cpu"), spans=harness.Spans())
    job = harness.job_module(cell.traffic["job"]).build(ctx)
    job.warm()
    job.run_one()
    job.finish()
    for img in job.witness.values():
        assert (abs(img - cell.traffic["bg"]) > 0.05).mean() > 0.05


def _state_unchanged(monkeypatch):
    from avatarcraft_tpu_torch.workloads import reconstruct

    real = reconstruct.make_optimizer

    def frozen(cfg, steps_per_epoch, params):
        opt, sched = real(cfg, steps_per_epoch, params)
        opt.step = lambda closure=None: None
        return opt, sched

    monkeypatch.setattr(reconstruct, "make_optimizer", frozen)


def _half_batch(monkeypatch):
    from avatarcraft_tpu_torch.workloads import reconstruct

    real = reconstruct.mesh_losses

    def half(out, rgb, gt_rgb, mesh):
        h = rgb.shape[0] // 2
        sub = {k: (v[:h] if torch.is_tensor(v) and v.dim() and v.shape[0] == rgb.shape[0] else v)
               for k, v in out.items()}
        return real(sub, rgb[:h], gt_rgb[:h], mesh)

    monkeypatch.setattr(reconstruct, "mesh_losses", half)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(root, tiny_cells, monkeypatch, fault):
    (_state_unchanged if fault == "state_unchanged" else _half_batch)(monkeypatch)
    result, rows = run(root, tiny_cells["recon_scan.fast"])
    assert not result["correct"], rows


def test_an_altered_frame_is_not_correct(root, tiny_cells, monkeypatch):
    from avatarcraft_tpu_torch.workloads import canonical_render, warp_render

    def altering(real):
        def make(*a, **k):
            render = real(*a, **k)

            def frame(*args):
                out = render(*args)
                rgb = (out["rgb"] if isinstance(out, dict) else out).clone()
                rgb[rgb.shape[0] // 3] += 0.1  # one pixel of the answer, past the limit of 0.03
                return {**out, "rgb": rgb} if isinstance(out, dict) else rgb

            return frame

        return make

    monkeypatch.setattr(warp_render, "make_warp_frame_renderer_fast",
                        altering(warp_render.make_warp_frame_renderer_fast))
    monkeypatch.setattr(canonical_render, "make_fast_frame_renderer",
                        altering(canonical_render.make_fast_frame_renderer))
    for name in ("orbit.fast", "anim.fast"):
        result, rows = run(root, tiny_cells[name])
        assert not result["correct"], (name, rows)


@pytest.mark.card
@pytest.mark.parametrize("name", ["recon_scan.fast", "orbit.fast"])
def test_the_lower_precision_control_fails_on_the_card(root, tiny_cells, card, name):
    cell = tiny_cells[name]
    out = harness.check_cell(root, cell, 5, card)
    assert compare.judge(out["program"], cell.limits)[0], out
    assert not compare.judge(out["control"], cell.limits)[0], out
