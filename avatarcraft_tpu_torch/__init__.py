"""AvatarCraft on PyTorch and CUDA: the port of the JAX package to an NVIDIA
H100 (Hopper, ``sm_90a``).

The JAX package in this repository stays the reference; this package is
held against it by the ``tests/test_torch_*.py`` files on the CPU, and by
``chip_smoke.py`` on the card. It imports neither JAX nor the JAX package.

Layout:
    cameras/    -- pinhole camera, orbit and stylize paths, ray generation
    ops/        -- near/far, samplers, density grid refresh and floater
                   pruning, bit-packed occupancy + compaction, pyramid
                   encoder
    models/     -- the NeuS field (weight-norm MLPs, init), the fast render
                   and the 64+64 importance-sampled render, fd7/fd4/analytic
                   normals; the SMPL body; the guidance UNet (sd), SDS
                   (diffusion) and the toy guidance
    parallel/   -- row-sharded grid table, the all-gather kernel and its
                   reduce-scatter backward, the table-parallel train step
    warp/       -- the kNN inverse-LBS warp
    data/       -- AMASS pose sequences, the Blender-format dataset loader
    workloads/  -- the per-frame renderers (canonical, warped), the fast
                   reconstruction trainer, the SDS stylize trainer
    utils/      -- checkpoints, PNG I/O, nvcc build of csrc/, backgrounds,
                   style deltas, timing
    cli/        -- render_canonical_cli, render_warp_cli, stylize_cli
                   (--sampler fast)
    csrc/       -- hand-written CUDA kernels with a plain C interface
    bench.py    -- canonical and warped 256x256 render throughput
    profile_render.py, profile_train.py -- where a frame's, a train
                   step's and an SDS step's time goes on the card

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
