"""AvatarCraft on PyTorch and CUDA: the port of the JAX package to an NVIDIA
H100 (Hopper, ``sm_90a``).

The JAX package in this repository stays the reference; this package is
held against it by the ``tests/test_torch_*.py`` files on the CPU, and by
``chip_smoke.py`` on the card. It imports neither JAX nor the JAX package.

Layout, slice 1 (the fast canonical render of a baked artifact):
    cameras/    -- pinhole camera, orbit paths, ray generation
    ops/        -- near/far, bit-packed occupancy + compaction, pyramid encoder
    models/     -- the NeuS field (weight-norm MLPs) and the fast render
    parallel/   -- row-sharded grid table + the all-gather kernel wrapper
    workloads/  -- the per-frame renderer (gather -> splice -> chunked render)
    utils/      -- checkpoint loading, PNG writer, nvcc build of csrc/
    cli/        -- render_canonical_cli (--sampler fast)
    csrc/       -- hand-written CUDA kernels with a plain C interface
    bench.py    -- canonical 256x256 render throughput on the card

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
