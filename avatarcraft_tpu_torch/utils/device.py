"""What card a measurement ran on."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one line per card joined by '; ' (a card may run below its 700 W
    maximum, so every time is kept beside its card's limit)."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return "; ".join(line.strip() for line in res.stdout.splitlines() if line.strip())


def tool_device(platform: str) -> str:
    """The device of an offline tool's ``--platform``: ``cpu`` is the CPU,
    ``default`` the CUDA card, refused where there is none (never a quiet
    fall back to the CPU)."""
    if platform == "cpu":
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --platform cpu to run on the CPU")
    return "cuda"
