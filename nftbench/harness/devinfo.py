"""The card's name, clocks, power and power limit, as ``nvidia-smi`` reads
them, for the lines printed beside a window."""

from __future__ import annotations

import shutil
import subprocess

QUERY = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"


def clocks() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        res = subprocess.run([smi, f"--query-gpu={QUERY}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return (res.stdout.strip() or res.stderr.strip()).replace("\n", " | ")
