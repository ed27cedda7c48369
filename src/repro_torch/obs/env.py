"""Environment provenance stamp for benchmark artifacts.

``env_info()`` answers "what machine, what stack, what commit produced
these numbers": the JAX package's stamp with the torch stack in place of
jax's, so a number read off the card carries the card's name and power
limit beside it (a card set below its 700 W maximum runs slower under
load).
"""
from __future__ import annotations

import os
import shutil
import subprocess
from datetime import datetime, timezone

import torch


def _git_sha() -> str | None:
    try:
        here = os.path.dirname(os.path.abspath(__file__))
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=here,
            capture_output=True, text=True, timeout=5)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.SubprocessError):
        return None


def card_line() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, as
    the tool prints it (None without the tool or a card)."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def env_info() -> dict:
    """Versions, device, cores, git SHA, UTC timestamp.  The device keys
    (``device_kind``, ``n_devices``, ``card``) are present only when
    there is a card."""
    info: dict = {
        "cpu_count": os.cpu_count(),
        "git_sha": _git_sha(),
        "timestamp_utc": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if torch.cuda.is_available():
        info["device_kind"] = torch.cuda.get_device_name(0)
        info["n_devices"] = torch.cuda.device_count()
        card = card_line()
        if card is not None:
            info["card"] = card
    return info
