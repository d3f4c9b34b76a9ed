"""What a measurement ran on: the JAX device and the card behind it.

Every number the benchmark scripts print carries these fields, because a
card can be set below its maximum power limit and then runs slower.
"""

from __future__ import annotations

import subprocess


def card_info() -> str:
    """``name, power.limit`` of the NVIDIA card(s) as ``nvidia-smi`` reports
    them (one line per card, joined with "; "), or "not available". Read
    by a subprocess that stays off JAX."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]
    if res.returncode != 0 or not lines:
        return "not available"
    return "; ".join(lines)


def device_fields(card: str | None = None) -> dict:
    """platform, device_kind, device count and card of this process."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "device_count": len(devs),
            "card": card if card is not None else card_info()}


def require_gpu(what: str) -> None:
    """Exit non-zero unless JAX's default device is a GPU: a benchmark
    never carries on on the CPU and reports the CPU's numbers."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"{what}: needs a GPU, but JAX's default device "
                         f"is {platform!r}")
