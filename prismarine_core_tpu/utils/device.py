"""The accelerator a measurement runs on, and refusing to run without it."""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> dict:
    """Device record of the GPU JAX runs on; raises SystemExit when
    JAX's default device is not a GPU (a measurement never falls back
    to the CPU)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev.platform} "
                         f"({dev.device_kind})")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, run
    as a child process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()
