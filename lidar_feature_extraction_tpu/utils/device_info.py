"""Which accelerator a measurement ran on.

Every timing the scripts print names the device as JAX reports it and,
on an NVIDIA card, its name and power limit as ``nvidia-smi`` reads
them: a card held below its full power limit runs slower under load.
"""

from __future__ import annotations

import shutil
import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def nvidia_smi_lines() -> list[str]:
    """One ``name, power.limit`` line per card; empty without nvidia-smi."""
    if shutil.which(NVIDIA_SMI_QUERY[0]) is None:
        return []
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         timeout=30, check=False)
    return [line.strip() for line in out.stdout.splitlines()
            if line.strip()]


def parse_nvidia_smi(line: str) -> dict:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> name and limit in watts
    (None where nvidia-smi reports ``[N/A]``)."""
    name, _, limit = line.rpartition(",")
    if not name:
        raise ValueError(f"not a 'name, power.limit' line: {line!r}")
    value = limit.strip().removesuffix("W").strip()
    try:
        watts = float(value)
    except ValueError:
        watts = None
    return {"name": name.strip(), "power_limit_w": watts}


def device_record() -> dict:
    """JAX's view of the devices plus the first card's nvidia-smi line."""
    import jax

    devices = jax.devices()
    rec = {"platform": devices[0].platform,
           "kind": devices[0].device_kind,
           "count": len(devices)}
    lines = nvidia_smi_lines()
    if lines:
        rec["nvidia_smi"] = lines[0]
        rec.update(parse_nvidia_smi(lines[0]))
    return rec
