"""Device resolution and the platform probe.

Counterpart of ``repro.kernels.ops._platform``: the port's entry points
run on ``cuda`` unless the caller names another device, and never carry
on quietly on the CPU when no card is present.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

# where the CUDA toolkit installs nvcc when it is not on PATH
_CUDA_HOME_NVCC = "/usr/local/cuda/bin/nvcc"


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises when ``device`` is None and no CUDA device is present: an entry
    point that is not told to run on the CPU must not fall back to it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def nvcc_path() -> Optional[str]:
    """The CUDA compiler, from PATH or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    return _CUDA_HOME_NVCC if os.path.exists(_CUDA_HOME_NVCC) else None


def gpu_name_and_power_limit() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, as
    nvidia-smi prints it (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``), or
    None when nvidia-smi is missing."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def platform_info(device: DeviceLike = None) -> dict:
    """What runs where: the device, its name, power limit and compute
    capability, the torch and CUDA versions and the nvcc path. Recorded
    beside every measurement the port reports."""
    dev = resolve_device(device)
    info = {
        "device": str(dev),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc_path(),
    }
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        info["name"] = torch.cuda.get_device_name(idx)
        info["capability"] = "%d.%d" % torch.cuda.get_device_capability(idx)
        info["count"] = torch.cuda.device_count()
        info["nvidia_smi"] = gpu_name_and_power_limit()
    return info
