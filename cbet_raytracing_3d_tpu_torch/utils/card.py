"""What a measurement names its device by: the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``), the
torch and CUDA versions, and the cards the process sees.

A card below its maximum power limit runs slower under load, so a number
taken on the card is kept beside the card's name and limit.  On a CUDA
device a failing ``nvidia-smi`` is an error: a record without the card's
name is not the card's number.

``nvidia-smi`` numbers the cards in PCI order and ignores
``CUDA_VISIBLE_DEVICES``, while a torch ordinal follows the visible set and
``CUDA_DEVICE_ORDER``; so the card is found by its PCI address or its UUID,
never by its ordinal.  Where nvidia-smi hides both (some hosts show
``[N/A]`` and ``GPU-REDACTED``), only a lone card can be named.
"""

from __future__ import annotations

import re
import subprocess

import torch


def _parse_pci(bus_id: str) -> tuple[int, int, int] | None:
    """``nvidia-smi``'s ``pci.bus_id`` (``00000000:18:00.0``) as (domain,
    bus, device); None where it is hidden (``[N/A]``)."""
    try:
        domain, bus, dev_fn = bus_id.strip().split(":")
        return int(domain, 16), int(bus, 16), int(dev_fn.split(".")[0], 16)
    except ValueError:
        return None


def _uuid_shown(uuid: str) -> bool:
    """Whether ``nvidia-smi``'s ``uuid`` is one (not ``GPU-REDACTED``)."""
    return re.fullmatch(r"GPU-[0-9a-fA-F-]{36}", uuid.strip()) is not None


def nvidia_smi_line(index: int = 0) -> str:
    """``nvidia-smi``'s ``name, power.limit`` line for the torch CUDA device
    ``index``, as it prints it (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``):
    the card at that device's PCI address or with its UUID, or the one card
    nvidia-smi lists when it hides both.  Raises when the tool fails or no
    card can be told to be that device."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=pci.bus_id,uuid,name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed (rc {proc.returncode}): "
                           f"{proc.stderr.strip()[-500:]}")
    cards = [line.split(",", 2) for line in proc.stdout.strip().splitlines()]
    p = torch.cuda.get_device_properties(index)
    pci = (p.pci_domain_id, p.pci_bus_id, p.pci_device_id)
    uuid = f"GPU-{p.uuid}".lower()
    for bus_id, card_uuid, line in cards:
        if _parse_pci(bus_id) == pci or card_uuid.strip().lower() == uuid:
            return line.strip()
    if len(cards) == 1 and _parse_pci(cards[0][0]) is None \
            and not _uuid_shown(cards[0][1]):
        return cards[0][2].strip()
    raise RuntimeError(f"nvidia-smi lists no card at PCI address "
                       f"{pci[0]:08x}:{pci[1]:02x}:{pci[2]:02x} or with UUID "
                       f"{uuid} (CUDA device {index}): "
                       f"{proc.stdout.strip()[-500:]}")


def power_limit_watts(smi_line: str) -> float:
    """The power limit of an :func:`nvidia_smi_line`, in watts."""
    limit = smi_line.rsplit(",", 1)[-1].strip()
    if not limit.endswith(" W"):
        raise ValueError(f"no power limit in nvidia-smi's line {smi_line!r}")
    return float(limit[:-2])


def card_info(device) -> dict:
    """The keys a record names its device by: ``device_name``,
    ``power_limit_w`` and ``nvidia_smi`` (None off the card),
    ``torch_version``, ``cuda_version`` (``torch.version.cuda``) and
    ``devices_available`` (``torch.cuda.device_count()``, 1 on the CPU)."""
    device = torch.device(device)
    info = {"device_name": None, "power_limit_w": None, "nvidia_smi": None,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda, "devices_available": 1}
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        smi = nvidia_smi_line(index)
        info.update(device_name=torch.cuda.get_device_name(index),
                    power_limit_w=power_limit_watts(smi), nvidia_smi=smi,
                    devices_available=torch.cuda.device_count())
    return info
