"""The card a measurement ran on, as ``nvidia-smi`` names it: every time
or rate the port records stands beside the card's name and power limit
(an H100 set below its 700 W runs slower under load)."""
from __future__ import annotations

import subprocess


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]
