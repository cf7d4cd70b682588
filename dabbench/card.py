"""The card's stamp, which every kept number carries: its name, power
limit and highest SM clock, as ``nvidia-smi`` reports them. A frozen copy
of ``viterbi_tpu_torch/probes/_common.py``'s ``card_line`` and
``chip_smoke.py``'s ``sm_clock_hz`` at commit
7d07b678fb927d24a3ae9bba69ca509c72acf088."""

from __future__ import annotations

import subprocess


def _query(field: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={field}",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def stamp() -> dict:
    """{"name", "power_limit_w", "clock_max_sm_hz"} of card 0."""
    return {"name": _query("name"),
            "power_limit_w": float(_query("power.limit")),
            "clock_max_sm_hz": float(_query("clocks.max.sm")) * 1e6}
