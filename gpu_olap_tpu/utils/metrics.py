"""Metrics / observability.

The reference has log lines only (SURVEY.md §5); BASELINE targets require a
bytes-moved / rows-per-second meter with HBM-roofline accounting, so the engine
carries a metrics registry: per-operator wall clock, rows in/out, bytes
touched, and achieved fraction of the per-chip HBM bandwidth roofline.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

# Published device-memory bandwidth (bytes/s) per accelerator, keyed by the
# lower-cased ``device_kind`` JAX reports; roofline shares divide by these.
# H100 SXM: 3.35 TB/s HBM3 (NVIDIA H100 Tensor Core GPU data sheet).
HBM_BW_BY_DEVICE_KIND = {
    "nvidia h100 80gb hbm3": 3.35e12,
}


def detect_hbm_bandwidth() -> Optional[float]:
    """Peak device-memory bandwidth of ``jax.devices()[0]``.

    ``None`` on the CPU backend (no device roofline: "not measured"); an
    accelerator missing from the table raises instead of borrowing another
    device's peak."""
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return None
    kind = dev.device_kind.lower()
    if kind not in HBM_BW_BY_DEVICE_KIND:
        raise KeyError(f"no published memory bandwidth for device kind "
                       f"{dev.device_kind!r}; add it to HBM_BW_BY_DEVICE_KIND")
    return HBM_BW_BY_DEVICE_KIND[kind]


def gpu_name_and_power_limit() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, read
    by a child process (the caller stays off JAX); None without the tool."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


@dataclasses.dataclass
class OpStats:
    calls: int = 0
    seconds: float = 0.0
    rows_in: int = 0
    rows_out: int = 0
    bytes_accessed: int = 0

    @property
    def rows_per_sec(self) -> float:
        return self.rows_in / self.seconds if self.seconds > 0 else 0.0


class MetricsRegistry:
    def __init__(self):
        self.ops: Dict[str, OpStats] = collections.defaultdict(OpStats)
        self.counters: Dict[str, float] = collections.defaultdict(float)
        self._hbm_bw: Optional[float] = None
        self._hbm_bw_known = False

    def record_span(self, label: str, seconds: float, rows_in: int = 0,
                    rows_out: int = 0, bytes_accessed: int = 0, **_):
        st = self.ops[label]
        st.calls += 1
        st.seconds += seconds
        st.rows_in += rows_in
        st.rows_out += rows_out
        st.bytes_accessed += bytes_accessed

    def bump(self, name: str, value: float = 1.0):
        self.counters[name] += value

    @property
    def hbm_bandwidth(self) -> Optional[float]:
        if not self._hbm_bw_known:
            self._hbm_bw = detect_hbm_bandwidth()
            self._hbm_bw_known = True
        return self._hbm_bw

    def roofline_fraction(self, label: str) -> Optional[float]:
        """Achieved fraction of peak device-memory bandwidth for an operator;
        ``None`` where no device peak applies (CPU backend)."""
        st = self.ops.get(label)
        if st is None or st.seconds == 0 or self.hbm_bandwidth is None:
            return None
        return (st.bytes_accessed / st.seconds) / self.hbm_bandwidth

    def summary(self) -> List[dict]:
        out = []
        for label, st in sorted(self.ops.items()):
            out.append({
                "op": label,
                "calls": st.calls,
                "seconds": round(st.seconds, 6),
                "rows_in": st.rows_in,
                "rows_out": st.rows_out,
                "bytes": st.bytes_accessed,
                "rows_per_sec": round(st.rows_per_sec, 1),
                "hbm_roofline_frac": self.roofline_fraction(label),
            })
        return out

    def reset(self):
        self.ops.clear()
        self.counters.clear()


GLOBAL_METRICS = MetricsRegistry()


class Timer:
    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False
