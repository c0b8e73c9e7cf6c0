"""The yardstick's peaks and byte counts.

Peaks are the data sheet's, by the name ``torch.cuda.get_device_name``
gives: NVIDIA H100 SXM, 80 GB of HBM3 at 3.35 TB/s (dense bf16 989
TFLOP/s).  A card not in the table has no roofline: its shares are not
reported rather than reported against a guess.
"""
from __future__ import annotations

#: device name -> HBM bytes per second
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bandwidth(device_name: str):
    return HBM_BYTES_PER_S.get(device_name)


def sort_bytes(records: int, record_bytes: int) -> int:
    """The least traffic of any sort that leaves its input in place: each
    record read once and written once."""
    return 2 * records * record_bytes


def share_pct(bytes_moved: float, seconds: float, bandwidth):
    """Per cent of the peak that ``bytes_moved`` in ``seconds`` reaches;
    None where there is no peak or no time."""
    if bandwidth is None or not seconds or seconds <= 0:
        return None
    return 100.0 * bytes_moved / bandwidth / seconds
