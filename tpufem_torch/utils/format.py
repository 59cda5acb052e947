"""Small host utilities (a copy of tpufem/utils/format.py)."""
from __future__ import annotations


def human_readable_number(num: float) -> str:
    """K/M/B/T/Quad/Quint formatting (reference solver/element.py:23-37)."""
    suffixes = [(1e18, "Quint"), (1e15, "Quad"), (1e12, "T"), (1e9, "B"),
                (1e6, "M"), (1e3, "K")]
    for scale, suffix in suffixes:
        if abs(num) >= scale:
            return f"{num / scale:.1f}{suffix}"
    return f"{num:.1f}"
