"""Kubernetes-style resource quantity parsing.

The reference leans on apimachinery's ``resource.Quantity`` for MPS
pinned-device-memory limits (api/nvidia.com/resource/v1beta1/sharing.go).
We implement the subset the driver needs: binary (Ki..Ei) and decimal
(k..E, m) suffixes, canonical round-trip, and byte conversion.
"""

from __future__ import annotations

from fractions import Fraction

_BINARY = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3,
           "Ti": 1024**4, "Pi": 1024**5, "Ei": 1024**6}
_DECIMAL = {"k": 10**3, "M": 10**6, "G": 10**9,
            "T": 10**12, "P": 10**15, "E": 10**18, "m": Fraction(1, 1000)}
_SUFFIXES = tuple(sorted(list(_BINARY) + list(_DECIMAL), key=len, reverse=True))


class Quantity:
    """Immutable parsed quantity; compares by value."""

    __slots__ = ("_value", "_text")

    def __init__(self, text: str):
        if isinstance(text, (int, float)):
            text = str(text)
        s = text.strip()
        if not s:
            raise ValueError("empty quantity")
        suffix = ""
        for cand in _SUFFIXES:
            if s.endswith(cand):
                suffix = cand
                s = s[: -len(cand)]
                break
        try:
            num = Fraction(s)
        except (ValueError, ZeroDivisionError) as e:
            raise ValueError(f"invalid quantity {text!r}") from e
        mult = _BINARY.get(suffix) or _DECIMAL.get(suffix) or 1
        self._value = num * mult
        self._text = text.strip()

    @property
    def value(self) -> int:
        """Integer value, rounding up (matches apimachinery Value())."""
        v = self._value
        return int(v) if v.denominator == 1 else int(v) + (1 if v > 0 else 0)

    def __eq__(self, other) -> bool:
        return isinstance(other, Quantity) and self._value == other._value

    def __lt__(self, other: "Quantity") -> bool:
        return self._value < other._value

    def __hash__(self) -> int:
        return hash(self._value)

    def __str__(self) -> str:
        return self._text

    def __repr__(self) -> str:
        return f"Quantity({self._text!r})"


def parse_quantity(text: str) -> Quantity:
    return Quantity(text)
