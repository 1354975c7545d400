"""Vietnamese diacritic canonicalization (old-style → new-style tone
placement).

Capability of the reference's tone normalizer
(reference src/data/features/VietnameseToneNormalization.py:4-55: a
hard-coded 47-entry `dict_map` + `replace_all`).  Same linguistic mapping —
for the vowel clusters oa/oe/uy the old orthography places the tone mark on
the first vowel, the modern standard places it on the second — but the map
is GENERATED from the cluster/tone tables (with lower/Title/UPPER case
variants) rather than hand-enumerated, and replacement runs as one compiled
regex pass instead of 141 sequential str.replace calls.

The port's copy of ``vietnamese_qa_system_tpu/etl/normalize.py``.
"""

from __future__ import annotations

import re

# tone variants for each base vowel: (huyền, sắc, hỏi, ngã, nặng)
_TONES = {
    "a": "àáảãạ",
    "e": "èéẻẽẹ",
    "o": "òóỏõọ",
    "u": "ùúủũụ",
    "y": "ỳýỷỹỵ",
}
# clusters where the tone moves from the first to the second vowel
_CLUSTERS = [("o", "a"), ("o", "e"), ("u", "y")]


def _build_map() -> dict[str, str]:
    mapping: dict[str, str] = {}
    for first, second in _CLUSTERS:
        for tone_idx in range(5):
            old = _TONES[first][tone_idx] + second
            new = first + _TONES[second][tone_idx]
            mapping[old] = new  # lower: òa -> oà
            mapping[old.capitalize()] = new.capitalize()  # Òa -> Oà
            mapping[old.upper()] = new.upper()  # ÒA -> OÀ
    return mapping


TONE_MAP = _build_map()
_TONE_RE = re.compile("|".join(map(re.escape, TONE_MAP)))


def normalize_tones(text: str) -> str:
    """Replace every old-style cluster in one pass (reference `replace_all`,
    VietnameseToneNormalization.py:53)."""
    return _TONE_RE.sub(lambda m: TONE_MAP[m.group(0)], text)
