"""Extended grapheme clusters (Unicode Standard Annex #29), for the
`Precompiled` normalizer (`data/precompiled.py`), which works cluster by
cluster as `tokenizers` does through the `unicode-segmentation` crate.

Built from `unicodedata` (the general categories) plus the small property
tables the rules need, kept here: Prepend, the Mc characters that are not
SpacingMark, Other_Grapheme_Extend, Extended_Pictographic, the
default-ignorable unassigned ranges, and the Hangul L / V / T jamo ranges;
LV and LVT syllables come from the syllable arithmetic. The tables follow
Unicode 15.0 (Python 3.12's `unicodedata.unidata_version`), and the rules are
GB3-GB13 and GB999 of that version; the Indic conjunct rule (GB9c, added in
15.1) is not applied.
"""

from __future__ import annotations

import bisect
import functools
import typing as typ
import unicodedata

# (first, last) code point ranges, sorted
_PREPEND = (
    (0x0600, 0x0605), (0x06DD, 0x06DD), (0x070F, 0x070F), (0x0890, 0x0891), (0x08E2, 0x08E2), (0x0D4E, 0x0D4E),
    (0x110BD, 0x110BD), (0x110CD, 0x110CD), (0x111C2, 0x111C3), (0x1193F, 0x1193F), (0x11941, 0x11941),
    (0x11A3A, 0x11A3A), (0x11A84, 0x11A89), (0x11D46, 0x11D46), (0x11F02, 0x11F02),
)
_OTHER_GRAPHEME_EXTEND = (
    (0x09BE, 0x09BE), (0x09D7, 0x09D7), (0x0B3E, 0x0B3E), (0x0B57, 0x0B57), (0x0BBE, 0x0BBE), (0x0BD7, 0x0BD7),
    (0x0CC2, 0x0CC2), (0x0CD5, 0x0CD6), (0x0D3E, 0x0D3E), (0x0D57, 0x0D57), (0x0DCF, 0x0DCF), (0x0DDF, 0x0DDF),
    (0x1B35, 0x1B35), (0x200C, 0x200C), (0x302E, 0x302F), (0xFF9E, 0xFF9F), (0x1133E, 0x1133E),
    (0x11357, 0x11357), (0x114B0, 0x114B0), (0x114BD, 0x114BD), (0x115AF, 0x115AF), (0x11930, 0x11930),
    (0x1D165, 0x1D165), (0x1D16E, 0x1D172), (0xE0020, 0xE007F),
)
_EMOJI_MODIFIER = ((0x1F3FB, 0x1F3FF),)
# Mc characters that are not SpacingMark
_NOT_SPACING_MARK = (
    (0x102B, 0x102C), (0x1038, 0x1038), (0x1062, 0x1064), (0x1067, 0x106D), (0x1083, 0x1083), (0x1087, 0x108C),
    (0x108F, 0x108F), (0x109A, 0x109C), (0x1A61, 0x1A61), (0x1A63, 0x1A64), (0xAA7B, 0xAA7B), (0xAA7D, 0xAA7D),
    (0x11720, 0x11721),
)
_SPACING_MARK_EXTRA = ((0x0E33, 0x0E33), (0x0EB3, 0x0EB3))  # Lo, but SpacingMark
# unassigned default-ignorable code points: Control
_IGNORABLE_UNASSIGNED = (
    (0x2065, 0x2065), (0xFFF0, 0xFFF8), (0xE0000, 0xE0000), (0xE0002, 0xE001F), (0xE0080, 0xE00FF),
    (0xE01F0, 0xE0FFF),
)
_EXTENDED_PICTOGRAPHIC = (
    (0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C), (0x2049, 0x2049), (0x2122, 0x2122), (0x2139, 0x2139),
    (0x2194, 0x2199), (0x21A9, 0x21AA), (0x231A, 0x231B), (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
    (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB), (0x25B6, 0x25B6), (0x25C0, 0x25C0),
    (0x25FB, 0x25FE), (0x2600, 0x2605), (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
    (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721), (0x2728, 0x2728), (0x2733, 0x2734),
    (0x2744, 0x2744), (0x2747, 0x2747), (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
    (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0), (0x27BF, 0x27BF), (0x2934, 0x2935),
    (0x2B05, 0x2B07), (0x2B1B, 0x2B1C), (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
    (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF), (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F),
    (0x1F16C, 0x1F171), (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A), (0x1F1AD, 0x1F1E5),
    (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A), (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
    (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F), (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F),
    (0x1F7D5, 0x1F7FF), (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F), (0x1F888, 0x1F88F),
    (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A), (0x1F93C, 0x1F945), (0x1F947, 0x1F9FF), (0x1FA00, 0x1FAFF),
    (0x1FC00, 0x1FFFD),
)
_HANGUL_L = ((0x1100, 0x115F), (0xA960, 0xA97C))
_HANGUL_V = ((0x1160, 0x11A7), (0xD7B0, 0xD7C6))
_HANGUL_T = ((0x11A8, 0x11FF), (0xD7CB, 0xD7FB))
_SYLLABLES = (0xAC00, 0xD7A3)
_T_COUNT = 28  # trailing consonants a syllable can take, none included


def _in(table: tuple[tuple[int, int], ...], cp: int) -> bool:
    i = bisect.bisect_right(table, (cp, 0x10FFFF)) - 1
    return i >= 0 and table[i][0] <= cp <= table[i][1]


@functools.lru_cache(maxsize=8192)
def break_property(c: str) -> str:
    """The character's Grapheme_Cluster_Break value: CR, LF, Control, Extend,
    ZWJ, Regional_Indicator ("RI"), Prepend, SpacingMark, L, V, T, LV, LVT or
    Other."""
    cp = ord(c)
    if cp == 0x0D:
        return "CR"
    if cp == 0x0A:
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if _in(_PREPEND, cp):
        return "Prepend"
    if _in(_HANGUL_L, cp):
        return "L"
    if _in(_HANGUL_V, cp):
        return "V"
    if _in(_HANGUL_T, cp):
        return "T"
    if _SYLLABLES[0] <= cp <= _SYLLABLES[1]:
        return "LV" if (cp - _SYLLABLES[0]) % _T_COUNT == 0 else "LVT"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me") or _in(_OTHER_GRAPHEME_EXTEND, cp) or _in(_EMOJI_MODIFIER, cp):
        return "Extend"
    if cat in ("Zl", "Zp", "Cc", "Cf") or (cat == "Cn" and _in(_IGNORABLE_UNASSIGNED, cp)):
        return "Control"
    if (cat == "Mc" and not _in(_NOT_SPACING_MARK, cp)) or _in(_SPACING_MARK_EXTRA, cp):
        return "SpacingMark"
    return "Other"


def is_extended_pictographic(c: str) -> bool:
    return _in(_EXTENDED_PICTOGRAPHIC, ord(c))


_CONTROLS = ("Control", "CR", "LF")


def graphemes(text: str) -> list[str]:
    """`text` cut into extended grapheme clusters (UAX #29, GB3-GB13)."""
    if not text:
        return []
    out: list[str] = []
    start = 0
    prev = break_property(text[0])
    ri_run = 1 if prev == "RI" else 0  # regional indicators ending at prev
    # GB11's state: 1 after Extended_Pictographic Extend*, 2 after its ZWJ
    pict = 1 if is_extended_pictographic(text[0]) else 0
    for i in range(1, len(text)):
        c = text[i]
        cur = break_property(c)
        pict_c = is_extended_pictographic(c)
        if prev == "CR" and cur == "LF":  # GB3
            joined = True
        elif prev in _CONTROLS or cur in _CONTROLS:  # GB4, GB5
            joined = False
        elif prev == "L" and cur in ("L", "V", "LV", "LVT"):  # GB6
            joined = True
        elif prev in ("LV", "V") and cur in ("V", "T"):  # GB7
            joined = True
        elif prev in ("LVT", "T") and cur == "T":  # GB8
            joined = True
        elif cur in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":  # GB9, GB9a, GB9b
            joined = True
        elif prev == "ZWJ" and pict == 2 and pict_c:  # GB11
            joined = True
        elif prev == "RI" and cur == "RI" and ri_run % 2 == 1:  # GB12, GB13
            joined = True
        else:  # GB999
            joined = False
        if not joined:
            out.append(text[start:i])
            start = i
        if pict_c:
            pict = 1
        elif pict == 1 and cur == "Extend":
            pict = 1
        elif pict == 1 and cur == "ZWJ":
            pict = 2
        else:
            pict = 0
        ri_run = ri_run + 1 if cur == "RI" else 0
        prev = cur
    out.append(text[start:])
    return out


def cluster_spans(text: str) -> typ.Iterator[tuple[int, int]]:
    """(start, end) character offsets of each extended grapheme cluster."""
    pos = 0
    for g in graphemes(text):
        yield pos, pos + len(g)
        pos += len(g)
