"""Porter stemmer (Porter 1980, "An algorithm for suffix stripping").

The port's copy of `vod_tpu/native/porter.py`, which it does not import; the
copy matches its reference token for token, faults included.

Parity: ES language analyzers stem (reference `vod_configs/utils/es_body.py:32`
maps 33 languages onto ES's `<lang>` analyzers, whose English pipeline is
lowercase -> stop -> porter_stem). This is the ORIGINAL Porter algorithm —
the exact published spec, not Porter2/Snowball — implemented twice: here
(the reference/fallback) and in `analyzer.cpp` (the native hot path), with a
token-level parity test keeping the two in lock-step. Applied to ASCII-only
tokens; non-English tokens pass through unchanged (Porter is English).
"""

from __future__ import annotations

_VOWELS = frozenset("aeiou")


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """m = number of VC sequences in the C?(VC){m}V? decomposition."""
    m = 0
    i, n = 0, len(stem)
    while i < n and _is_cons(stem, i):
        i += 1
    while i < n:
        while i < n and not _is_cons(stem, i):
            i += 1
        if i >= n:
            break
        m += 1
        while i < n and _is_cons(stem, i):
            i += 1
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (
        len(word) >= 2
        and word[-1] == word[-2]
        and _is_cons(word, len(word) - 1)
    )


def _ends_cvc(word: str) -> bool:
    """*o: stem ends cvc where the final c is not w, x or y."""
    if len(word) < 3:
        return False
    n = len(word)
    return (
        _is_cons(word, n - 1)
        and not _is_cons(word, n - 2)
        and _is_cons(word, n - 3)
        and word[-1] not in "wxy"
    )


# (suffix, replacement) maps for steps 2 and 3; longest-match-first within
# each step is guaranteed by ordering (checked in order, first match wins —
# Porter's spec conditions each rule on the suffix being present, and at most
# one rule per step fires)
_STEP2 = (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
    ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
    ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
    ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
    ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
)
_STEP3 = (
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", ""),
)
_STEP4 = (
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
    "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
)


def porter_stem(word: str) -> str:
    """Stem one lowercase ASCII token (the original Porter algorithm)."""
    if len(word) <= 2:
        return word
    w = word

    # ---- step 1a ----
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # ---- step 1b ----
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        flag_1b = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w = w + "e"
        elif _ends_double_cons(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _ends_cvc(w):
            w = w + "e"

    # ---- step 1c ----
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # ---- step 2 ----
    for suf, rep in _STEP2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # ---- step 3 ----
    for suf, rep in _STEP3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # ---- step 4 ----
    for suf in _STEP4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and (not stem or stem[-1] not in "st"):
                    pass
                else:
                    w = stem
            break

    # ---- step 5a ----
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _ends_cvc(w[:-1])):
            w = w[:-1]

    # ---- step 5b ----
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]

    return w
