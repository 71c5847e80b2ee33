"""Snowball stemmers for German, Spanish and French (reference/fallback path).

The port's copy of `vod_tpu/native/snowball.py`, which it does not import; the
copy matches its reference token for token, faults included.

Parity: ES stems each of its 33 mapped languages via `<lang>` analyzers
(reference `vod_configs/utils/es_body.py:32,101`); round 4 covered English
(the original Porter 1980 algorithm, `porter.py`). This adds the three
highest-value non-English languages, implemented from the published Snowball
specifications (Porter's snowballstem.org algorithm descriptions — public
1980s/2000s specs, like Porter itself; French follows the classic spec,
without the post-2015 `ë/ï -> He/Hi` revision). Each algorithm is implemented
twice: here (the reference/fallback) and in `analyzer.cpp` (the native hot
path), with token-level parity tests keeping the two in lock-step
(`tests/test_stemming.py`).

Languages NOT covered here pass through unstemmed, matching the round-4
contract for non-English: BM25 on unstemmed tokens is well-defined (exact
surface matching), just weaker on morphology-rich queries. The stopword
filter still covers all 33 languages (`stopwords.py`).
"""

from __future__ import annotations

__all__ = [
    "german_stem", "spanish_stem", "french_stem", "russian_stem", "italian_stem",
    "dutch_stem", "portuguese_stem", "swedish_stem", "norwegian_stem",
    "danish_stem", "snowball_stem", "STEMMED_LANGUAGES",
]

STEMMED_LANGUAGES = {
    "english": 1, "german": 2, "spanish": 3, "french": 4, "russian": 5, "italian": 6,
    "dutch": 7, "portuguese": 8, "swedish": 9, "norwegian": 10, "danish": 11,
}


def snowball_stem(token: str, language: str) -> str:
    """Stem `token` (already lowercased) for `language`; pass-through when the
    language has no stemmer here."""
    if language == "english":
        from .porter import porter_stem

        return porter_stem(token) if token.isascii() else token
    if language == "german":
        return german_stem(token)
    if language == "spanish":
        return spanish_stem(token)
    if language == "french":
        return french_stem(token)
    if language == "russian":
        return russian_stem(token)
    if language == "italian":
        return italian_stem(token)
    if language == "dutch":
        return dutch_stem(token)
    if language == "portuguese":
        return portuguese_stem(token)
    if language == "swedish":
        return swedish_stem(token)
    if language == "norwegian":
        return norwegian_stem(token)
    if language == "danish":
        return danish_stem(token)
    return token


# --------------------------------------------------------------------------- #
# German (Snowball german stemmer)
# --------------------------------------------------------------------------- #

_DE_VOWELS = frozenset("aeiouyäöü")
_DE_S_ENDING = frozenset("bdfghklmnrt")
_DE_ST_ENDING = frozenset("bdfghklmnt")


def _de_mark_regions(w: str) -> tuple[int, int]:
    """(r1, r2) start offsets. R1 = after the first non-vowel following a
    vowel; R2 = the same, computed inside R1. R1 is adjusted so that the
    region before it is at least 3 letters."""
    n = len(w)

    def next_region(start: int) -> int:
        i = start
        while i < n and w[i] not in _DE_VOWELS:
            i += 1
        while i < n and w[i] in _DE_VOWELS:
            i += 1
        return min(i + 1, n) if i < n else n

    r1 = next_region(0)
    r2 = next_region(r1)
    if r1 < 3:
        r1 = min(3, n)
    return r1, r2


def german_stem(word: str) -> str:
    w = word.replace("ß", "ss")
    n = len(w)
    if n <= 2:
        return w.replace("ä", "a").replace("ö", "o").replace("ü", "u")

    # u/y between vowels are consonants: mark upper-case
    chars = list(w)
    for i in range(1, n - 1):
        if chars[i] in ("u", "y") and w[i - 1] in _DE_VOWELS and w[i + 1] in _DE_VOWELS:
            chars[i] = chars[i].upper()
    w = "".join(chars)
    # regions over the MARKED string: uppercase U/Y are not in the vowel set,
    # so they count as consonants exactly as the marking intends
    r1, r2 = _de_mark_regions(w)

    def in_r1(pos: int) -> bool:
        return pos >= r1

    def in_r2(pos: int) -> bool:
        return pos >= r2

    # step 1
    step1a = ("ern", "em", "er")
    step1b = ("en", "es", "e")
    done = False
    for suf in step1a:
        if w.endswith(suf):
            if in_r1(len(w) - len(suf)):
                w = w[: -len(suf)]
            done = True
            break
    if not done:
        for suf in step1b:
            if w.endswith(suf):
                if in_r1(len(w) - len(suf)):
                    w = w[: -len(suf)]
                    if w.endswith("niss"):
                        w = w[:-1]
                done = True
                break
    if not done and w.endswith("s"):
        if in_r1(len(w) - 1) and len(w) >= 2 and w[-2] in _DE_S_ENDING:
            w = w[:-1]

    # step 2
    done = False
    for suf in ("est", "en", "er"):
        if w.endswith(suf):
            if in_r1(len(w) - len(suf)):
                w = w[: -len(suf)]
            done = True
            break
    if not done and w.endswith("st"):
        if in_r1(len(w) - 2) and len(w) >= 6 and w[-3] in _DE_ST_ENDING:
            w = w[:-2]

    # step 3 (d-suffixes)
    if w.endswith(("end", "ung")):
        if in_r2(len(w) - 3):
            w = w[:-3]
            if w.endswith("ig") and not w.endswith("eig") and in_r2(len(w) - 2):
                w = w[:-2]
    elif w.endswith(("ig", "ik")):
        pos = len(w) - 2
        if in_r2(pos) and (pos == 0 or w[pos - 1] != "e"):
            w = w[:-2]
    elif w.endswith("isch"):
        pos = len(w) - 4
        if in_r2(pos) and (pos == 0 or w[pos - 1] != "e"):
            w = w[:-4]
    elif w.endswith(("lich", "heit")):
        if in_r2(len(w) - 4):
            w = w[:-4]
            for pre in ("er", "en"):
                if w.endswith(pre) and in_r1(len(w) - 2):
                    w = w[:-2]
                    break
    elif w.endswith("keit"):
        if in_r2(len(w) - 4):
            w = w[:-4]
            if w.endswith("lich") and in_r2(len(w) - 4):
                w = w[:-4]
            elif w.endswith("ig") and in_r2(len(w) - 2):
                w = w[:-2]

    # finally
    w = w.lower()
    return w.replace("ä", "a").replace("ö", "o").replace("ü", "u")


# --------------------------------------------------------------------------- #
# Spanish (Snowball spanish stemmer)
# --------------------------------------------------------------------------- #

_ES_VOWELS = frozenset("aeiouáéíóúü")
_ES_DEACCENT = str.maketrans("áéíóú", "aeiou")


def _es_rv(w: str) -> int:
    n = len(w)
    if n < 3:
        return n
    if w[1] not in _ES_VOWELS:  # X C ... : after the next vowel
        i = 2
        while i < n and w[i] not in _ES_VOWELS:
            i += 1
        return min(i + 1, n)
    if w[0] in _ES_VOWELS and w[1] in _ES_VOWELS:  # V V ... : after next consonant
        i = 2
        while i < n and w[i] in _ES_VOWELS:
            i += 1
        return min(i + 1, n)
    return 3  # C V ... : after the third letter


def _es_regions(w: str) -> tuple[int, int]:
    n = len(w)

    def next_region(start: int) -> int:
        i = start
        while i < n and w[i] not in _ES_VOWELS:
            i += 1
        while i < n and w[i] in _ES_VOWELS:
            i += 1
        return min(i + 1, n) if i < n else n

    r1 = next_region(0)
    return r1, next_region(r1)


_ES_PRON = (
    "selas", "selos", "sela", "selo", "las", "les", "los", "nos",
    "me", "se", "la", "le", "lo",
)
_ES_PRON_A = ("iéndo", "ándo", "ár", "ér", "ír")
_ES_PRON_A_FIX = {"iéndo": "iendo", "ándo": "ando", "ár": "ar", "ér": "er", "ír": "ir"}
_ES_PRON_B = ("iendo", "ando", "ar", "er", "ir")

_ES_STEP2B_GU = ("en", "es", "éis", "emos")
_ES_STEP2B = (
    "aríamos", "eríamos", "iríamos", "iéramos", "iésemos", "aríais", "aseis",
    "eríais", "iríais", "ieseis", "asteis", "isteis", "ábamos", "áramos",
    "ásemos", "arían", "arías", "aréis", "erían", "erías", "eréis", "irían",
    "irías", "iréis", "ieran", "iesen", "ieron", "iendo", "ieras", "ieses",
    "abais", "arais", "íamos", "emos", "arán", "arás", "aría", "erán", "erás",
    "ería", "irán", "irás", "iría", "iera", "iese", "aste", "iste", "aban",
    "aran", "asen", "aron", "ando", "abas", "adas", "idas", "aras", "ases",
    "íais", "ados", "idos", "amos", "imos", "ían", "ado", "ido", "ías", "áis",
    "ía", "ad", "ed", "id", "an", "ió", "ar", "er", "ir", "as", "ís",
)
_ES_STEP3_GU = ("e", "é")
_ES_STEP3 = ("os", "a", "o", "á", "í", "ó")


def spanish_stem(word: str) -> str:
    w = word
    rv = _es_rv(w)
    r1, r2 = _es_regions(w)

    def in_rv(pos: int) -> bool:
        return pos >= rv

    def in_r1(pos: int) -> bool:
        return pos >= r1

    def in_r2(pos: int) -> bool:
        return pos >= r2

    # step 0: attached pronoun
    for pron in _ES_PRON:
        if not w.endswith(pron):
            continue
        base = w[: -len(pron)]
        matched = False
        for a in _ES_PRON_A:
            if base.endswith(a) and in_rv(len(base) - len(a)):
                w = base[: -len(a)] + _ES_PRON_A_FIX[a]
                matched = True
                break
        if not matched:
            for b in _ES_PRON_B:
                if base.endswith(b) and in_rv(len(base) - len(b)):
                    w = base
                    matched = True
                    break
        if not matched and base.endswith("yendo") and base[-6:-5] == "u":
            w = base
            matched = True
        break  # longest pronoun match only
    # regions stay FIXED after step 0 (Snowball semantics: region starts are
    # positions in the original word; end-deletions never move them)

    n0 = len(w)
    # step 1: standard suffixes (longest match)
    step1_done = False
    suffix_groups: list[tuple[tuple[str, ...], str, str]] = [
        # (suffixes, action, required region): action 'del'/'log'/'u'/'ente'
        (("amientos", "imientos", "amiento", "imiento", "anzas", "ismos",
          "ables", "ibles", "istas", "anza", "icos", "icas", "ismo", "able",
          "ible", "ista", "osos", "osas", "ico", "ica", "oso", "osa"), "del", "r2"),
        (("aciones", "adoras", "adores", "ancias", "adora", "ación", "antes",
          "ancia", "ador", "ante"), "del_ic", "r2"),
        (("logías", "logía"), "log", "r2"),
        (("uciones", "ución"), "u", "r2"),
        (("encias", "encia"), "ente", "r2"),
        (("amente",), "amente", "r1"),
        (("mente",), "mente", "r2"),
        (("idades", "idad"), "idad", "r2"),
        (("ivas", "ivos", "iva", "ivo"), "iv", "r2"),
    ]
    # longest-match across all groups
    best: tuple[str, str, str] | None = None
    for sufs, action, region in suffix_groups:
        for suf in sufs:
            if w.endswith(suf) and (best is None or len(suf) > len(best[0])):
                best = (suf, action, region)
    if best is not None:
        suf, action, region = best
        pos = len(w) - len(suf)
        ok = in_r2(pos) if region == "r2" else in_r1(pos)
        if ok:
            step1_done = True
            if action == "del":
                w = w[:pos]
            elif action == "del_ic":
                w = w[:pos]
                if w.endswith("ic") and in_r2(len(w) - 2):
                    w = w[:-2]
            elif action == "log":
                w = w[:pos] + "log"
            elif action == "u":
                w = w[:pos] + "u"
            elif action == "ente":
                w = w[:pos] + "ente"
            elif action == "amente":
                w = w[:pos]
                if w.endswith("iv") and in_r2(len(w) - 2):
                    w = w[:-2]
                    if w.endswith("at") and in_r2(len(w) - 2):
                        w = w[:-2]
                else:
                    for pre in ("os", "ic", "ad"):
                        if w.endswith(pre) and in_r2(len(w) - 2):
                            w = w[:-2]
                            break
            elif action == "mente":
                w = w[:pos]
                for pre in ("ante", "able", "ible"):
                    if w.endswith(pre) and in_r2(len(w) - 4):
                        w = w[:-4]
                        break
            elif action == "idad":
                w = w[:pos]
                for pre in ("abil", "ic", "iv"):
                    if w.endswith(pre) and in_r2(len(w) - len(pre)):
                        w = w[: -len(pre)]
                        break
            elif action == "iv":
                w = w[:pos]
                if w.endswith("at") and in_r2(len(w) - 2):
                    w = w[:-2]
        else:
            step1_done = False

    # step 2a: verb suffixes beginning y (only if step 1 removed nothing)
    if not step1_done and len(w) == n0:
        for suf in ("yeron", "yendo", "yamos", "yais", "yan", "yen", "yas",
                    "yes", "ya", "ye", "yo", "yó"):
            if w.endswith(suf):
                pos = len(w) - len(suf)
                if in_rv(pos) and pos > 0 and w[pos - 1] == "u":
                    w = w[:pos]
                break
        # step 2b (only if 2a removed nothing)
        if len(w) == n0:
            matched = None
            for suf in _ES_STEP2B_GU + _ES_STEP2B:
                if w.endswith(suf) and (matched is None or len(suf) > len(matched)):
                    matched = suf
            if matched is not None and in_rv(len(w) - len(matched)):
                w = w[: -len(matched)]
                if matched in _ES_STEP2B_GU and w.endswith("gu"):
                    w = w[:-1]

    # step 3: residual suffix
    matched = None
    for suf in _ES_STEP3_GU + _ES_STEP3:
        if w.endswith(suf) and (matched is None or len(suf) > len(matched)):
            matched = suf
    if matched is not None and in_rv(len(w) - len(matched)):
        w = w[: -len(matched)]
        if matched in _ES_STEP3_GU and w.endswith("gu") and in_rv(len(w) - 1):
            w = w[:-1]

    return w.translate(_ES_DEACCENT)


# --------------------------------------------------------------------------- #
# French (Snowball french stemmer, classic spec)
# --------------------------------------------------------------------------- #

_FR_VOWELS = frozenset("aeiouyâàëéêèïîôûù")

# step 1 groups: (suffixes, action). Suffixes are in MARKED form (iqU etc.:
# the pre-pass uppercases u after q, so surface "ique" arrives as "iqUe").
_FR_STEP1: tuple[tuple[tuple[str, ...], str], ...] = (
    (("ances", "iqUes", "ismes", "ables", "istes", "ance", "iqUe", "isme",
      "able", "iste", "eux"), "del_r2"),
    (("atrices", "ateurs", "ations", "atrice", "ateur", "ation"), "del_r2_ic"),
    (("logies", "logie"), "log"),
    (("usions", "utions", "usion", "ution"), "u"),
    (("ences", "ence"), "ent"),
    (("ements", "ement"), "ement"),
    (("ités", "ité"), "ite"),
    (("ives", "ifs", "ive", "if"), "if"),
    (("eaux",), "eaux"),
    (("aux",), "aux"),
    (("euses", "euse"), "euse"),
    (("issements", "issement"), "issement"),
    (("amment",), "amment"),
    (("emment",), "emment"),
    (("ments", "ment"), "ment"),
)

_FR_MENT_FAMILY = frozenset({"amment", "emment", "ment", "ments"})

_FR_STEP2A = (
    "issaIent", "issantes", "iraIent", "issante", "issants", "issions",
    "irions", "issais", "issait", "issant", "issent", "issiez", "issons",
    "irais", "irait", "irent", "iriez", "irons", "iront", "isses", "issez",
    "îmes", "îtes", "irai", "iras", "irez", "isse", "ies", "ira", "ît",
    "ie", "ir", "is", "it", "i",
)
_FR_STEP2B_IONS = ("ions",)
_FR_STEP2B_E = (
    "eraIent", "erions", "èrent", "erais", "erait", "erez", "eriez", "erons",
    "eront", "erai", "eras", "ées", "era", "iez", "ée", "és", "er", "ez", "é",
)
_FR_STEP2B_A = (
    "assions", "assiez", "assent", "antes", "asses", "aIent", "âtes", "âmes",
    "asse", "ante", "ants", "ais", "ait", "ant", "ât", "as", "ai", "a",
)


def _fr_mark(word: str) -> str:
    """u/i between vowels, y next to a vowel, u after q -> upper case
    (consonant markers), left-to-right over the current string."""
    chars = list(word)
    n = len(chars)
    for i, c in enumerate(chars):
        if c == "u" and i > 0 and chars[i - 1] == "q":
            chars[i] = "U"
        elif c in ("u", "i") and 0 < i < n - 1 and chars[i - 1] in _FR_VOWELS \
                and chars[i + 1] in _FR_VOWELS:
            chars[i] = c.upper()
        elif c == "y" and (
            (i > 0 and chars[i - 1] in _FR_VOWELS)
            or (i < n - 1 and chars[i + 1] in _FR_VOWELS)
        ):
            chars[i] = "Y"
    return "".join(chars)


def _fr_rv(w: str) -> int:
    n = len(w)
    if w[:3] in ("par", "col", "tap"):
        return min(3, n)
    if n >= 2 and w[0] in _FR_VOWELS and w[1] in _FR_VOWELS:
        return min(3, n)
    for i in range(1, n):
        if w[i] in _FR_VOWELS:
            return i + 1
    return n


def _fr_regions(w: str) -> tuple[int, int]:
    n = len(w)

    def next_region(start: int) -> int:
        i = start
        while i < n and w[i] not in _FR_VOWELS:
            i += 1
        while i < n and w[i] in _FR_VOWELS:
            i += 1
        return min(i + 1, n) if i < n else n

    r1 = next_region(0)
    return r1, next_region(r1)


def french_stem(word: str) -> str:  # noqa: C901 - mirrors the published spec
    w = _fr_mark(word)
    rv = _fr_rv(w)
    r1, r2 = _fr_regions(w)

    def in_rv(pos: int) -> bool:
        return pos >= rv

    def in_r1(pos: int) -> bool:
        return pos >= r1

    def in_r2(pos: int) -> bool:
        return pos >= r2

    w0 = w
    # ---- step 1: standard suffix removal (longest match over all groups)
    best: tuple[str, str] | None = None
    for sufs, action in _FR_STEP1:
        for suf in sufs:
            if w.endswith(suf) and (best is None or len(suf) > len(best[0])):
                best = (suf, action)
    ment_family = best is not None and best[0] in _FR_MENT_FAMILY
    if best is not None:
        suf, action = best
        pos = len(w) - len(suf)
        if action == "del_r2":
            if in_r2(pos):
                w = w[:pos]
        elif action == "del_r2_ic":
            if in_r2(pos):
                w = w[:pos]
                if w.endswith("ic"):
                    w = w[:-2] if in_r2(len(w) - 2) else w[:-2] + "iqU"
        elif action == "log":
            if in_r2(pos):
                w = w[:pos] + "log"
        elif action == "u":
            if in_r2(pos):
                w = w[:pos] + "u"
        elif action == "ent":
            if in_r2(pos):
                w = w[:pos] + "ent"
        elif action == "ement":
            if in_rv(pos):
                w = w[:pos]
                if w.endswith("iv") and in_r2(len(w) - 2):
                    w = w[:-2]
                    if w.endswith("at") and in_r2(len(w) - 2):
                        w = w[:-2]
                elif w.endswith("eus"):
                    if in_r2(len(w) - 3):
                        w = w[:-3]
                    elif in_r1(len(w) - 3):
                        w = w[:-3] + "eux"
                elif (w.endswith("abl") or w.endswith("iqU")) and in_r2(len(w) - 3):
                    w = w[:-3]
                elif (w.endswith("ièr") or w.endswith("Ièr")) and in_rv(len(w) - 3):
                    w = w[:-3] + "i"
        elif action == "ite":
            if in_r2(pos):
                w = w[:pos]
                if w.endswith("abil"):
                    w = w[:-4] if in_r2(len(w) - 4) else w[:-4] + "abl"
                elif w.endswith("ic"):
                    w = w[:-2] if in_r2(len(w) - 2) else w[:-2] + "iqU"
                elif w.endswith("iv") and in_r2(len(w) - 2):
                    w = w[:-2]
        elif action == "if":
            if in_r2(pos):
                w = w[:pos]
                if w.endswith("at") and in_r2(len(w) - 2):
                    w = w[:-2]
                    if w.endswith("ic"):
                        w = w[:-2] if in_r2(len(w) - 2) else w[:-2] + "iqU"
        elif action == "eaux":
            w = w[:pos] + "eau"
        elif action == "aux":
            if in_r1(pos):
                w = w[:pos] + "al"
        elif action == "euse":
            if in_r2(pos):
                w = w[:pos]
            elif in_r1(pos):
                w = w[:pos] + "eux"
        elif action == "issement":
            if in_r1(pos) and pos > 0 and w[pos - 1] not in _FR_VOWELS:
                w = w[:pos]
        elif action == "amment":
            if in_rv(pos):
                w = w[:pos] + "ant"
        elif action == "emment":
            if in_rv(pos):
                w = w[:pos] + "ent"
        elif action == "ment":
            if pos > 0 and in_rv(pos - 1) and w[pos - 1] in _FR_VOWELS:
                w = w[:pos]

    changed = w != w0
    # ---- step 2a: verb suffixes beginning i (gated per spec)
    if not changed or ment_family:
        w1 = w
        m2a = None
        for suf in _FR_STEP2A:
            if w.endswith(suf) and (m2a is None or len(suf) > len(m2a)):
                m2a = suf
        if m2a is not None:
            pos = len(w) - len(m2a)
            if in_rv(pos) and pos > 0 and in_rv(pos - 1) and w[pos - 1] not in _FR_VOWELS:
                w = w[:pos]
        # ---- step 2b (only if 2a removed nothing)
        if w == w1:
            m2b: tuple[str, str] | None = None
            for sufs, act in ((_FR_STEP2B_IONS, "ions"), (_FR_STEP2B_E, "e"),
                              (_FR_STEP2B_A, "a")):
                for suf in sufs:
                    if w.endswith(suf) and (m2b is None or len(suf) > len(m2b[0])):
                        m2b = (suf, act)
            if m2b is not None:
                suf, act = m2b
                pos = len(w) - len(suf)
                if act == "ions":
                    if in_rv(pos) and in_r2(pos):
                        w = w[:pos]
                elif act == "e":
                    if in_rv(pos):
                        w = w[:pos]
                elif act == "a":
                    if in_rv(pos):
                        w = w[:pos]
                        if w.endswith("e") and in_rv(len(w) - 1):
                            w = w[:-1]
        changed = w != w0

    if changed:
        # ---- step 3
        if w.endswith("Y"):
            w = w[:-1] + "i"
        elif w.endswith("ç"):
            w = w[:-1] + "c"
    else:
        # ---- step 4: residual suffix
        if w.endswith("s") and len(w) >= 2 and w[-2] not in "aiouès":
            w = w[:-1]
        m4: str | None = None
        for suf in ("ière", "Ière", "ion", "ier", "Ier", "ë", "e"):
            if w.endswith(suf) and (m4 is None or len(suf) > len(m4)):
                m4 = suf
        if m4 is not None:
            pos = len(w) - len(m4)
            if m4 == "ion":
                if in_rv(pos) and in_r2(pos) and pos > 0 and in_rv(pos - 1) \
                        and w[pos - 1] in "st":
                    w = w[:pos]
            elif m4 in ("ière", "Ière", "ier", "Ier"):
                if in_rv(pos):
                    w = w[:pos] + "i"
            elif m4 == "e":
                if in_rv(pos):
                    w = w[:pos]
            elif m4 == "ë":
                if in_rv(pos) and w.endswith("guë"):
                    w = w[:pos]

    # ---- step 5: undouble
    if w.endswith(("enn", "onn", "ett", "ell", "eill")):
        w = w[:-1]
    # ---- step 6: un-accent (é/è followed by >=1 non-vowel at the end)
    i = len(w) - 1
    cnt = 0
    while i >= 0 and w[i] not in _FR_VOWELS:
        i -= 1
        cnt += 1
    if cnt >= 1 and i >= 0 and w[i] in "éè":
        w = w[:i] + "e" + w[i + 1:]

    return w.replace("I", "i").replace("U", "u").replace("Y", "y")


# --------------------------------------------------------------------------- #
# Russian (Snowball russian stemmer)
# --------------------------------------------------------------------------- #

_RU_VOWELS = frozenset("аеиоуыэюя")

# ending groups; "1"-groups require a preceding а/я (which remains). Longest
# match across the category; a failed condition fails the category (Snowball
# `among` semantics — no backtracking to shorter entries).
_RU_PERF_GERUND_1 = ("вшись", "вши", "в")
_RU_PERF_GERUND_2 = ("ившись", "ывшись", "ивши", "ывши", "ив", "ыв")
_RU_ADJECTIVE = (
    "ими", "ыми", "его", "ого", "ему", "ому", "ее", "ие", "ые", "ое", "ей",
    "ий", "ый", "ой", "ем", "им", "ым", "ом", "их", "ых", "ую", "юю", "ая",
    "яя", "ою", "ею",
)
_RU_PARTICIPLE_1 = ("ющ", "нн", "вш", "ем", "щ")
_RU_PARTICIPLE_2 = ("ивш", "ывш", "ующ")
_RU_VERB_1 = (
    "ешь", "нно", "ете", "йте", "ла", "на", "ли", "ем", "ло", "но", "ет",
    "ют", "ны", "ть", "й", "л", "н",
)
_RU_VERB_2 = (
    "ейте", "уйте", "ила", "ыла", "ена", "ите", "или", "ыли", "ило", "ыло",
    "ено", "ует", "уют", "ены", "ить", "ыть", "ишь", "ей", "уй", "ил", "ыл",
    "им", "ым", "ен", "ят", "ит", "ыт", "ую", "ю",
)
_RU_NOUN = (
    "иями", "ями", "ами", "ией", "иям", "ием", "иях", "ев", "ов", "ие", "ье",
    "еи", "ии", "ей", "ой", "ий", "ям", "ем", "ам", "ом", "ах", "ях", "ию",
    "ью", "ия", "ья", "а", "е", "и", "й", "о", "у", "ы", "ь", "ю", "я",
)


def _ru_longest(w: str, sufs: tuple[str, ...], rv: int) -> str | None:
    best = None
    for suf in sufs:
        if w.endswith(suf) and len(w) - len(suf) >= rv and (
            best is None or len(suf) > len(best)
        ):
            best = suf
    return best


def russian_stem(word: str) -> str:
    w = word.replace("ё", "е")  # spec assumption
    n = len(w)
    # RV = after the first vowel; R1/R2 standard
    rv = n
    for i in range(n):
        if w[i] in _RU_VOWELS:
            rv = i + 1
            break

    def next_region(start: int) -> int:
        i = start
        while i < n and w[i] not in _RU_VOWELS:
            i += 1
        while i < n and w[i] in _RU_VOWELS:
            i += 1
        return min(i + 1, n) if i < n else n

    r1 = next_region(0)
    r2 = next_region(r1)
    del r1  # only R2 (derivational) and RV are tested

    def try_group12(word_, g1, g2):
        """Longest across both groups; group-1 needs a preceding а/я in RV.
        Returns the shortened word or None (condition failure != no match:
        both fail the category)."""
        m1 = _ru_longest(word_, g1, rv)
        m2 = _ru_longest(word_, g2, rv)
        if m2 is not None and (m1 is None or len(m2) >= len(m1)):
            return word_[: -len(m2)]
        if m1 is not None:
            pos = len(word_) - len(m1)
            if pos > 0 and pos - 1 >= rv and word_[pos - 1] in "ая":
                return word_[:pos]
            return None  # longest match failed its condition
        return None

    # ---- step 1
    g = try_group12(w, _RU_PERF_GERUND_1, _RU_PERF_GERUND_2)
    if g is not None:
        w = g
    else:
        refl = _ru_longest(w, ("ся", "сь"), rv)
        if refl is not None:
            w = w[: -len(refl)]
        adj = _ru_longest(w, _RU_ADJECTIVE, rv)
        if adj is not None:
            w = w[: -len(adj)]
            part = try_group12(w, _RU_PARTICIPLE_1, _RU_PARTICIPLE_2)
            if part is not None:
                w = part
        else:
            vb = try_group12(w, _RU_VERB_1, _RU_VERB_2)
            if vb is not None:
                w = vb
            else:
                nn = _ru_longest(w, _RU_NOUN, rv)
                if nn is not None:
                    w = w[: -len(nn)]

    # ---- step 2: final и
    if w.endswith("и") and len(w) - 1 >= rv:
        w = w[:-1]
    # ---- step 3: derivational (in R2)
    der = None
    for suf in ("ость", "ост"):
        if w.endswith(suf) and len(w) - len(suf) >= r2:
            der = suf
            break
    if der is not None:
        w = w[: -len(der)]
    # ---- step 4: tidy up (нн matches entirely inside RV)
    if w.endswith("нн") and len(w) - 2 >= rv:
        w = w[:-1]
    else:
        sup = _ru_longest(w, ("ейше", "ейш"), rv)
        if sup is not None:
            w = w[: -len(sup)]
            if w.endswith("нн") and len(w) - 2 >= rv:
                w = w[:-1]
        elif w.endswith("ь") and len(w) - 1 >= rv:
            w = w[:-1]
    return w


# --------------------------------------------------------------------------- #
# Italian (Snowball italian stemmer)
# --------------------------------------------------------------------------- #

_IT_VOWELS = frozenset("aeiouàèìòù")
_IT_ACUTE = str.maketrans("áéíóú", "àèìòù")

_IT_PRON = (
    "gliela", "gliele", "glieli", "glielo", "gliene", "sene",
    "mela", "mele", "meli", "melo", "mene", "tela", "tele", "teli", "telo",
    "tene", "cela", "cele", "celi", "celo", "cene", "vela", "vele", "veli",
    "velo", "vene", "gli", "ci", "la", "le", "li", "lo", "mi", "ne", "si",
    "ti", "vi",
)
_IT_STEP1: tuple[tuple[tuple[str, ...], str], ...] = (
    (("atrice", "atrici", "anza", "anze", "iche", "ichi", "ismo", "ismi",
      "abile", "abili", "ibile", "ibili", "ista", "iste", "isti", "istà",
      "istè", "istì", "mente", "ante", "anti", "oso", "osi", "osa", "ose",
      "ico", "ici", "ica", "ice"), "del_r2"),
    (("azione", "azioni", "atore", "atori"), "del_r2_ic"),
    (("logia", "logie"), "log"),
    (("uzione", "uzioni", "usione", "usioni"), "u"),
    (("enza", "enze"), "ente"),
    (("amento", "amenti", "imento", "imenti"), "del_rv"),
    (("amente",), "amente"),
    (("ità",), "ita"),
    (("ivo", "ivi", "iva", "ive"), "iv"),
)
_IT_STEP2 = (
    "erebbero", "irebbero", "assero", "assimo", "eranno", "erebbe", "eremmo",
    "ereste", "eresti", "essero", "iranno", "irebbe", "iremmo", "ireste",
    "iresti", "iscano", "iscono", "issero", "arono", "avamo", "avano",
    "avate", "eremo", "erete", "erono", "evamo", "evano", "evate", "iremo",
    "irete", "irono", "ivamo", "ivano", "ivate", "ammo", "ando", "asse",
    "assi", "emmo", "enda", "ende", "endi", "endo", "erai", "erei", "Yamo",
    "iamo", "immo", "irai", "irei", "isca", "isce", "isci", "isco", "ano",
    "are", "ata", "ate", "ati", "ato", "ava", "avi", "avo", "erà", "ere",
    "erò", "ete", "eva", "evi", "evo", "irà", "ire", "irò", "ita", "ite",
    "iti", "ito", "iva", "ivi", "ivo", "ono", "uta", "ute", "uti", "uto",
    "ar", "ir",
)


def _it_mark(word: str) -> str:
    chars = list(word)
    n = len(chars)
    for i, c in enumerate(chars):
        if c == "u" and i > 0 and chars[i - 1] == "q":
            chars[i] = "U"
        elif c in ("u", "i") and 0 < i < n - 1 and chars[i - 1] in _IT_VOWELS \
                and chars[i + 1] in _IT_VOWELS:
            chars[i] = c.upper()
    return "".join(chars)


def _it_rv(w: str) -> int:
    n = len(w)
    if n < 3:
        return n
    if w[1] not in _IT_VOWELS:  # X C ... : after the next vowel
        i = 2
        while i < n and w[i] not in _IT_VOWELS:
            i += 1
        return min(i + 1, n)
    if w[0] in _IT_VOWELS and w[1] in _IT_VOWELS:  # V V ... : after next consonant
        i = 2
        while i < n and w[i] in _IT_VOWELS:
            i += 1
        return min(i + 1, n)
    return 3  # C V ...


def _it_regions(w: str) -> tuple[int, int]:
    n = len(w)

    def next_region(start: int) -> int:
        i = start
        while i < n and w[i] not in _IT_VOWELS:
            i += 1
        while i < n and w[i] in _IT_VOWELS:
            i += 1
        return min(i + 1, n) if i < n else n

    r1 = next_region(0)
    return r1, next_region(r1)


def italian_stem(word: str) -> str:  # noqa: C901 - mirrors the published spec
    w = _it_mark(word.translate(_IT_ACUTE))
    rv = _it_rv(w)
    r1, r2 = _it_regions(w)

    def in_rv(pos: int) -> bool:
        return pos >= rv

    def in_r1(pos: int) -> bool:
        return pos >= r1

    def in_r2(pos: int) -> bool:
        return pos >= r2

    # ---- step 0: attached pronoun (longest pronoun, then the a/b test)
    best_p = None
    for pron in _IT_PRON:
        if w.endswith(pron) and (best_p is None or len(pron) > len(best_p)):
            best_p = pron
    if best_p is not None:
        base = w[: -len(best_p)]
        if base.endswith(("ando", "endo")) and in_rv(len(base) - 4):
            w = base
        elif base.endswith(("ar", "er", "ir")) and in_rv(len(base) - 2):
            w = base + "e"

    n0 = len(w)
    # ---- step 1: standard suffixes (longest match over all groups)
    best: tuple[str, str] | None = None
    for sufs, action in _IT_STEP1:
        for suf in sufs:
            if w.endswith(suf) and (best is None or len(suf) > len(best[0])):
                best = (suf, action)
    if best is not None:
        suf, action = best
        pos = len(w) - len(suf)
        if action == "del_r2":
            if in_r2(pos):
                w = w[:pos]
        elif action == "del_r2_ic":
            if in_r2(pos):
                w = w[:pos]
                if w.endswith("ic") and in_r2(len(w) - 2):
                    w = w[:-2]
        elif action == "log":
            if in_r2(pos):
                w = w[:pos] + "log"
        elif action == "u":
            if in_r2(pos):
                w = w[:pos] + "u"
        elif action == "ente":
            if in_r2(pos):
                w = w[:pos] + "ente"
        elif action == "del_rv":
            if in_rv(pos):
                w = w[:pos]
        elif action == "amente":
            if in_r1(pos):
                w = w[:pos]
                if w.endswith("iv") and in_r2(len(w) - 2):
                    w = w[:-2]
                    if w.endswith("at") and in_r2(len(w) - 2):
                        w = w[:-2]
                elif w.endswith("abil") and in_r2(len(w) - 4):
                    w = w[:-4]
                elif (w.endswith("os") or w.endswith("ic")) and in_r2(len(w) - 2):
                    w = w[:-2]
        elif action == "ita":
            if in_r2(pos):
                w = w[:pos]
                if w.endswith("abil") and in_r2(len(w) - 4):
                    w = w[:-4]
                elif (w.endswith("ic") or w.endswith("iv")) and in_r2(len(w) - 2):
                    w = w[:-2]
        elif action == "iv":
            if in_r2(pos):
                w = w[:pos]
                if w.endswith("at") and in_r2(len(w) - 2):
                    w = w[:-2]
                    if w.endswith("ic") and in_r2(len(w) - 2):
                        w = w[:-2]

    # ---- step 2: verb suffixes (only if step 1 removed nothing)
    if len(w) == n0:
        m2 = None
        for suf in _IT_STEP2:
            if w.endswith(suf) and (m2 is None or len(suf) > len(m2)):
                m2 = suf
        if m2 is not None and in_rv(len(w) - len(m2)):
            w = w[: -len(m2)]

    # ---- step 3a: final vowel (+ a preceding i), in RV
    if w and w[-1] in "aeioàèìò" and in_rv(len(w) - 1):
        w = w[:-1]
        if w.endswith("i") and in_rv(len(w) - 1):
            w = w[:-1]
    # ---- step 3b: ch/gh -> c/g in RV
    if (w.endswith("ch") or w.endswith("gh")) and in_rv(len(w) - 2):
        w = w[:-1]

    return w.replace("I", "i").replace("U", "u")


# --------------------------------------------------------------------------- #
# Dutch (Snowball dutch stemmer)
# --------------------------------------------------------------------------- #

_NL_VOWELS = frozenset("aeiouyè")
_NL_UMLAUT = str.maketrans("äëïöüáéíóú", "aeiouaeiou")


def _nl_mark(word: str) -> str:
    """Initial y, y after a vowel, and i between vowels -> upper case."""
    chars = list(word)
    n = len(chars)
    for i, c in enumerate(chars):
        if c == "y" and (i == 0 or chars[i - 1] in _NL_VOWELS):
            chars[i] = "Y"
        elif c == "i" and 0 < i < n - 1 and chars[i - 1] in _NL_VOWELS \
                and chars[i + 1] in _NL_VOWELS:
            chars[i] = "I"
    return "".join(chars)


def _nl_regions(w: str) -> tuple[int, int]:
    n = len(w)

    def next_region(start: int) -> int:
        i = start
        while i < n and w[i] not in _NL_VOWELS:
            i += 1
        while i < n and w[i] in _NL_VOWELS:
            i += 1
        return min(i + 1, n) if i < n else n

    r1 = next_region(0)
    r2 = next_region(r1)
    if r1 < 3:  # region before R1 must hold at least 3 letters (as in German)
        r1 = min(3, n)
    return r1, r2


def _nl_undouble(w: str) -> str:
    if w.endswith(("kk", "dd", "tt")):
        return w[:-1]
    return w


def dutch_stem(word: str) -> str:
    w = _nl_mark(word.translate(_NL_UMLAUT))
    r1, r2 = _nl_regions(w)

    def in_r1(pos: int) -> bool:
        return pos >= r1

    def in_r2(pos: int) -> bool:
        return pos >= r2

    def del_en(w: str) -> tuple[str, bool]:
        """Delete en/ene if in R1, preceded by a valid en-ending (a non-vowel,
        and not gem); undouble the ending."""
        for suf in ("ene", "en"):
            if w.endswith(suf):
                pos = len(w) - len(suf)
                if in_r1(pos) and pos > 0 and w[pos - 1] not in _NL_VOWELS \
                        and w[max(0, pos - 3):pos] != "gem":
                    return _nl_undouble(w[:pos]), True
                return w, False
        return w, False

    # ---- step 1
    if w.endswith("heden"):
        if in_r1(len(w) - 5):
            w = w[:-5] + "heid"
    else:
        w2, done = del_en(w)
        if done:
            w = w2
        elif w.endswith(("se", "s")):
            suf = "se" if w.endswith("se") else "s"
            pos = len(w) - len(suf)
            if in_r1(pos) and pos > 0 and w[pos - 1] not in _NL_VOWELS \
                    and w[pos - 1] != "j":
                w = w[:pos]

    # ---- step 2: delete suffix e if in R1 and preceded by a non-vowel
    e_removed = False
    if w.endswith("e") and in_r1(len(w) - 1) and len(w) >= 2 \
            and w[-2] not in _NL_VOWELS:
        w = _nl_undouble(w[:-1])
        e_removed = True

    # ---- step 3a: heid
    if w.endswith("heid") and in_r2(len(w) - 4) and (len(w) < 5 or w[-5] != "c"):
        w = w[:-4]
        w, _ = del_en(w)

    # ---- step 3b: d-suffixes
    m = None
    for suf in ("lijk", "baar", "end", "ing", "bar", "ig"):
        if w.endswith(suf) and (m is None or len(suf) > len(m)):
            m = suf
    if m is not None:
        pos = len(w) - len(m)
        if m in ("end", "ing"):
            if in_r2(pos):
                w = w[:pos]
                if w.endswith("ig") and in_r2(len(w) - 2) and \
                        (len(w) < 3 or w[-3] != "e"):
                    w = w[:-2]
                else:
                    w = _nl_undouble(w)
        elif m == "ig":
            if in_r2(pos) and (pos == 0 or w[pos - 1] != "e"):
                w = w[:pos]
        elif m == "lijk":
            if in_r2(pos):
                w = w[:pos]
                # repeat step 2
                if w.endswith("e") and in_r1(len(w) - 1) and len(w) >= 2 \
                        and w[-2] not in _NL_VOWELS:
                    w = _nl_undouble(w[:-1])
        elif m == "baar":
            if in_r2(pos):
                w = w[:pos]
        elif m == "bar":
            if in_r2(pos) and e_removed:
                w = w[:pos]

    # ---- step 4: undouble vowel (C V V D, D a non-vowel other than I)
    if len(w) >= 4:
        c, v1, v2, d = w[-4], w[-3], w[-2], w[-1]
        if (c not in _NL_VOWELS and v1 == v2 and v1 in "aeou"
                and d not in _NL_VOWELS and d != "I"):
            w = w[:-2] + w[-1]

    return w.replace("I", "i").replace("Y", "y")


# --------------------------------------------------------------------------- #
# Portuguese (Snowball portuguese stemmer)
# --------------------------------------------------------------------------- #

_PT_VOWELS = frozenset("aeiouáéíóúâêô")
_PT_DEACCENT = str.maketrans("áéíóúâêô", "aeiouaeo")

# step 1 standard suffixes: (suffixes, action). ã/õ are kept as-is (single
# codepoints — no a~/o~ re-encoding needed at the python level).
_PT_STEP1: tuple[tuple[tuple[str, ...], str], ...] = (
    (("amentos", "imentos", "amento", "imento", "adoras", "adores", "ações",
      "ância", "antes", "adora", "ação", "ador", "ante", "ezas", "icos",
      "icas", "ismos", "ável", "ível", "istas", "osos", "osas", "eza", "ico",
      "ica", "ismo", "ista", "oso", "osa"), "del_r2"),
    (("logias", "logia"), "log"),
    (("uções", "ução"), "u"),
    (("ências", "ência"), "ente"),
    (("amente",), "amente"),
    (("mente",), "mente"),
    (("idades", "idade"), "idade"),
    (("ivas", "ivos", "iva", "ivo"), "iv"),
    (("iras", "ira"), "eira"),
)

# step 2 verb suffixes: the full regular -ar/-er/-ir paradigm (present,
# imperfect, preterite, pluperfect, future, conditional, subjunctives,
# personal infinitive, participles, gerund), longest match, delete if in RV.
_PT_STEP2 = tuple(sorted({
    # participles / gerund
    "ado", "ada", "ados", "adas", "ido", "ida", "idos", "idas",
    "ando", "endo", "indo",
    # present indicative (-o is handled by step 5's residuals)
    "amos", "ais", "am", "es", "emos", "eis", "em", "imos", "is", "as", "e",
    # imperfect
    "ava", "avas", "ávamos", "áveis", "avam", "ia", "ias", "íamos", "íeis",
    "iam",
    # preterite
    "ei", "aste", "ou", "astes", "aram", "este", "eu", "estes", "eram",
    "iste", "iu", "istes", "iram",
    # pluperfect
    "ara", "aras", "áramos", "áreis", "era", "eras", "éramos", "éreis",
    "ira", "iras", "íramos", "íreis",
    # future
    "arei", "arás", "ará", "aremos", "areis", "arão",
    "erei", "erás", "erá", "eremos", "ereis", "erão",
    "irei", "irás", "irá", "iremos", "ireis", "irão",
    # conditional
    "aria", "arias", "aríamos", "aríeis", "ariam",
    "eria", "erias", "eríamos", "eríeis", "eriam",
    "iria", "irias", "iríamos", "iríeis", "iriam",
    # imperfect subjunctive
    "asse", "asses", "ássemos", "ásseis", "assem",
    "esse", "esses", "êssemos", "ésseis", "essem",
    "isse", "isses", "íssemos", "ísseis", "issem",
    # future subjunctive / personal infinitive
    "ar", "ares", "armos", "ardes", "arem",
    "er", "eres", "ermos", "erdes", "erem",
    "ir", "ires", "irmos", "irdes", "irem",
} - {"e"}, key=len, reverse=True))
# NOTE: bare "e"/"o"/"a" singles are step-5/4 residuals, not verb endings.


def _pt_rv(w: str) -> int:
    n = len(w)
    if n < 3:
        return n
    if w[1] not in _PT_VOWELS:
        i = 2
        while i < n and w[i] not in _PT_VOWELS:
            i += 1
        return min(i + 1, n)
    if w[0] in _PT_VOWELS and w[1] in _PT_VOWELS:
        i = 2
        while i < n and w[i] in _PT_VOWELS:
            i += 1
        return min(i + 1, n)
    return 3


def _pt_regions(w: str) -> tuple[int, int]:
    n = len(w)

    def next_region(start: int) -> int:
        i = start
        while i < n and w[i] not in _PT_VOWELS:
            i += 1
        while i < n and w[i] in _PT_VOWELS:
            i += 1
        return min(i + 1, n) if i < n else n

    r1 = next_region(0)
    return r1, next_region(r1)


def portuguese_stem(word: str) -> str:  # noqa: C901 - mirrors the published spec
    w = word
    rv = _pt_rv(w)
    r1, r2 = _pt_regions(w)

    def in_rv(pos: int) -> bool:
        return pos >= rv

    def in_r1(pos: int) -> bool:
        return pos >= r1

    def in_r2(pos: int) -> bool:
        return pos >= r2

    n0 = len(w)
    # ---- step 1: standard suffix removal (longest match over all groups)
    best: tuple[str, str] | None = None
    for sufs, action in _PT_STEP1:
        for suf in sufs:
            if w.endswith(suf) and (best is None or len(suf) > len(best[0])):
                best = (suf, action)
    if best is not None:
        suf, action = best
        pos = len(w) - len(suf)
        if action == "del_r2":
            if in_r2(pos):
                w = w[:pos]
        elif action == "log":
            if in_r2(pos):
                w = w[:pos] + "log"
        elif action == "u":
            if in_r2(pos):
                w = w[:pos] + "u"
        elif action == "ente":
            if in_r2(pos):
                w = w[:pos] + "ente"
        elif action == "amente":
            if in_r1(pos):
                w = w[:pos]
                if w.endswith("iv") and in_r2(len(w) - 2):
                    w = w[:-2]
                    if w.endswith("at") and in_r2(len(w) - 2):
                        w = w[:-2]
                elif (w.endswith("os") or w.endswith("ic") or w.endswith("ad")) \
                        and in_r2(len(w) - 2):
                    w = w[:-2]
        elif action == "mente":
            if in_r2(pos):
                w = w[:pos]
                for pre in ("ante", "avel", "ível"):
                    if w.endswith(pre) and in_r2(len(w) - 4):
                        w = w[:-4]
                        break
        elif action == "idade":
            if in_r2(pos):
                w = w[:pos]
                if w.endswith("abil") and in_r2(len(w) - 4):
                    w = w[:-4]
                elif (w.endswith("ic") or w.endswith("iv")) and in_r2(len(w) - 2):
                    w = w[:-2]
        elif action == "iv":
            if in_r2(pos):
                w = w[:pos]
                if w.endswith("at") and in_r2(len(w) - 2):
                    w = w[:-2]
        elif action == "eira":
            # ira/iras -> ir if in RV and preceded by e ("bandeira")
            if in_rv(pos) and pos > 0 and w[pos - 1] == "e":
                w = w[:pos] + "ir"

    # ---- step 2: verb suffixes (only if step 1 removed nothing)
    step2_done = False
    if len(w) == n0:
        m2 = None
        for suf in _PT_STEP2:
            if w.endswith(suf):
                m2 = suf
                break  # list is sorted longest-first
        if m2 is not None and in_rv(len(w) - len(m2)):
            w = w[: -len(m2)]
            step2_done = True

    # ---- step 3: delete i if in RV and preceded by c (only if 1 or 2 changed)
    if len(w) != n0 or step2_done:
        if w.endswith("i") and in_rv(len(w) - 1) and len(w) >= 2 and w[-2] == "c":
            w = w[:-1]
    else:
        # ---- step 4: residual suffix (only if steps 1 and 2 changed nothing)
        m4 = None
        for suf in ("os", "a", "i", "o", "á", "í", "ó"):
            if w.endswith(suf) and (m4 is None or len(suf) > len(m4)):
                m4 = suf
        if m4 is not None and in_rv(len(w) - len(m4)):
            w = w[: -len(m4)]

    # ---- step 5: final e/é/ê in RV; gu/ci u/i removal; ç -> c
    if w and w[-1] in "eéê" and in_rv(len(w) - 1):
        w = w[:-1]
        if w.endswith("gu") and in_rv(len(w) - 1):
            w = w[:-1]
        elif w.endswith("ci") and in_rv(len(w) - 1):
            w = w[:-1]
    elif w.endswith("ç"):
        w = w[:-1] + "c"

    return w.translate(_PT_DEACCENT)


# --------------------------------------------------------------------------- #
# Swedish / Norwegian / Danish (Snowball Scandinavian stemmers)
# --------------------------------------------------------------------------- #

def _scan_r1(w: str, vowels: frozenset) -> int:
    """R1 with the Scandinavian min-3 adjustment."""
    n = len(w)
    i = 0
    while i < n and w[i] not in vowels:
        i += 1
    while i < n and w[i] in vowels:
        i += 1
    r1 = min(i + 1, n) if i < n else n
    return min(3, n) if r1 < 3 else r1


_SV_VOWELS = frozenset("aeiouyäåö")
_SV_STEP1 = tuple(sorted((
    "a", "arna", "erna", "heterna", "orna", "ad", "e", "ade", "ande", "arne",
    "are", "aste", "en", "anden", "aren", "heten", "ern", "ar", "er", "heter",
    "or", "as", "arnas", "ernas", "ornas", "es", "ades", "andes", "ens",
    "arens", "hetens", "erns", "at", "andet", "het", "ast",
), key=len, reverse=True))
_SV_S_END = frozenset("bcdfghjklmnoprtvy")


def swedish_stem(word: str) -> str:
    w = word
    r1 = _scan_r1(w, _SV_VOWELS)

    # step 1: ONE among over the a-list + the s-rule (longest match wins; a
    # failed condition removes nothing — no fallback to shorter entries)
    m = next((suf for suf in _SV_STEP1 if w.endswith(suf)), None)
    if m is not None:
        if len(w) - len(m) >= r1:
            w = w[: -len(m)]
    elif w.endswith("s") and len(w) - 1 >= r1 and len(w) >= 2 and w[-2] in _SV_S_END:
        w = w[:-1]

    # step 2: dd gd nn dt gt kt tt (the pair in R1) -> remove last letter
    if w[-2:] in ("dd", "gd", "nn", "dt", "gt", "kt", "tt") and len(w) - 2 >= r1:
        w = w[:-1]

    # step 3 (in R1): lig ig els delete; löst -> lös; fullt -> full
    for suf in ("lig", "els", "ig"):
        if w.endswith(suf) and len(w) - len(suf) >= r1:
            w = w[: -len(suf)]
            break
    else:
        if w.endswith("löst") and len(w) - 4 >= r1:
            w = w[:-1]
        elif w.endswith("fullt") and len(w) - 5 >= r1:
            w = w[:-1]
    return w


_NO_VOWELS = frozenset("aeiouyæåø")
_NO_STEP1 = tuple(sorted((
    "a", "e", "ede", "ande", "ende", "ane", "ene", "hetene", "en", "heten",
    "ar", "er", "heter", "as", "es", "edes", "endes", "enes", "hetenes",
    "ens", "hetens", "ers", "ets", "et", "het", "ast",
), key=len, reverse=True))
_NO_S_END = frozenset("bcdfghjlmnoprtvyz")


def norwegian_stem(word: str) -> str:
    w = word
    r1 = _scan_r1(w, _NO_VOWELS)

    # step 1: ONE among over {a-list, erte/ert -> er, s-rule}; longest wins
    cands: list[tuple[str, str]] = []
    m = next((suf for suf in _NO_STEP1 if w.endswith(suf)), None)
    if m is not None:
        cands.append((m, "del"))
    for suf in ("erte", "ert"):
        if w.endswith(suf):
            cands.append((suf, "er"))
            break
    if w.endswith("s"):
        cands.append(("s", "s"))
    if cands:
        suf, act = max(cands, key=lambda c: len(c[0]))
        pos = len(w) - len(suf)
        if act == "del":
            if pos >= r1:
                w = w[:pos]
        elif act == "er":
            if pos >= r1:
                w = w[:pos] + "er"
        elif pos >= r1 and len(w) >= 2 and (
            w[-2] in _NO_S_END
            or (w[-2] == "k" and (len(w) < 3 or w[-3] not in _NO_VOWELS))
        ):
            w = w[:-1]

    # step 2: dt vt (the pair in R1) -> remove t
    if w[-2:] in ("dt", "vt") and len(w) - 2 >= r1:
        w = w[:-1]

    # step 3 (in R1): longest among, delete
    for suf in ("hetslov", "slov", "elov", "elig", "eleg", "lov", "lig",
                "eig", "leg", "els", "ig"):
        if w.endswith(suf) and len(w) - len(suf) >= r1:
            w = w[: -len(suf)]
            break
    return w


_DA_VOWELS = frozenset("aeiouyæåø")
_DA_STEP1 = tuple(sorted((
    "hed", "ethed", "ered", "e", "erede", "ende", "erende", "ene", "erne",
    "ere", "en", "heden", "eren", "er", "heder", "erer", "heds", "es",
    "endes", "erendes", "enes", "ernes", "eres", "ens", "hedens", "erens",
    "ers", "ets", "erets", "et", "eret",
), key=len, reverse=True))
_DA_S_END = frozenset("abcdfghjklmnoprtvyzå")


def danish_stem(word: str) -> str:
    w = word
    r1 = _scan_r1(w, _DA_VOWELS)

    def step2(w: str) -> str:
        if w[-2:] in ("gd", "dt", "gt", "kt") and len(w) - 2 >= r1:
            return w[:-1]
        return w

    # step 1: ONE among (a-list or the s-rule); longest wins, no fallback
    m = next((suf for suf in _DA_STEP1 if w.endswith(suf)), None)
    if m is not None:
        if len(w) - len(m) >= r1:
            w = w[: -len(m)]
    elif w.endswith("s") and len(w) - 1 >= r1 and len(w) >= 2 and w[-2] in _DA_S_END:
        w = w[:-1]

    # step 2
    w = step2(w)

    # step 3: igst -> remove st; then ig/lig/elig/els delete (+ repeat step2);
    # løst -> løs
    if w.endswith("igst") and len(w) - 2 >= r1:
        w = w[:-2]
    m3 = next((suf for suf in ("elig", "lig", "els", "ig") if w.endswith(suf)), None)
    if m3 is not None and len(w) - len(m3) >= r1:
        w = w[: -len(m3)]
        w = step2(w)
    elif w.endswith("løst") and len(w) - 4 >= r1:
        w = w[:-1]

    # step 4: undouble a final double consonant (last letter in R1)
    if len(w) >= 2 and w[-1] == w[-2] and w[-1] not in _DA_VOWELS \
            and len(w) - 1 >= r1:
        w = w[:-1]
    return w
