"""sentencepiece's precompiled character map (`Precompiled` in a
`tokenizer.json`: the normalizer of XLM-R, CamemBERT and T5), read and
applied as the `tokenizers` library does, without it.

The blob (base64 in the file's `precompiled_charsmap`) is a little-endian
u32 trie size in bytes, then that many bytes of darts-clone double-array
units (u32 each), then the normalized strings, each ended by a NUL. A unit
holds a label (its low 8 bits and bit 31), a has-leaf flag (bit 8) and an
offset (bits 10-31, shifted left by 8 more when bit 9 is set); a leaf
unit's value (its low 31 bits) is the byte offset of a normalized string.

Normalizing (`tokenizers`' `Precompiled::normalize`): per extended
grapheme cluster (`data/graphemes.py`), a cluster of fewer than 6 UTF-8
bytes is looked up whole; else, or when that finds nothing, each character
is looked up alone and kept as it is when nothing matches. A lookup takes
the first (the shortest) key of the trie that is a prefix of the bytes, and
replaces the whole looked-up text by that key's string, as `tokenizers`
does. Each output character keeps the original offsets the library gives
it (`_changes`).
"""

from __future__ import annotations

import base64
import struct
import typing as typ

from .graphemes import graphemes

Piece = tuple[str, list[tuple[int, int]]]  # text, each character's original (start, end)

_MAX_CLUSTER_BYTES = 6  # a cluster of fewer UTF-8 bytes is looked up whole


class CharsMap:
    """A parsed precompiled charsmap: the double array and the normalized strings."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError(f"a precompiled charsmap of {len(blob)} bytes is shorter than its 4-byte header")
        (trie_bytes,) = struct.unpack_from("<I", blob, 0)
        if trie_bytes % 4 or 4 + trie_bytes > len(blob):
            raise ValueError(f"a precompiled charsmap of {len(blob)} bytes cannot hold its {trie_bytes}-byte trie")
        self.units = struct.unpack_from(f"<{trie_bytes // 4}I", blob, 4)
        self.normalized = blob[4 + trie_bytes :]
        self._cache: dict[str, typ.Optional[str]] = {}

    @classmethod
    def from_base64(cls, text: str) -> "CharsMap":
        return cls(base64.b64decode(text))

    def prefix_values(self, key: bytes) -> list[int]:
        """The values of every trie key that is a prefix of `key`, shortest
        first (darts-clone's common prefix search; a NUL byte ends the key)."""
        units, n = self.units, len(self.units)
        if not n:
            return []
        out: list[int] = []
        pos = _offset(units[0])
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= n:
                return out
            unit = units[pos]
            if unit & 0x800000FF != c:
                return out
            pos ^= _offset(unit)
            if (unit >> 8) & 1:
                if pos >= n:
                    return out
                out.append(units[pos] & 0x7FFFFFFF)
        return out

    def transform(self, text: str) -> typ.Optional[str]:
        """The normalized string of the shortest key that prefixes `text`'s
        UTF-8 bytes, or None."""
        hit = self._cache.get(text, False)
        if hit is not False:
            return hit
        values = self.prefix_values(text.encode("utf-8"))
        out = None
        if values:
            start = values[0]
            end = self.normalized.find(b"\0", start)
            out = self.normalized[start : end if end >= 0 else len(self.normalized)].decode("utf-8")
        self._cache[text] = out
        return out

    def normalize_str(self, text: str) -> str:
        return self.normalize((text, [(i, i + 1) for i in range(len(text))]))[0]

    def normalize(self, piece: Piece) -> Piece:
        """The piece normalized, each output character with the original
        (start, end) `tokenizers` gives it."""
        text, align = piece
        changes: list[tuple[str, int]] = []
        modified = False
        for cluster in graphemes(text):
            if len(cluster.encode("utf-8")) < _MAX_CLUSTER_BYTES:
                norm = self.transform(cluster)
                if norm is not None:
                    modified = True
                    _replace(changes, cluster, norm)
                    continue
            for c in cluster:
                norm = self.transform(c)
                if norm is not None:
                    modified = True
                    _replace(changes, c, norm)
                else:
                    changes.append((c, 0))
        if not modified:
            return piece
        return apply_changes(align, changes)


def _offset(unit: int) -> int:
    return (unit >> 10) << ((unit & (1 << 9)) >> 6)


def _replace(changes: list[tuple[str, int]], old: str, new: str) -> None:
    """`tokenizers`' `replace`: `new`'s characters replace `old`'s; the last
    `diff` added characters are inserted (+1), or the last one removes the
    surplus (-n), when the lengths differ."""
    diff = len(new) - len(old)
    changes.extend((c, 0) for c in new)
    if diff > 0:
        for i in range(len(changes) - diff, len(changes)):
            changes[i] = (changes[i][0], 1)
    elif diff < 0 and changes:
        c, ch = changes[-1]
        changes[-1] = (c, ch + diff)


def apply_changes(align: list[tuple[int, int]], changes: list[tuple[str, int]]) -> Piece:
    """`NormalizedString::transform` from the start: each (character,
    change) of the new text, 0 replacing the next input character, +1
    inserted (aligned to the last input character consumed), -n also
    removing the n input characters after the one it replaces."""
    aligns, pos = [], 0
    for _, change in changes:
        if change > 0:
            aligns.append(align[pos - 1] if pos else (0, 0))
        else:
            aligns.append(align[pos])
            pos += 1 - change
    return "".join(c for c, _ in changes), aligns


def build_charsmap(rules: typ.Mapping[str, str]) -> bytes:
    """A sentencepiece precompiled charsmap (the blob of a `Precompiled`
    normalizer) mapping each key of `rules` to its value: a little-endian
    u32 trie size, a darts-clone double array over the keys' UTF-8 bytes
    (each leaf's value the byte offset of its string), then the strings,
    each ended by a NUL. The writer is simple: each node takes the
    lowest base that puts its first label on a free slot and finds its
    other slots free, offsets stay below 2^21, and the array is padded so
    that every reachable slot lies inside it."""
    normalized, offsets = bytearray(), {}
    for key in sorted(rules):
        offsets[key] = len(normalized)
        normalized += rules[key].encode("utf-8") + b"\0"
    # the trie: node -> {byte: child}, values at the node a key ends in
    children: list[dict[int, int]] = [{}]
    value: dict[int, int] = {}
    for key, off in offsets.items():
        node = 0
        for b in key.encode("utf-8"):
            if b not in children[node]:
                children.append({})
                children[node][b] = len(children) - 1
            node = children[node][b]
        value[node] = off
    units: dict[int, int] = {}
    used = {0}
    pos_of = {0: 0}
    order = [0]
    first_free = 1
    for node in order:
        labels = sorted(children[node]) + ([0] if node in value else [])
        if not labels:
            continue
        # candidate bases put the first label on a free slot, lowest first
        while first_free in used:
            first_free += 1
        q = first_free
        while True:
            base = q ^ labels[0]
            if base and all((base ^ lab) not in used for lab in labels) and (base ^ pos_of[node]) < 1 << 21:
                break
            q += 1
            while q in used:
                q += 1
        p = pos_of[node]
        units[p] = units.get(p, 0) | ((p ^ base) << 10)
        used.update(base ^ lab for lab in labels)
        if node in value:
            units[p] |= 1 << 8
            units[base] = value[node] | (1 << 31)
        for b, child in sorted(children[node].items()):
            pos_of[child] = base ^ b
            units[base ^ b] = b
            order.append(child)
    size = (max(max(units), max(b | 255 for b in [0] + [pos_of[n] ^ (units[pos_of[n]] >> 10)
                                                          for n in pos_of if units[pos_of[n]] >> 10])) // 256 + 1) * 256
    array = [units.get(i, 0) for i in range(size)]
    trie = struct.pack(f"<{size}I", *array)
    return struct.pack("<I", len(trie)) + trie + bytes(normalized)
