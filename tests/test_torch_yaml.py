"""The port's YAML reader (`vod_tpu_torch/utils/yaml.py`) against
`yaml.safe_load`: equal values (exact, `==`) on every file under `configs/`
and on YAML 1.1 edge cases; constructs it does not support raise
`ValueError` naming their line."""

import math
from pathlib import Path

import pytest
import yaml as pyyaml

from vod_tpu_torch.utils import yaml

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").rglob("*.yaml"))


def test_every_config_file_is_read() -> None:
    assert len(CONFIGS) == 56


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: str(p.relative_to(ROOT / "configs")))
def test_config_file_equals_safe_load(path: Path) -> None:
    text = path.read_text()
    assert yaml.safe_load(text) == pyyaml.safe_load(text)


EDGE_CASES = {
    "floats_need_a_dot": "a: 1e-4\nb: 5.0e-5\nc: 1.0e3\nd: 12e3\ne: .5\nf: -.inf\ng: +1.5e+3\nh: 1.e5\n",
    "ints": "a: 0x1F\nb: 017\nc: 1_000\nd: 1:30\ne: 0b101\nf: -0\ng: +7\nh: 190:20:30.15\n",
    "booleans": "a: yes\nb: No\nc: ON\nd: off\ne: True\nf: FALSE\ng: y\nh: n\n",
    "nulls": "a: ~\nb: null\nc: Null\nd:\ne: NULL\n",
    "quoted": "a: '1.0'\nb: \"1.0\"\nc: 'it''s'\nd: \"tab\\there \\u00e9 \\x41\"\ne: 'yes'\n",
    "nested_flow": "a: {x: [1, 2, {y: no}], z: null}\nb: [a, 'b c', \"d\", [e, {f: g}]]\nc: {}\nd: []\n",
    "flow_across_lines": "a: [1,\n  2,\n  3]\nb: {c: d,\n  e: f}\n",
    "comments": "# head\na: 1 # trailing\nb: 'x # not a comment'\nc: a#b\nd: [1, 2]  # after flow\n",
    "block_sequences": "k:\n- a\n- b: 1\n  c: 2\n- - x\n  - y\n-\n  d: 3\nm:\n  - {identifier: q, subsets: [s]}\n",
    "plain_with_colons": "url: http://x.y/z\nt: a:b\nneg: -x\nq: ?x\n",
    "keys_resolve": "1: one\nyes: two\n~: three\n",
    "document_start": "---\na: 1\n",
    "top_level_sequence": "- 1\n- two\n",
    "empty": "",
    "only_comments": "# nothing\n\n",
}


@pytest.mark.parametrize("text", EDGE_CASES.values(), ids=EDGE_CASES.keys())
def test_edge_case_equals_safe_load(text: str) -> None:
    want, got = pyyaml.safe_load(text), yaml.safe_load(text)
    assert repr(got) == repr(want)
    assert got == want or "nan" in repr(want)


def test_nan_and_inf() -> None:
    got = yaml.safe_load("a: .nan\nb: .Inf\nc: -.INF\n")
    assert math.isnan(got["a"]) and got["b"] == math.inf and got["c"] == -math.inf
    assert type(yaml.safe_load("a: 1e-4\n")["a"]) is str and yaml.safe_load("a: 5.0e-5\n")["a"] == 5e-5


UNSUPPORTED = {
    "anchor": ("a: 1\nb: &x 1\n", 2),
    "alias": ("a: *x\n", 1),
    "tag": ("a: !!str 1\n", 1),
    "literal_block": ("a: 1\nb: |\n  x\n", 2),
    "folded_block": ("a: >\n  x\n", 1),
    "complex_key": ("? a\n: b\n", 1),
    "directive": ("%YAML 1.1\n---\na: 1\n", 1),
    "timestamp": ("a: 2001-12-14\n", 1),
    "multi_line_plain": ("a: b\n  c\n", 2),
    "tab_indent": ("a:\n\tb: 1\n", 2),
    "second_document": ("a: 1\n---\nb: 2\n", 2),
    "merge_key": ("a:\n  <<: {b: 1}\n", 2),
    "unterminated_flow": ("a: [1, 2\nb: 3\n", 1),
    "unterminated_quote": ("a: 'x\n", 1),
}


@pytest.mark.parametrize("text,line", UNSUPPORTED.values(), ids=UNSUPPORTED.keys())
def test_unsupported_construct_raises_naming_its_line(text: str, line: int) -> None:
    with pytest.raises(ValueError, match=rf"^line {line}:"):
        yaml.safe_load(text)


INVALID = {
    "mapping_in_scalar": "a: b: c\n", "sequence_in_scalar": "a: -1\nb: - x\n", "bad_indent": "a: 1\n b: 2\n",
    "scalar_then_map": "x\ny: 1\n", "extra_brace": "a: {b: 1}}\n",
}


@pytest.mark.parametrize("text", INVALID.values(), ids=INVALID.keys())
def test_invalid_yaml_raises_in_both(text: str) -> None:
    with pytest.raises(pyyaml.YAMLError):
        pyyaml.safe_load(text)
    with pytest.raises(ValueError):
        yaml.safe_load(text)
