"""Pretty printers for batches, configs, metrics and parameters (port of
`vod_tpu/utils/pretty.py`): `rich` tables where `rich` is installed, plain
text otherwise, in the same layout as the JAX package's. Fields may be
torch tensors (on any device; bf16 is read as f32) or numpy arrays.
`pprint_retrieval_batch` and `render_retrieval_batch_html` detokenize
with the tokenizer's `decode`."""

from __future__ import annotations

import typing as typ

import numpy as np


def _console():
    try:
        import rich.console

        return rich.console.Console()
    except Exception:
        return None


def _numpy(x: typ.Any) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu()
        if not x.dtype.is_floating_point or x.dtype.itemsize >= 4:
            return x.numpy()
        return x.float().numpy()
    return np.asarray(x)


def human_format_nb(num: float, precision: int = 2, base: float = 1000.0) -> str:
    """1234567 -> '1.23M'."""
    magnitude = 0
    num = float(num)
    while abs(num) >= base and magnitude < 6:
        magnitude += 1
        num /= base
    return f"{num:.{precision}f}{['', 'K', 'M', 'B', 'T', 'P', 'E'][magnitude]}"


def human_format_bytes(x: int, unit: str = "MB") -> str:
    """Bytes -> '12.30 MB'."""
    divisor = {"B": 1, "KB": 1 << 10, "MB": 1 << 20, "GB": 1 << 30, "TB": 1 << 40}[unit]
    return f"{x / divisor:.2f} {unit}"


def repr_array(x: typ.Any) -> str:
    """One-line shape / dtype / device summary of a tensor or array."""
    dev = f" @{x.device.type}" if hasattr(x, "device") and hasattr(x.device, "type") else ""
    dtype = str(x.dtype).removeprefix("torch.")
    return f"{type(x).__name__}[{', '.join(map(str, x.shape))}] {dtype}{dev}"


def _properties(v: typ.Any) -> tuple[str, str]:
    """(shape / dtype, stats) columns of one batch field: min / mean / max
    and the count of non-finite values of a numeric one."""
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        arr = _numpy(v)
        stats = ""
        if arr.size and np.issubdtype(arr.dtype, np.number):
            f = arr.astype(np.float64, copy=False)
            finite = np.isfinite(f)
            n_bad = int(arr.size - finite.sum())
            if finite.any():
                ff = f[finite]
                stats = f"min={ff.min():.3g} mean={ff.mean():.3g} max={ff.max():.3g}"
            if n_bad:
                stats += f" ({n_bad} non-finite)"
        return f"{tuple(v.shape)} {str(v.dtype).removeprefix('torch.')}", stats
    if isinstance(v, (list, tuple, set)):
        return f"{type(v).__name__}[{len(v)}]", ""
    return type(v).__name__, str(v)[:40] if isinstance(v, (int, float, str, bool)) else ""


def _table(header: str, columns: list[tuple[str, str]], rows: list[tuple[str, ...]], widths: list[int]) -> None:
    """`rows` as a rich table (`columns`: (name, justify); a row's cells past
    them are left out), or as plain text with each cell but the last
    left-aligned to `widths`."""
    console = _console()
    if console is not None:
        import rich.table

        table = rich.table.Table(title=header)
        for name, justify in columns:
            table.add_column(name, justify=justify)
        for row in rows:
            table.add_row(*row[: len(columns)])
        console.print(table)
        return
    print(f"== {header} ==")
    for row in rows:
        print("  " + " ".join(f"{c:{w}s}" for c, w in zip(row[:-1], widths)) + (" " if len(row) > 1 else "") + row[-1])


def pprint_batch(batch: typ.Any, header: str = "batch", stats: bool = True) -> None:
    """Tabulate a batch's fields with shapes and dtypes (and min / mean /
    max / non-finite counts with `stats`)."""
    items: list[tuple[str, str, str]] = []
    source = batch.__dict__ if hasattr(batch, "__dict__") else dict(batch)
    for k, v in source.items():
        if v is None or k in ("extras", "diagnostics"):
            continue
        sd, st = _properties(v)
        items.append((k, sd, st if stats else ""))
    cols = [("field", "left"), ("shape / dtype", "left")] + ([("stats", "left")] if stats else [])
    _table(header, cols, items, [28, 24])


def pprint_config(
    config: typ.Any,
    header: str = "config",
    exclude: typ.Sequence[str] = ("api_key", "token", "password"),
) -> None:
    """Pretty-print a config tree (a port config, dataclass or dict) as JSON,
    pruning secret keys."""
    import json

    if hasattr(config, "to_dict"):
        data = config.to_dict()
    elif hasattr(config, "__dict__") and not isinstance(config, dict):
        data = dict(config.__dict__)
    else:
        data = dict(config)

    def _prune(x: typ.Any) -> typ.Any:
        if isinstance(x, dict):
            return {k: _prune(v) for k, v in x.items() if not any(e in k.lower() for e in exclude)}
        if isinstance(x, (list, tuple)):
            return [_prune(v) for v in x]
        return x

    text = json.dumps(_prune(data), indent=2, default=str)
    console = _console()
    if console is not None:
        import rich.panel
        import rich.syntax

        console.print(rich.panel.Panel(rich.syntax.Syntax(text, "json"), title=header))
    else:
        print(f"== {header} ==\n{text}")


def pprint_metrics(metrics: typ.Mapping[str, typ.Any], header: str = "metrics") -> None:
    rows = [(k, f"{float(v):.4f}" if isinstance(v, (int, float, np.floating)) else str(v)) for k, v in metrics.items()]
    _table(header, [("metric", "left"), ("value", "right")], rows, [24])


def pprint_params(params: typ.Any, header: str = "parameters") -> dict[str, int]:
    """Print the parameter count of each top-level submodule of a module (or
    of each first dotted name of a state dict); returns {name: count}."""
    named = params.named_parameters() if hasattr(params, "named_parameters") else params.items()
    counts: dict[str, int] = {}
    total = 0
    for name, leaf in named:
        n = int(np.prod(tuple(leaf.shape))) if hasattr(leaf, "shape") else 1
        top = name.split(".")[0]
        counts[top] = counts.get(top, 0) + n
        total += n
    rows = [(k, f"{v:,}") for k, v in sorted(counts.items())] + [("TOTAL", f"{total:,}")]
    _table(header, [("subtree", "left"), ("params", "right")], rows, [24])
    return counts


def _shared_pool(batch: typ.Any) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    q_ids, s_ids, scores = (_numpy(batch.query__input_ids), _numpy(batch.section__input_ids),
                            _numpy(batch.section__score))
    b, d = scores.shape
    s_ids = s_ids.reshape(-1, s_ids.shape[-1])
    return q_ids, s_ids, scores, s_ids.shape[0] != b * d


def pprint_retrieval_batch(batch: typ.Any, tokenizer: typ.Any, top_sections: int = 3, max_queries: int = 2) -> None:
    """Detokenize the queries and their top sections."""
    q_ids, s_ids, scores, shared_pool = _shared_pool(batch)
    b, d = scores.shape
    for i in range(min(b, max_queries)):
        print(f"query[{i}]: {tokenizer.decode([t for t in q_ids[i] if t > 0], skip_special_tokens=True)!r}")
        order = np.argsort(-np.where(np.isfinite(scores[i]), scores[i], -np.inf))[:top_sections]
        for rank, j in enumerate(order):
            row = j if shared_pool else i * d + j
            text = tokenizer.decode([t for t in s_ids[row] if t > 0], skip_special_tokens=True)
            print(f"   #{rank} score={scores[i, j]:+.3f}: {text!r}")


def render_retrieval_batch_html(batch: typ.Any, tokenizer: typ.Any, top_sections: int = 5,
                                max_queries: int = 4) -> str:
    """An HTML table of the queries and their top sections."""
    import html as _html

    q_ids, s_ids, scores, shared_pool = _shared_pool(batch)
    labels = getattr(batch, "section__relevance", None)
    labels = None if labels is None else _numpy(labels)
    b, d = scores.shape
    rows = ["<table border='1' cellpadding='4'>",
            "<tr><th>query</th><th>rank</th><th>score</th><th>label</th><th>section</th></tr>"]
    for i in range(min(b, max_queries)):
        q_text = tokenizer.decode([t for t in q_ids[i] if t > 0], skip_special_tokens=True)
        order = np.argsort(-np.where(np.isfinite(scores[i]), scores[i], -np.inf))[:top_sections]
        for rank, j in enumerate(order):
            row = j if shared_pool else i * d + j
            text = tokenizer.decode([t for t in s_ids[row] if t > 0], skip_special_tokens=True)
            lab = "" if labels is None else f"{labels[i, j]:.0f}"
            rows.append(
                f"<tr><td>{_html.escape(q_text) if rank == 0 else ''}</td>"
                f"<td>{rank}</td><td>{scores[i, j]:+.3f}</td><td>{lab}</td>"
                f"<td>{_html.escape(text)}</td></tr>"
            )
    rows.append("</table>")
    return "\n".join(rows)
