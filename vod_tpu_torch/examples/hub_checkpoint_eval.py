"""Hub-checkpoint retrieval eval (recall@10, ndcg@10 on BeIR): the port of `examples/hub_checkpoint_eval.py`.

    python -m vod_tpu_torch.examples.hub_checkpoint_eval --beir /path/to/beir_dir     # on the card
    python -m vod_tpu_torch.examples.hub_checkpoint_eval --device cpu --model org/name --beir tests/fixtures/beir_tiny

Cache-gated, as the JAX script is: nothing is downloaded. The checkpoint
(`config.json` with `model.safetensors` or `pytorch_model.bin`) and its
tokenizer files are read from a local directory (`--model` a path) or from
the local Hugging Face cache layout, `$HF_HOME/hub/models--<org>--<name>/
snapshots/<refs/main>/` (`HF_HOME` defaults to `~/.cache/huggingface`), by
the port's own readers (`models/hf_import.py:load_hf_encoder`,
`data/tokenizer.py:load_tokenizer`); `transformers` is never imported.
Where the files are absent it prints `SKIPPED: ...` and exits 0. `--beir`
must be a local BeIR-format directory (corpus.jsonl, queries.jsonl,
qrels/<split>.tsv; `data/loaders/beir.py`), else the script skips too.

The encoder (mean pooling, l2 output, f32 as in JAX's `load_hf_encoder`)
embeds "title content" sections and the queries (with "passage: " /
"query: " prefixes for e5 models), padded to `--max_length`; an exact f32
flat index gives each query's top 10, scored by recall@10 and ndcg@10
against the qrels. Prints one JSON line (the JAX script's keys plus
`card`); `main` returns it, or {"skipped": reason}.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.data.loaders.beir import BeirDatasetLoader
from vod_tpu_torch.data.tokenizer import load_tokenizer
from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import device_of
from vod_tpu_torch.models import Ranker, RetrievalGradients, VodPoolerConfig
from vod_tpu_torch.models.hf_import import load_hf_encoder, resolve_checkpoint
from vod_tpu_torch.runtime.predict import compute_embeddings_to_host
from vod_tpu_torch.search import SearchQueries, build_dense_index, dense_search


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="intfloat/e5-small-v2")
    ap.add_argument("--beir", default="scifact", help="a local BeIR-format directory")
    ap.add_argument("--split", default="test")
    ap.add_argument("--max_length", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--e5_prefixes", action="store_true", default=None,
                    help="prepend 'query: '/'passage: ' (auto for e5 models)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def probe_checkpoint(model: str) -> typ.Optional[pathlib.Path]:
    """The checkpoint's directory if its config, weights and tokenizer are on disk."""
    try:
        directory = resolve_checkpoint(model)
    except FileNotFoundError:
        return None
    weights = (directory / "model.safetensors").is_file() or (directory / "pytorch_model.bin").is_file()
    tokenizer = any((directory / f).is_file() for f in ("tokenizer.json", "vocab.txt", "vocab.json"))
    return directory if (directory / "config.json").is_file() and weights and tokenizer else None


def skipped(reason: str) -> dict:
    print(f"SKIPPED: {reason}", flush=True)
    return {"skipped": reason}


def main(argv: typ.Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    directory = probe_checkpoint(args.model)
    if directory is None:
        return skipped(f"{args.model!r} is not in a local directory or the local HF cache, and nothing is "
                       "downloaded. Put the checkpoint there (HF_HOME) and re-run; the harness needs no other change.")
    if not pathlib.Path(args.beir).is_dir():
        return skipped(f"model found, but {args.beir!r} is not a local BeIR directory. Pass --beir "
                       "/path/to/beir_dir (BeIR layout: corpus.jsonl, queries.jsonl, qrels/<split>.tsv).")
    device = device_of(args.device)

    t0 = time.perf_counter()
    use_prefix = args.e5_prefixes if args.e5_prefixes is not None else ("e5" in args.model)
    cfg, state = load_hf_encoder(str(directory), pooler=VodPoolerConfig(agg_method="mean", output_norm="l2"))
    model = Ranker(cfg, RetrievalGradients(), device=device)
    target = model.encoder.backbone
    types, emb = state.get("embeddings.token_type_embeddings.weight"), target.embeddings.token_type_embeddings
    if types is not None and emb is not None and types.shape[0] != emb.weight.shape[0]:  # RoBERTa: one type
        target.embeddings.token_type_embeddings = torch.nn.Embedding(*types.shape, device=device)
    target.load_state_dict(state)
    model.eval()
    tok = load_tokenizer(directory)
    print(f"# ported {args.model} ({time.perf_counter() - t0:.1f}s)", flush=True)

    q_rows = BeirDatasetLoader("queries")([args.beir], split=args.split)
    sec_rows = BeirDatasetLoader("sections")([args.beir], split=args.split)
    sec_id_to_row = {r["id"]: i for i, r in enumerate(sec_rows)}
    print(f"# beir {args.beir}: {len(q_rows)} queries, {len(sec_rows)} sections", flush=True)

    def encode_texts(texts: list[str], prefix: str) -> np.ndarray:
        enc = tok([prefix + t for t in texts], padding="max_length", truncation=True, max_length=args.max_length,
                  return_tensors="np")
        with torch.no_grad():
            return compute_embeddings_to_host(model.encode_field, enc["input_ids"].astype(np.int32),
                                              enc["attention_mask"].astype(np.int32), chunk=args.chunk, device=device)

    sec_texts = [((r.get("title") or "") + " " + r["content"]).strip() for r in sec_rows]
    emb = encode_texts(sec_texts, "passage: " if use_prefix else "")
    q_emb = encode_texts([r["query"] for r in q_rows], "query: " if use_prefix else "")
    embed_s = time.perf_counter() - t0

    index = build_dense_index(emb, dtype="float32", approx_recall=None, device=device)
    got = dense_search(index, SearchQueries(vector=torch.from_numpy(q_emb).to(device)), 10).indices.cpu().numpy()
    recalls, ndcgs = [], []
    for i, r in enumerate(q_rows):
        gold = {sec_id_to_row[g] for g in r["retrieval_ids"] if g in sec_id_to_row}
        if not gold:
            continue
        hits = [int(x) in gold for x in got[i]]
        recalls.append(sum(hits) / min(len(gold), 10))
        dcg = sum(h / np.log2(rank + 2) for rank, h in enumerate(hits))
        idcg = sum(1 / np.log2(rank + 2) for rank in range(min(len(gold), 10)))
        ndcgs.append(dcg / idcg)

    result = {
        "model": args.model, "beir": args.beir, "n_queries": len(recalls), "n_sections": len(sec_rows),
        "recall_10": round(float(np.mean(recalls)), 4), "ndcg_10": round(float(np.mean(ndcgs)), 4),
        "embed_s": embed_s, "card": card_name(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
