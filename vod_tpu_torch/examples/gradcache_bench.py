"""GradCache memory proof, 16k+ fused encoder rows in one step: the port of `examples/gradcache_bench.py`.

    python -m vod_tpu_torch.examples.gradcache_bench                  # on the card: bert-base, B=2048 x 8, L=128
    python -m vod_tpu_torch.examples.gradcache_bench --device cpu --b 8 --n_sections 2 --chunk 8 --ls 16 \
        --n_corpus 64 --vocab 128 --hidden 32 --layers 1 --heads 2 --inter 64

A BERT-base-sized `Ranker` (bf16 activations) trained with in-batch
negatives at B = `--b` queries x `--n_sections` sections of `--ls` tokens:
up to B x (1 + sections) fused encoder rows. The monolithic backward keeps
every layer's activations of every row; GradCache (`runtime/gradcache.py`,
`gradcache_chunk_rows=--chunk`) keeps one chunk's pass and the pooled
encodings, so the same step fits. Each configuration (GradCache, and with
`--also_monolithic` the fused backward, expected to run out of memory at the
default shape) runs two Adafactor steps from the same initial weights; the
line gives the rows, both losses, the second step's wall (synchronized) and
the first's, and the peak device memory, or the error that stopped it.

Data as the JAX script's (numpy seeds: corpus and embeddings seed 0, query
batches seeds 1 and 2); the weights come from a `torch.Generator` (seed 1)
and the sampler's draws from seeds 2 and 3, the port's own. `--vocab`,
`--hidden`, `--layers`, `--heads` and `--inter` (default bert-base's) cut the
width for small runs. `main` returns the printed quantities and `card`.
"""

from __future__ import annotations

import argparse
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import device_of, sync
from vod_tpu_torch.models import Ranker, RetrievalGradients, TransformerEncoderConfig, VodPoolerConfig
from vod_tpu_torch.runtime import DeviceCorpus, QueryBatch, adafactor, make_train_step
from vod_tpu_torch.search import HybridEngines, build_dense_index

Q_LEN = 32


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b", type=int, default=2048)
    ap.add_argument("--n_sections", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--ls", type=int, default=128)
    ap.add_argument("--n_corpus", type=int, default=100_000)
    ap.add_argument("--also_monolithic", action="store_true",
                    help="attempt the fused backward at the same shape (expected to run out of memory)")
    ap.add_argument("--vocab", type=int, default=30522)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--inter", type=int, default=3072)
    ap.add_argument("--dtype", default="bfloat16", help="activations: bfloat16 (default) or float32")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def encoder_config(args: argparse.Namespace) -> TransformerEncoderConfig:
    return TransformerEncoderConfig(
        vocab_size=args.vocab, hidden_size=args.hidden, num_layers=args.layers, num_heads=args.heads,
        intermediate_size=args.inter, dtype=getattr(torch, args.dtype),
        pooler=VodPoolerConfig(agg_method="mean", output_norm="l2", scaler=20.0),
    )


def make_data(args: argparse.Namespace) -> dict[str, np.ndarray]:
    """The JAX script's arrays: corpus token ids and index embeddings (seed 0)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(4, args.vocab, size=(args.n_corpus, args.ls)).astype("int32")
    emb = rng.standard_normal((args.n_corpus, args.hidden), dtype=np.float32)
    return {"corpus_ids": ids, "emb": emb}


def query_arrays(seed: int, args: argparse.Namespace) -> dict[str, np.ndarray]:
    """The JAX script's `qb(seed)`: query ids and one gold section each."""
    r = np.random.default_rng(seed)
    return {"input_ids": r.integers(4, args.vocab, size=(args.b, Q_LEN)).astype("int32"),
            "section_ids": r.integers(0, args.n_corpus, size=(args.b, 1)).astype("int32")}


def to_query_batch(a: dict[str, np.ndarray], device: torch.device) -> QueryBatch:
    ids = torch.from_numpy(a["input_ids"]).to(device)
    return QueryBatch(input_ids=ids, attention_mask=torch.ones_like(ids),
                      section_ids=torch.from_numpy(a["section_ids"]).to(device))


def train_step_fn(model: Ranker, args: argparse.Namespace, chunk: typ.Optional[int]):
    return make_train_step(model, adafactor(model, 1e-5), prefetch=16, n_sections=args.n_sections,
                           max_pos_sections=2, gradient_clip_val=1.0, in_batch_negatives=True,
                           gradcache_chunk_rows=chunk)


def main(argv: typ.Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = device_of(args.device)
    data = make_data(args)
    ids = torch.from_numpy(data["corpus_ids"]).to(device)
    corpus = DeviceCorpus(input_ids=ids, attention_mask=torch.ones_like(ids))
    engines = HybridEngines(dense=build_dense_index(data["emb"], dtype="bfloat16", device=device))
    cfg = encoder_config(args)
    model = Ranker(cfg, RetrievalGradients(), device=device, generator=torch.Generator(device=device).manual_seed(1))
    params0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    nparam = sum(p.numel() for p in model.parameters())
    rows = args.b + args.b * args.n_sections  # an upper bound (the flat pool drops duplicates)
    print(f"# params {nparam / 1e6:.1f}M | B={args.b} x {args.n_sections} sections -> <= {rows} fused rows "
          f"at L={args.ls}", flush=True)

    out: dict[str, typ.Any] = {"params_m": nparam / 1e6, "rows": rows, "configs": []}
    configs: list[tuple[str, typ.Optional[int]]] = [("gradcache", args.chunk)]
    if args.also_monolithic:
        configs.append(("monolithic", None))
    for name, chunk in configs:
        model.load_state_dict(params0)
        step = train_step_fn(model, args, chunk)
        row: dict[str, typ.Any] = {"name": name, "chunk": chunk}
        try:
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            m, _, _ = step.train_step(engines, corpus, to_query_batch(query_arrays(1, args), device),
                                      torch.Generator(device=device).manual_seed(2), {})
            row["loss0"] = float(m["loss"])
            row["first_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            m, _, _ = step.train_step(engines, corpus, to_query_batch(query_arrays(2, args), device),
                                      torch.Generator(device=device).manual_seed(3), {})
            row["loss1"] = float(m["loss"])
            sync(device)
            row["step_s"] = time.perf_counter() - t0
            row["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
            if not np.isfinite(row["loss1"]):
                raise FloatingPointError(f"loss {row['loss1']}")
            print(f"{name}(chunk={chunk}): loss {row['loss0']:.4f} -> {row['loss1']:.4f} | step {row['step_s']:.2f}s "
                  f"(first {row['first_s']:.1f}s)", flush=True)
        except (torch.OutOfMemoryError, RuntimeError, FloatingPointError) as e:
            if name == "gradcache":  # the proof itself failed
                raise
            row["failed"] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
            print(f"{name}(chunk={chunk}): FAILED {row['failed']}", flush=True)
        out["configs"].append(row)
        del step
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["card"] = card_name(device)
    return out


if __name__ == "__main__":
    main()
