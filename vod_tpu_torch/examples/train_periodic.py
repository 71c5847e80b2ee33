"""End-to-end periodic REALM training from a config dict: the port of `examples/train_periodic.py`.

    python -m vod_tpu_torch.examples.train_periodic                   # on the card
    python -m vod_tpu_torch.examples.train_periodic --device cpu --max-steps 4 --period 2

The reference `train` CLI and `recipes/periodic_training.py` in one call:
`exps/cli.py:run_experiment` over 24 in-file sections and 48 queries, a
one-layer ranker (hidden 32) trained with live retrieval (dense weight 1.0,
the sparse weight ramping 0 -> 1 over 30 steps), the corpus re-embedded and
the index rebuilt every `--period` steps. The vocabulary is the toy one
(`toy_text.tiny_tokenizer`: a `vocab.txt` read by the port's WordPiece, in
place of the JAX script's `transformers` tokenizer). Weights and draws come
from the runner's seeded `torch.Generator`s, the port's own. `main` returns
the logged metrics, the step count and each period's re-embed and total
seconds, and `card`.
"""

from __future__ import annotations

import argparse
import typing as typ

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import device_of
from vod_tpu_torch.examples.toy_text import VOCAB, tiny_tokenizer
from vod_tpu_torch.exps.cli import run_experiment
from vod_tpu_torch.exps.structconf import Experiment

SECTIONS = []
QUERIES = []
_CITIES = ["paris", "tokyo", "berlin", "rome", "madrid", "london"]
_COUNTRIES = ["france", "japan", "germany", "italy", "spain", "england"]
for i in range(24):
    j = i % 6
    SECTIONS.append({"id": f"s{i}", "content": f"{_CITIES[j]} is the capital of {_COUNTRIES[j]} tok{i}",
                     "title": _COUNTRIES[j], "subset_id": None})
for i in range(48):
    j = i % 6
    QUERIES.append({"id": f"q{i}", "query": f"what is the capital of {_COUNTRIES[j]} tok{i % 24}",
                    "answers": [_CITIES[j]], "answer_scores": [1.0],
                    "retrieval_ids": [f"s{i % 24}"], "retrieval_scores": [1.0], "subset_ids": []})


def experiment_dict(max_steps: int = 30, period: int = 10, log_interval: int = 5) -> dict:
    """The JAX script's config (its step budget and period as arguments)."""
    return {
        "model": {"kind": "ranker", "gradients": "retrieval", "vocab_size": len(VOCAB),
                  "hidden_size": 32, "num_layers": 1, "num_heads": 2, "intermediate_size": 64, "scaler": 8.0},
        "tokenizer": {"max_length": 24},
        "collate": {"prefetch_n_sections": 12, "n_sections": 4, "max_pos_sections": 1},
        "dataloader": {"batch_size": 8},
        "trainer": {"max_steps": max_steps, "period": period, "log_interval": log_interval, "learning_rate": 3e-3,
                    "parameters": {"dense": {"mode": "constant", "value": 1.0},
                                   "sparse": {"mode": "linear", "start": 0.0, "value": 1.0, "period": 30}}},
    }


def main(argv: typ.Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-steps", type=int, default=30)
    ap.add_argument("--period", type=int, default=10)
    ap.add_argument("--log-interval", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    exp = Experiment.parse(experiment_dict(args.max_steps, args.period, args.log_interval))
    logs: list[dict] = []

    def on_log(step: int, metrics: dict) -> None:
        floats = {k: float(v) for k, v in metrics.items() if isinstance(v, float)}
        logs.append({"step": step, **floats})
        print(f"  step {step}: " + ", ".join(f"{k}={v:.3f}" for k, v in floats.items()))

    out = run_experiment(exp, sections=SECTIONS, queries=QUERIES, val_queries=QUERIES[:8], tokenizer=tiny_tokenizer(),
                         on_log=on_log, device=device)
    print(f"\ncompleted {out['state'].step} steps over {len(out['history'])} periods")
    for h in out["history"]:
        print(f"  period {h['period']}: re-embed {h['embed_s']}s, total {h['period_s']}s")
    return {"steps": out["state"].step, "logs": logs,
            "periods": [{"period": h["period"], "embed_s": h["embed_s"], "period_s": h["period_s"]}
                        for h in out["history"]],
            "card": card_name(device)}


if __name__ == "__main__":
    main()
