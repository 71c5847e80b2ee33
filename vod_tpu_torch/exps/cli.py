"""Experiment runner and CLI (port of `vod_tpu/exps/cli.py`): config ->
datasets -> tokenized corpus on the device -> BM25 -> dataloaders -> model ->
periodic training with in-loop reindexing. `resume_from` reloads the run's
config and its newest checkpoint.

    python -m vod_tpu_torch.exps.cli --config exp.yaml [--max_steps N] [--resume_from RUN_DIR] [--device cuda]
    torchrun --nproc_per_node 2 -m vod_tpu_torch.exps.cli --config exp.yaml

It runs on the card unless `--device cpu` (`run_experiment(device=...)`)
asks for the CPU.

Several processes: under torchrun (its `RANK`/`WORLD_SIZE`/`LOCAL_RANK`/
`MASTER_ADDR` environment) or with JAX's flags (`--coordinator host:port
--num_processes N --process_id i`, or their `JAX_*` variables) each process
joins the group (`parallel/distributed.py:init_distributed`: nccl for
`--device cuda`, each rank on `cuda:{LOCAL_RANK % device_count}`; gloo for
the CPU; `--backend` names another). The mesh comes from `sys.mesh_shape`
/ `sys.mesh_axes` under JAX's gate: a layout other than `[1]` over more than
one rank (declared difference: the port counts ranks, where JAX counts
devices). Batches split over its `dp` axis, `n_dp` enters the batch
accounting, `dense.sharded` and `sparse.sharded` shard over their axes, and
rank 0 prints and writes. SPLADE, `collate.in_batch_negatives` and
`dense.autotune_target_recall` run under a mesh too: the FLOPS term and the
section pool are the global batch's, and every rank takes rank 0's
operating point (`runtime/train.py`, `search/autotune.py`). As in JAX, the
CLI never shards parameters: an
`fsdp`-only mesh runs the whole batch on every rank (`parallel/mesh.py:
shard_params` is reached through the API).

Declared differences from the JAX package:
 - the model's weights are drawn eagerly from a `torch.Generator` seeded
   `sys.seed` (the same generator then draws the collate's samples and is
   saved with each checkpoint); JAX initializes from a first collated batch
   and a dummy index, which the port needs neither of;
 - `optimizer: sgd` with `weight_decay` is `torch.optim.SGD` with the decay
   mask as parameter groups (optax's `add_decayed_weights` then `sgd`), and
   an `lr_schedule` sets each group's learning rate before every optimizer
   step from the count of updates applied (optax's schedule count);
 - `model.name_or_path` is read without `transformers` (`models/hf_import.py`)
   and, under `lora_rank > 0`, loaded into each LoRA layer's `base` with the
   adapters kept from their init (`lora_b` is 0, so the encoder at step 0 is
   the checkpoint's); JAX grafts the plain tree there, which a LoRA encoder
   cannot apply;
 - `check_ported` refuses, before any data is loaded, each option not ported
   yet with a `NotImplementedError` naming its ROADMAP item (none is left);
 - `sys.profile_dir` traces the first period's loop (`training_loop`);
 - `model.name_or_path` of a RoBERTa-family checkpoint keeps its one token
   type: the encoder takes the checkpoint's table, as JAX's graft does.

With `model.splade_encoder` the Ranker encodes with SPLADE: live retrieval
searches the queries' top `splade_query_k` impact terms, and each period
rebuilds a learned impact index (top `splade_doc_k` terms a document, at
most `splade_max_postings` a term) that replaces both the dense engine and
BM25, as in JAX. `model.name_or_path` then loads the checkpoint's backbone
only (the `bert.*` tensors of a `BertForMaskedLM`): the MLM head keeps its
init, as the JAX CLI leaves it (it never calls `port_splade_weights`).

`model.kbit` (with `lora_rank > 0`) int8-freezes the loaded base and trains
the LoRA adapters and the pooler only (`models/kbit.py`); `model.remat`
recomputes each encoder layer in the backward pass; `trainer.
gradcache_chunk_rows` runs a Ranker's backward through GradCache; `trainer.
optimizer: adafactor` is optax's Adafactor (`runtime/optim.py`).
"""

from __future__ import annotations

import json
import pathlib
import re
import typing as typ

import torch

from vod_tpu_torch.configs.dataloaders import DataLoaderConfig
from vod_tpu_torch.data.corpus import tokenize_corpus
from vod_tpu_torch.dataloaders import RealmDataloader
from vod_tpu_torch.exps.recipes import PeriodicTrainingConfig, periodic_training
from vod_tpu_torch.exps.structconf import Experiment, ModelConfig
from vod_tpu_torch.models import (
    CausalLMConfig,
    MarginalLikelihoodGradients,
    Ranker,
    Realm,
    RetrievalGradients,
    TransformerEncoderConfig,
    VodGradients,
    VodPoolerConfig,
    kbit_prepare,
    lora_trainable_mask,
)
from vod_tpu_torch.parallel.distributed import init_distributed, is_main_process, rank_device, world_size
from vod_tpu_torch.runtime import TrainerState, adafactor, adamw, build_device_corpus, decay_mask, load_checkpoint
from vod_tpu_torch.runtime.train import make_train_step

_NOT_PORTED = "is not ported to vod_tpu_torch yet (ROADMAP §A item {})"


def _raise_unported(unported: typ.Iterable[tuple[bool, str, str]]) -> None:
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(f"{what} {_NOT_PORTED.format(item)}")


def _unported_model_options(m: ModelConfig) -> list[tuple[bool, str, str]]:
    """(refused, the option, its ROADMAP §A item) for each model option the
    port lacks: none is left (MoE came with item 6)."""
    del m
    return []


def _uses_mesh(exp: Experiment) -> bool:
    """JAX's gate (`vod_tpu/exps/cli.py:227`), over ranks instead of devices."""
    return list(exp.sys.mesh_shape) != [1] and world_size() > 1


def check_ported(exp: Experiment, device: typ.Union[str, torch.device] = "cuda") -> None:
    """Raise `NotImplementedError` for each option of `exp` the port lacks
    (`device` is where the run would go; every option below runs on both)."""
    del device
    _raise_unported(_unported_model_options(exp.model))


def _make_distillation(cfg: ModelConfig) -> typ.Any:
    from vod_tpu_torch.models.gradients import DistillationGradients

    return DistillationGradients(
        objective=cfg.distill_objective,
        temperature=cfg.distill_temperature,
        ce_weight=cfg.distill_ce_weight,
    )


def build_model(
    cfg: ModelConfig,
    *,
    proposal_temperature: float = 1.0,
    device: typ.Union[str, torch.device] = "cuda",
    generator: typ.Optional[torch.Generator] = None,
) -> torch.nn.Module:
    """The `Ranker`, `Realm` or `Seq2SeqRealm` of a model config, on `device`,
    random-initialised from `generator`. `proposal_temperature` must equal the
    collate's sampling temperature: the VOD estimator's importance correction
    subtracts the same beta*s the priority sampler used as its proposal."""
    if cfg.splade_encoder and cfg.debug_encoder:
        raise ValueError("splade_encoder and debug_encoder are mutually exclusive")
    if cfg.kind == "realm" and cfg.splade_encoder:
        raise ValueError("splade_encoder is only supported for kind: ranker")
    _raise_unported(_unported_model_options(cfg))
    enc_cfg = TransformerEncoderConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers,
        num_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        remat=cfg.remat,
        lora_rank=cfg.lora_rank,
        lora_alpha=cfg.lora_alpha,
        moe_experts=cfg.moe_experts,
        moe_top_k=cfg.moe_top_k,
        moe_capacity_factor=cfg.moe_capacity_factor,
        pooler=VodPoolerConfig(
            agg_method=cfg.agg_method,
            output_norm=cfg.output_norm,
            scaler=cfg.scaler,
            learn_scaler=cfg.learn_scaler,
        ),
    )
    gradients = {
        "retrieval": lambda: RetrievalGradients(),
        "marginal_likelihood": lambda: MarginalLikelihoodGradients(),
        "vod": lambda: VodGradients(alpha=cfg.vod_alpha, proposal_temperature=proposal_temperature),
        "distillation": lambda: _make_distillation(cfg),
    }[cfg.gradients]()
    kw = dict(debug_encoder=cfg.debug_encoder, device=device, generator=generator)
    if cfg.kind == "realm":
        if cfg.reader == "seq2seq":
            from vod_tpu_torch.models.seq2seq import Seq2SeqRealm
            from vod_tpu_torch.models.t5_encoder import T5EncoderConfig

            reader_cfg = T5EncoderConfig(
                vocab_size=cfg.vocab_size,
                hidden_size=cfg.lm_hidden_size,
                num_layers=cfg.lm_num_layers,
                num_heads=cfg.num_heads,
                head_dim=cfg.lm_hidden_size // cfg.num_heads,
                intermediate_size=cfg.intermediate_size,
            )
            return Seq2SeqRealm(enc_cfg, reader_cfg, gradients, **kw)
        return Realm(enc_cfg, _causal_lm_config(cfg), gradients, **kw)
    return Ranker(enc_cfg, gradients, splade_encoder=cfg.splade_encoder, splade_flops_weight=cfg.splade_flops_weight,
                  **kw)


def _causal_lm_config(cfg: ModelConfig) -> CausalLMConfig:
    """Reader config: from the pretrained checkpoint's config when
    `lm_name_or_path` is set (the local or cached checkpoint's `config.json`:
    its dims win), else from the ModelConfig knobs."""
    if cfg.lm_name_or_path is not None:
        try:
            from vod_tpu_torch.models.lm import gpt2_config_from_hf, read_hf_config

            return gpt2_config_from_hf(read_hf_config(cfg.lm_name_or_path))
        except Exception as exc:  # noqa: BLE001 - hub/cache errors surface here
            if cfg.hf_fallback != "random":
                raise
            import warnings

            warnings.warn(f"HF LM config {cfg.lm_name_or_path!r} unavailable ({exc}); config dims")
    return CausalLMConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.lm_hidden_size,
        num_layers=cfg.lm_num_layers,
        num_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
    )


def _maybe_port_hf_lm(model: torch.nn.Module, cfg: ModelConfig) -> torch.nn.Module:
    """Load a ported HF GPT-2-family reader into a freshly initialised
    `Realm` (`models/lm.py:load_hf_causal_lm`, which needs `transformers`)."""
    if cfg.lm_name_or_path is None or cfg.kind != "realm" or cfg.reader != "causal":
        return model
    try:
        from vod_tpu_torch.models.lm import load_hf_causal_lm

        _, lm_state = load_hf_causal_lm(cfg.lm_name_or_path)
    except Exception as exc:  # noqa: BLE001
        if cfg.hf_fallback == "random":
            import warnings

            warnings.warn(f"HF port of {cfg.lm_name_or_path!r} unavailable ({exc}); random init")
            return model
        raise
    model.lm.load_state_dict(lm_state)
    return model


def _maybe_port_hf_encoder(model: torch.nn.Module, cfg: ModelConfig) -> torch.nn.Module:
    """Load a ported HF BERT-family backbone into a freshly initialised model
    (`models/hf_import.py:load_hf_encoder`, which reads a local directory or
    the offline HF cache). `hf_fallback: random` keeps the random init when
    the checkpoint cannot be read. Under LoRA each FFN dense layer's weights
    go into its `base`, and the adapters keep their init."""
    if cfg.name_or_path is None or cfg.debug_encoder:
        return model
    try:
        from vod_tpu_torch.models.hf_import import load_hf_encoder

        hf_cfg, backbone = load_hf_encoder(cfg.name_or_path)
    except Exception as exc:  # noqa: BLE001 - a missing or unreadable checkpoint surfaces here
        if cfg.hf_fallback == "random":
            import warnings

            warnings.warn(f"HF port of {cfg.name_or_path!r} unavailable ({exc}); random init")
            return model
        raise
    if (hf_cfg.hidden_size, hf_cfg.num_layers) != (cfg.hidden_size, cfg.num_layers):
        raise ValueError(
            f"config mismatch vs checkpoint {cfg.name_or_path!r}: "
            f"hidden={hf_cfg.hidden_size} layers={hf_cfg.num_layers}"
        )
    target = model.encoder.backbone
    # JAX's graft takes the checkpoint's leaves whole: a RoBERTa-family
    # checkpoint has one token type where the config builds two
    types, emb = backbone.get("embeddings.token_type_embeddings.weight"), target.embeddings.token_type_embeddings
    if types is not None and emb is not None and types.shape[0] != emb.weight.shape[0]:
        target.embeddings.token_type_embeddings = torch.nn.Embedding(*types.shape, device=emb.weight.device,
                                                                     dtype=emb.weight.dtype)
    if cfg.lora_rank > 0:
        backbone = {re.sub(r"\.(intermediate|output)\.", r".\1.base.", k): v for k, v in backbone.items()}
    missing, unexpected = target.load_state_dict(backbone, strict=False)
    adapters = [k for k in missing if k.endswith((".lora_a", ".lora_b"))]
    if unexpected or len(adapters) != len(missing):
        raise ValueError(f"checkpoint {cfg.name_or_path!r} does not fit the encoder: missing "
                         f"{sorted(set(missing) - set(adapters))}, unexpected {sorted(unexpected)}")
    return model


def _optimizer(model: torch.nn.Module, exp: Experiment, start_count: int) -> torch.optim.Optimizer:
    """The trainer's optimizer over `model`, with its learning-rate schedule
    counted from `start_count` updates."""
    t = exp.trainer
    lr: typ.Any = t.learning_rate
    if t.lr_schedule is not None:
        lr = t.lr_schedule.instantiate(t.learning_rate, t.max_steps)
    lr0 = lr(start_count) if callable(lr) else lr
    if t.optimizer == "adamw":
        opt = adamw(model, lr0, weight_decay=t.weight_decay)
    elif t.optimizer == "adafactor":
        opt = adafactor(model, lr0, weight_decay=t.weight_decay or None)
    else:  # sgd
        keep = decay_mask(model)
        groups = [
            {"params": [p for n, p in model.named_parameters() if keep[n]], "weight_decay": t.weight_decay},
            {"params": [p for n, p in model.named_parameters() if not keep[n]], "weight_decay": 0.0},
        ]
        opt = torch.optim.SGD([g for g in groups if g["params"]], lr=lr0)
    if callable(lr):
        count = [start_count]

        def set_lr(optimizer: torch.optim.Optimizer, args: typ.Any, kwargs: typ.Any) -> None:
            for group in optimizer.param_groups:
                group["lr"] = lr(count[0])
            count[0] += 1

        opt.register_step_pre_hook(set_lr)
    return opt


def run_experiment(
    exp: Experiment,
    *,
    sections: typ.Optional[typ.Sequence[typ.Mapping]] = None,
    queries: typ.Optional[typ.Sequence[typ.Mapping]] = None,
    val_queries: typ.Optional[typ.Sequence[typ.Mapping]] = None,
    tokenizer: typ.Optional[typ.Any] = None,
    on_log: typ.Optional[typ.Callable[[int, dict], None]] = None,
    resume_from: typ.Optional[str] = None,
    device: typ.Union[str, torch.device] = "cuda",
) -> dict[str, typ.Any]:
    """Run the periodic-training recipe of `exp` on `device`.

    Datasets and the tokenizer may be passed directly (tests, notebooks) or
    are loaded from the config. `resume_from` restores the model, optimizer,
    generator and trainer progress from a run dir or one of its `period-*`
    checkpoints; the step budget, period and schedules come from `exp`.
    Returns {model, optimizer, step_fn, state, history}."""
    check_ported(exp, device)
    device = torch.device(device)
    if device.type == "cuda" and world_size() > 1:
        device = rank_device()
    tokenizer = tokenizer if tokenizer is not None else exp.tokenizer.instantiate()

    # --- the mesh from SysConfig: batches split over a "dp" axis, sharded
    # indexes over their `shard_axis` ---
    mesh = dp_axis = None
    if _uses_mesh(exp):
        from vod_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(tuple(exp.sys.mesh_shape), tuple(exp.sys.mesh_axes))
        dp_axis = "dp" if "dp" in mesh.mesh_dim_names else None
        if exp.search_defaults.dense.sharded and exp.search_defaults.dense.shard_axis not in mesh.mesh_dim_names:
            raise ValueError(
                f"dense.sharded requires axis {exp.search_defaults.dense.shard_axis!r} "
                f"in sys.mesh_axes {list(mesh.mesh_dim_names)}"
            )

    # effective-batch accounting: when `trainer.batch_size` is set explicitly,
    # `per_device` drives the dataloader and accumulate_grad_batches is
    # inferred as ceil(effective / (per_device * dp degree)) unless pinned by hand
    dl_config = exp.dataloader
    accumulate = exp.trainer.accumulate_grad_batches
    bs = exp.trainer.batch_size
    if bs.fields_set:
        if "per_device" in bs.fields_set and bs.per_device != dl_config.batch_size:
            dl_config = dl_config.replace(batch_size=bs.per_device)
        n_dp = mesh.size(mesh.mesh_dim_names.index(dp_axis)) if (mesh is not None and dp_axis is not None) else 1
        if accumulate == 1:
            accumulate = max(1, -(-bs.effective // (n_dp * dl_config.batch_size)))

    if sections is None or queries is None:
        from vod_tpu_torch.data.interface import load_queries, load_sections
        from vod_tpu_torch.data.postprocessing import combine_datasets

        sections = combine_datasets([load_sections(c) for c in exp.datasets.sections])
        queries = combine_datasets([load_queries(c) for c in exp.datasets.queries])

    # --- corpus -> device, BM25 -------------------------------------------------
    sparse_cfg = exp.search_defaults.sparse
    enc = tokenize_corpus(
        list(sections),
        tokenizer,
        max_length=exp.tokenizer.max_length,
        templates=exp.templates,
        with_sparse_terms=True,
        sparse_language=sparse_cfg.language,
        sparse_stem=sparse_cfg.stem,
    )
    corpus = build_device_corpus(enc["input_ids"], enc["attention_mask"], enc["subset_ids"], device=device)
    from vod_tpu_torch.search.factory import build_sparse_from_config

    terms, counts = enc["terms"], enc["term_counts"]
    sparse_engine = build_sparse_from_config(
        sparse_cfg, [terms[i, : counts[i]].tolist() for i in range(len(sections))], n_terms=1 << 18,
        mesh=mesh if (sparse_cfg.sharded and mesh is not None and sparse_cfg.shard_axis in mesh.mesh_dim_names)
        else None,
        shard_axis=sparse_cfg.shard_axis, device=device,
    )

    # --- dataloaders --------------------------------------------------------------
    with_lm = exp.model.kind == "realm"
    loader_kw = dict(
        templates=exp.templates, id_map=enc["id_map"], subset_id_map=enc["subset_id_map"],
        max_length=exp.tokenizer.max_length, with_answers=with_lm, with_sparse_terms=True,
        sparse_language=sparse_cfg.language, sparse_stem=sparse_cfg.stem, device=device,
    )
    train_dl = RealmDataloader(list(queries), tokenizer, config=dl_config, **loader_kw)
    val_dl_batches = None
    if val_queries is not None:
        val_dl = RealmDataloader(
            list(val_queries), tokenizer,
            config=DataLoaderConfig(batch_size=exp.dataloader.batch_size, shuffle=False), **loader_kw,
        )
        val_dl_batches = list(val_dl.epoch(seed=0))

    # --- model + optimizer ----------------------------------------------------------
    generator = torch.Generator(device=device).manual_seed(exp.sys.seed)
    model = build_model(exp.model, proposal_temperature=exp.collate.temperature, device=device,
                        generator=generator)
    model = _maybe_port_hf_encoder(model, exp.model)
    model = _maybe_port_hf_lm(model, exp.model)
    if exp.model.kbit:
        # QLoRA-style: int8-freeze the base, optimize LoRA and the pooler only
        if exp.model.lora_rank <= 0:
            raise ValueError("model.kbit requires model.lora_rank > 0 (nothing to train)")
        kbit_prepare(model, lora_trainable_mask(model))
    state = TrainerState(
        max_steps=exp.trainer.max_steps,
        period=exp.trainer.period,
        accumulate_grad_batches=accumulate,
        parameters={k: s.instantiate() for k, s in exp.trainer.parameters.items()},
    )
    ckpt = _latest_checkpoint_dir(resume_from) if resume_from is not None else None
    start_count = 0
    if ckpt is not None:
        start_count = json.loads((ckpt / "trainer_state.json").read_text())["update_steps"]
    optimizer = _optimizer(model, exp, start_count)
    step_fn = make_train_step(
        model, optimizer,
        prefetch=exp.collate.prefetch_n_sections,
        n_sections=exp.collate.n_sections or 8,
        max_pos_sections=exp.collate.max_pos_sections or 2,
        temperature=exp.collate.temperature,
        max_support_size=exp.collate.support_size,
        with_lm=with_lm,
        gradient_clip_val=exp.trainer.gradient_clip_val,
        in_batch_negatives=exp.collate.in_batch_negatives,
        accumulate_grad_batches=accumulate,
        splade_query_k=exp.model.splade_query_k if exp.model.splade_encoder else None,
        gradcache_chunk_rows=exp.trainer.gradcache_chunk_rows,
    )

    if ckpt is not None:
        loaded = load_checkpoint(ckpt, model=model, optimizer=optimizer, generator=generator)
        # progress counters come from the checkpoint; the step budget, period
        # length and schedules come from the (possibly updated) config
        state.step = loaded.step
        state.epoch = loaded.epoch
        state.update_steps = loaded.update_steps

    if exp.trainer.checkpoint_path and is_main_process():
        # the config beside the checkpoints, so `--resume_from <dir>` can reload it
        cfg_dir = pathlib.Path(exp.trainer.checkpoint_path)
        cfg_dir.mkdir(parents=True, exist_ok=True)
        (cfg_dir / "config.json").write_text(exp.to_json(indent=2))

    def train_queries_fn(pidx: int):
        return train_dl.forever(seed=exp.sys.seed + 7919 * pidx)

    state, history = periodic_training(
        step_fn=step_fn,
        corpus=corpus,
        state=state,
        train_queries_fn=train_queries_fn,
        generator=generator,
        sparse_engine=sparse_engine,
        val_queries=val_dl_batches,
        config=PeriodicTrainingConfig(
            # splade: the learned impact index replaces the dense engine and is
            # rebuilt from the current encoder at every period boundary
            dense=None if exp.model.splade_encoder else exp.search_defaults.dense,
            splade_doc_k=exp.model.splade_doc_k if exp.model.splade_encoder else None,
            splade_max_postings=exp.model.splade_max_postings,
            splade_query_k=exp.model.splade_query_k,
            checkpoint_dir=exp.trainer.checkpoint_path,
            log_interval=exp.trainer.log_interval,
            val_check_interval=exp.trainer.val_check_interval,
            metrics=tuple(exp.trainer.metrics),
            mesh=mesh,
            dp_axis=dp_axis,
            profile_dir=exp.sys.profile_dir,
        ),
        on_log=on_log,
    )
    return {"model": model, "optimizer": optimizer, "step_fn": step_fn, "state": state, "history": history}


def _latest_checkpoint_dir(resume_from: str) -> pathlib.Path:
    """Resolve a run dir to its newest `period-*` checkpoint (or itself)."""
    root = pathlib.Path(resume_from)
    if (root / "trainer_state.json").exists():
        return root
    periods = sorted(
        (p for p in root.glob("period-*") if (p / "trainer_state.json").exists()),
        key=lambda p: int(p.name.split("-")[1]),
    )
    if not periods:
        raise FileNotFoundError(f"no checkpoint under {resume_from!r}")
    return periods[-1]


def parser() -> "argparse.ArgumentParser":
    import argparse

    p = argparse.ArgumentParser(description="vod-tpu training (PyTorch/CUDA port)")
    p.add_argument("--config", default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument(
        "--resume_from", default=None,
        help="run/checkpoint dir; reloads its config.json unless --config overrides",
    )
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    # multi-process launch: JAX's flags; torchrun's environment needs none
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--backend", default=None, help="process-group backend (default: nccl on cuda, gloo on cpu)")
    return p


def main(argv: typ.Optional[list[str]] = None) -> dict[str, typ.Any]:
    """CLI: `python -m vod_tpu_torch.exps.cli --config exp.yaml [--max_steps N]
    [--resume_from RUN_DIR] [--device cuda|cpu]`. Returns run_experiment's result."""
    p = parser()
    args = p.parse_args(argv)
    joined = torch.distributed.is_initialized()
    rank, world = init_distributed(args.coordinator, args.num_processes, args.process_id, backend=args.backend,
                                   device=args.device)
    if world > 1:
        print(f"[rank {rank}/{world}] joined ({torch.distributed.get_backend()}, {rank_device(args.device)})",
              flush=True)
    if args.config is not None:
        exp = Experiment.from_file(args.config)
    elif args.resume_from and (pathlib.Path(args.resume_from) / "config.json").exists():
        exp = Experiment.from_file(str(pathlib.Path(args.resume_from) / "config.json"))
    else:
        p.error("--config is required (no config.json found to resume from)")
    if args.max_steps is not None:
        exp = Experiment.model_validate(
            {**json.loads(exp.to_json()), "trainer": {**exp.trainer.to_dict(), "max_steps": args.max_steps}}
        )
    result = run_experiment(
        exp, on_log=lambda s, m: print(f"[{s}] {m}", flush=True), resume_from=args.resume_from, device=args.device
    )
    if is_main_process():
        print(f"done: {result['state'].step} steps", flush=True)
    if world > 1 and not joined:  # leave a group this call did not make
        torch.distributed.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
