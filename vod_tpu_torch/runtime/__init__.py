"""Training runtime (port of `vod_tpu/runtime/`: the device collate, the train
step and its loops, GradCache, the optimizers, trainer state, callbacks and loggers,
re-embedding, retrieval benchmarking, checkpoints and generative evaluation)."""

from .benchmark import benchmark_retrieval
from .checkpoint import load_checkpoint, save_checkpoint
from .collate import DeviceCorpus, QueryBatch, build_device_corpus, build_lm_inputs, device_collate
from .generation import evaluate_generation, generation_metrics
from .gradcache import gradcache_backward
from .optim import Adafactor, adafactor, adamw, decay_mask
from .predict import cached_embeddings, compute_embeddings, compute_embeddings_to_host
from .state import ParameterSchedule, TrainerState
from .train import RealmTrainStep, clip_by_global_norm, make_train_step, training_loop, validation_loop

__all__ = [
    "Adafactor",
    "DeviceCorpus",
    "ParameterSchedule",
    "QueryBatch",
    "RealmTrainStep",
    "TrainerState",
    "adafactor",
    "adamw",
    "benchmark_retrieval",
    "build_device_corpus",
    "build_lm_inputs",
    "cached_embeddings",
    "clip_by_global_norm",
    "compute_embeddings",
    "compute_embeddings_to_host",
    "decay_mask",
    "device_collate",
    "evaluate_generation",
    "generation_metrics",
    "gradcache_backward",
    "load_checkpoint",
    "make_train_step",
    "save_checkpoint",
    "training_loop",
    "validation_loop",
]
