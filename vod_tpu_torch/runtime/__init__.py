"""Training runtime (port of `vod_tpu/runtime/`: the device collate, the train
step and its loops, the optimizer, trainer state, callbacks and loggers,
re-embedding, retrieval benchmarking, checkpoints and generative evaluation)."""

from .benchmark import benchmark_retrieval
from .checkpoint import load_checkpoint, save_checkpoint
from .collate import DeviceCorpus, QueryBatch, build_device_corpus, build_lm_inputs, device_collate
from .generation import evaluate_generation, generation_metrics
from .optim import adamw, decay_mask
from .predict import compute_embeddings, compute_embeddings_to_host
from .state import ParameterSchedule, TrainerState
from .train import RealmTrainStep, clip_by_global_norm, make_train_step, training_loop, validation_loop

__all__ = [
    "DeviceCorpus",
    "ParameterSchedule",
    "QueryBatch",
    "RealmTrainStep",
    "TrainerState",
    "adamw",
    "benchmark_retrieval",
    "build_device_corpus",
    "build_lm_inputs",
    "clip_by_global_norm",
    "compute_embeddings",
    "compute_embeddings_to_host",
    "decay_mask",
    "device_collate",
    "evaluate_generation",
    "generation_metrics",
    "load_checkpoint",
    "make_train_step",
    "save_checkpoint",
    "training_loop",
    "validation_loop",
]
