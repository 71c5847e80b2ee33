"""Training runtime (port of `vod_tpu/runtime/`: the device collate, the train
step and its loops, the optimizer, trainer state, callbacks and loggers)."""

from .collate import DeviceCorpus, QueryBatch, build_device_corpus, build_lm_inputs, device_collate
from .optim import adamw, decay_mask
from .state import ParameterSchedule, TrainerState
from .train import RealmTrainStep, clip_by_global_norm, make_train_step, training_loop, validation_loop

__all__ = [
    "DeviceCorpus",
    "ParameterSchedule",
    "QueryBatch",
    "RealmTrainStep",
    "TrainerState",
    "adamw",
    "build_device_corpus",
    "build_lm_inputs",
    "clip_by_global_norm",
    "decay_mask",
    "device_collate",
    "make_train_step",
    "training_loop",
    "validation_loop",
]
