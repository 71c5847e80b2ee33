"""Models (port of `vod_tpu/models/`: the retriever encoder and its pooler, the
reader, the gradient estimators, the `Ranker`/`Realm` systems and the
retrieval monitor)."""

from .convert import flax_path, flax_to_state_dict, lm_flax_to_state_dict, system_flax_to_state_dict
from .encoder import DebugEncoder, TransformerEncoder, TransformerEncoderConfig, VodEncoder
from .gradients import (
    DistillationGradients,
    Gradients,
    MarginalLikelihoodGradients,
    RetrievalGradients,
    VodGradients,
)
from .lm import CausalLM, CausalLMConfig
from .monitoring import RetrievalMonitor, retrieval_metrics
from .pooler import VodPooler, VodPoolerConfig
from .systems import Ranker, Realm

__all__ = [
    "CausalLM",
    "CausalLMConfig",
    "DebugEncoder",
    "DistillationGradients",
    "Gradients",
    "MarginalLikelihoodGradients",
    "Ranker",
    "Realm",
    "RetrievalGradients",
    "RetrievalMonitor",
    "TransformerEncoder",
    "TransformerEncoderConfig",
    "VodEncoder",
    "VodGradients",
    "VodPooler",
    "VodPoolerConfig",
    "flax_path",
    "flax_to_state_dict",
    "lm_flax_to_state_dict",
    "retrieval_metrics",
    "system_flax_to_state_dict",
]
