"""Models (port of `vod_tpu/models/`: the retriever encoder and its pooler)."""

from .convert import flax_to_state_dict
from .encoder import DebugEncoder, TransformerEncoder, TransformerEncoderConfig, VodEncoder
from .pooler import VodPooler, VodPoolerConfig

__all__ = [
    "DebugEncoder",
    "TransformerEncoder",
    "TransformerEncoderConfig",
    "VodEncoder",
    "VodPooler",
    "VodPoolerConfig",
    "flax_to_state_dict",
]
