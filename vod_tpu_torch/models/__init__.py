"""Models (port of `vod_tpu/models/`: the retriever encoder and its pooler, the
causal and seq2seq readers with their decoding, the T5 encoder, the gradient
estimators, the `Ranker`/`Realm`/`Seq2SeqRealm` systems and the retrieval
monitor)."""

from .convert import (
    flax_path,
    flax_to_state_dict,
    lm_flax_to_state_dict,
    seq2seq_flax_to_state_dict,
    system_flax_to_state_dict,
    t5_flax_to_state_dict,
)
from .encoder import DebugEncoder, TransformerEncoder, TransformerEncoderConfig, VodEncoder
from .gradients import (
    DistillationGradients,
    Gradients,
    MarginalLikelihoodGradients,
    RetrievalGradients,
    VodGradients,
)
from .lm import CausalLM, CausalLMConfig, gpt2_config_from_hf, lm_generate, load_hf_causal_lm, port_gpt2_weights
from .monitoring import RetrievalMonitor, retrieval_metrics
from .pooler import VodPooler, VodPoolerConfig
from .seq2seq import (
    Seq2SeqLM,
    Seq2SeqRealm,
    beam_generate,
    compact_answer_segment,
    filter_logits,
    generate,
    port_t5_seq2seq_weights,
    realm_beam_generate,
    realm_generate,
)
from .systems import Ranker, Realm
from .t5_encoder import T5Encoder, T5EncoderConfig, VodT5Encoder, port_t5_encoder_weights, t5_config_from_hf

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
    "Seq2SeqLM",
    "Seq2SeqRealm",
    "T5Encoder",
    "T5EncoderConfig",
    "TransformerEncoder",
    "TransformerEncoderConfig",
    "VodEncoder",
    "VodGradients",
    "VodPooler",
    "VodPoolerConfig",
    "VodT5Encoder",
    "beam_generate",
    "compact_answer_segment",
    "filter_logits",
    "flax_path",
    "flax_to_state_dict",
    "generate",
    "gpt2_config_from_hf",
    "lm_flax_to_state_dict",
    "lm_generate",
    "load_hf_causal_lm",
    "port_gpt2_weights",
    "port_t5_encoder_weights",
    "port_t5_seq2seq_weights",
    "realm_beam_generate",
    "realm_generate",
    "retrieval_metrics",
    "seq2seq_flax_to_state_dict",
    "system_flax_to_state_dict",
    "t5_config_from_hf",
    "t5_flax_to_state_dict",
]
