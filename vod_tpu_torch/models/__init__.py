"""Models (port of `vod_tpu/models/`: the retriever encoder with its LoRA
adapters and its pooler, the HF encoder import, kbit quantized-base
training, the causal and seq2seq readers with their decoding, the T5 encoder,
the gradient estimators, the `Ranker`/`Realm`/`Seq2SeqRealm` systems and the
retrieval monitor)."""

from .convert import (
    FlaxLayout,
    flax_layout,
    flax_path,
    flax_to_state_dict,
    kbit_flax_to_state_dict,
    lm_flax_to_state_dict,
    seq2seq_flax_to_state_dict,
    system_flax_to_state_dict,
    t5_flax_to_state_dict,
)
from .encoder import (
    DebugEncoder,
    LoraDense,
    TransformerEncoder,
    TransformerEncoderConfig,
    VodEncoder,
    lora_trainable_mask,
)
from .gradients import (
    DistillationGradients,
    Gradients,
    MarginalLikelihoodGradients,
    RetrievalGradients,
    VodGradients,
)
from .hf_import import config_from_hf, load_hf_encoder, port_bert_weights, port_roberta_weights
from .kbit import (
    KbitParams,
    QuantizedLeaf,
    full_params,
    kbit_materialize,
    kbit_memory_bytes,
    kbit_params,
    kbit_prepare,
    quantize_leaf,
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
    "FlaxLayout",
    "Gradients",
    "KbitParams",
    "LoraDense",
    "MarginalLikelihoodGradients",
    "QuantizedLeaf",
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
    "config_from_hf",
    "filter_logits",
    "flax_layout",
    "flax_path",
    "flax_to_state_dict",
    "full_params",
    "generate",
    "gpt2_config_from_hf",
    "kbit_flax_to_state_dict",
    "kbit_materialize",
    "kbit_memory_bytes",
    "kbit_params",
    "kbit_prepare",
    "lm_flax_to_state_dict",
    "lm_generate",
    "load_hf_causal_lm",
    "load_hf_encoder",
    "lora_trainable_mask",
    "port_bert_weights",
    "port_gpt2_weights",
    "port_roberta_weights",
    "port_t5_encoder_weights",
    "port_t5_seq2seq_weights",
    "quantize_leaf",
    "realm_beam_generate",
    "realm_generate",
    "retrieval_metrics",
    "seq2seq_flax_to_state_dict",
    "system_flax_to_state_dict",
    "t5_config_from_hf",
    "t5_flax_to_state_dict",
]
