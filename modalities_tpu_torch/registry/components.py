"""The port's component catalog: the entities this slice builds (the JAX
catalog is modalities_tpu/registry/components.py). `inference_component.serve`
is added by serving/serve.py, as the JAX package does."""

from modalities_tpu_torch.config.config import PreTrainedHFTokenizerConfig
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM, GPT2LLMConfig
from modalities_tpu_torch.registry.registry import ComponentEntity
from modalities_tpu_torch.tokenization.tokenizer_wrapper import PreTrainedHFTokenizer

COMPONENTS = [
    ComponentEntity("model", "gpt2", GPT2LLM, GPT2LLMConfig),
    ComponentEntity("tokenizer", "pretrained_hf_tokenizer", PreTrainedHFTokenizer, PreTrainedHFTokenizerConfig),
]
