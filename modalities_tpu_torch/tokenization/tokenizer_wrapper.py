"""Tokenizer wrappers: the port's copy of
modalities_tpu/tokenization/tokenizer_wrapper.py (HF tokenizer only).
`transformers` is imported inside the constructor, so importing this module
needs nothing beyond the standard library."""

from __future__ import annotations

import warnings
from typing import Optional


class PreTrainedHFTokenizer:
    """AutoTokenizer wrapper with padding/truncation/max_length and special-token ids."""

    def __init__(
        self,
        pretrained_model_name_or_path: str,
        truncation: Optional[bool] = False,
        padding: Optional[bool | str] = False,
        max_length: Optional[int] = None,
        special_tokens: Optional[dict] = None,
    ) -> None:
        from transformers import AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(pretrained_model_name_or_path=pretrained_model_name_or_path)
        if special_tokens is not None:
            old_vocab_size = len(self.tokenizer.get_vocab())
            self.tokenizer.add_special_tokens(
                special_tokens_dict=special_tokens, replace_additional_special_tokens=False
            )
            if len(self.tokenizer.get_vocab()) > old_vocab_size:
                raise NotImplementedError(
                    "Only tokens already known to the tokenizer's vocabulary can be added "
                    f"(vocab {old_vocab_size} -> {len(self.tokenizer.get_vocab())})"
                )
        self.max_length = max_length
        self.truncation = truncation
        self.padding = padding

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.vocab_size

    def tokenize(self, text: str) -> list[int]:
        return self.tokenizer(
            text, max_length=self.max_length, padding=self.padding, truncation=self.truncation
        )["input_ids"]

    def decode(self, token_ids: list[int]) -> str:
        return self.tokenizer.decode(token_ids)

    def get_token_id(self, token: str) -> int:
        token_id = self.tokenizer.convert_tokens_to_ids(token)
        if token_id is None or not isinstance(token_id, int):
            raise ValueError("Token is not represented by a single token id!")
        if token_id == self.tokenizer.unk_token_id:
            warnings.warn(f"The provided token {token} has the same token id ({token_id}) as the unk token")
        return token_id
