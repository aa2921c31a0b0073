"""Datasets over packed `.pbin` token streams: the port's copy of
`PackedMemMapDatasetBase` and `PackedMemMapDatasetContinuous` from
modalities_tpu/dataloader/dataset.py. Samples are dicts of numpy arrays keyed
by `sample_key`; tensors are made per batch by the trainer.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from modalities_tpu_torch.config.config import check_bool, check_int, check_str
from modalities_tpu_torch.dataloader.packed_data import EmbeddedStreamData, np_dtype_for_token_size


@dataclasses.dataclass
class PackedMemMapDatasetContinuousConfig:
    raw_data_path: Path
    sequence_length: int
    sample_key: str
    reuse_last_target: bool = True

    def __post_init__(self):
        self.raw_data_path = Path(self.raw_data_path)
        check_int("sequence_length", self.sequence_length, ge=2)
        check_str("sample_key", self.sample_key)
        check_bool("reuse_last_target", self.reuse_last_target)


class PackedMemMapDatasetBase:
    """memmap view over a pbin data section; decodes (offset, len) byte spans."""

    type_converter_for_ram = {1: np.int32, 2: np.int32, 4: np.int64}

    def __init__(self, raw_data_path: Path, sample_key: str, load_index: bool = True):
        self.raw_data_path = raw_data_path
        self.sample_key = sample_key
        self._embedded_stream_data = EmbeddedStreamData(raw_data_path, load_index=load_index)
        self._token_size_in_bytes = self._embedded_stream_data.token_size_in_bytes
        if self._token_size_in_bytes not in self.type_converter_for_ram:
            raise RuntimeError(f"only 1/2/4-byte tokens are decodable, got {self._token_size_in_bytes}")
        self._token_dtype_on_disk = np_dtype_for_token_size(self._token_size_in_bytes)
        self._token_dtype_in_ram = self.type_converter_for_ram[self._token_size_in_bytes]
        self._index = self._generate_packing_index()

    @property
    def token_size_in_bytes(self) -> int:
        return self._token_size_in_bytes

    def _generate_packing_index(self):
        return self._embedded_stream_data.index_base

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int) -> dict:
        byte_off, byte_len = self._index[idx]
        tokens = np.frombuffer(
            buffer=self._embedded_stream_data.data,
            dtype=self._token_dtype_on_disk,
            count=int(byte_len) // self._token_size_in_bytes,
            offset=int(byte_off),
        ).astype(self._token_dtype_in_ram)
        return {self.sample_key: tokens}


class PackedMemMapDatasetContinuous(PackedMemMapDatasetBase):
    """block_size-token windows computed arithmetically; `reuse_last_target`
    overlaps consecutive samples by one token (pretraining)."""

    def __init__(self, raw_data_path: Path, sample_key: str, block_size: int, reuse_last_target: bool,
                 load_index: bool = False):
        self.block_size = block_size
        self.reuse_last_target = reuse_last_target
        super().__init__(raw_data_path=raw_data_path, sample_key=sample_key, load_index=load_index)

    @staticmethod
    def _create_packed_index(total_tokens: int, block_size: int, token_size_in_bytes: int,
                             reuse_last_target: bool) -> np.ndarray:
        if reuse_last_target:
            num_samples = (total_tokens - block_size) // (block_size - 1) + 1
            i = np.arange(num_samples)
            starts = (i * block_size - i) * token_size_in_bytes
        else:
            num_samples = total_tokens // block_size
            i = np.arange(num_samples)
            starts = (i * block_size) * token_size_in_bytes
        lengths = np.full(num_samples, block_size * token_size_in_bytes)
        return np.stack((starts, lengths), axis=1)

    def _generate_packing_index(self):
        total_tokens = self._embedded_stream_data.data_len // self._token_size_in_bytes
        if total_tokens < self.block_size:
            raise ValueError(
                f"Cannot pack: the dataset holds only {total_tokens} tokens, fewer than one block of "
                f"block_size={self.block_size}."
            )
        if self.block_size < 2:
            raise ValueError(f"block_size={self.block_size} is too small: a sample needs an input and a target")
        return self._create_packed_index(total_tokens, self.block_size, self._token_size_in_bytes,
                                         self.reuse_last_target)


def get_packed_mem_map_dataset_continuous(raw_data_path: Path, sequence_length: int, sample_key: str,
                                          reuse_last_target: bool = True) -> PackedMemMapDatasetContinuous:
    """The `packed_mem_map_dataset_continuous` component: with
    reuse_last_target a block is sequence_length inputs plus the shifted
    target; otherwise blocks are disjoint (JAX dataset_factory.py:47-60)."""
    block_size = sequence_length + 1 if reuse_last_target else sequence_length
    return PackedMemMapDatasetContinuous(Path(raw_data_path), sample_key, block_size=block_size,
                                         reuse_last_target=reuse_last_target)
