"""The `.pbin` packed-token container: the port's copy of
modalities_tpu/dataloader/packed_data.py (`EmbeddedStreamData`,
`write_pbin_file`), byte-identical to the JAX package's format:

    [ 8 bytes little-endian : data-section length in bytes ]
    [ 4 bytes little-endian : token size in bytes (1|2|4)  ]
    [ data section          : little-endian token ids       ]
    [ pickled index         : list[(offset, length)] byte spans, data-section-relative ]
"""

from __future__ import annotations

import logging
import math
import pickle
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

logger = logging.getLogger(__name__)


class EmbeddedStreamData:
    DATA_SECTION_LENGTH_IN_BYTES = 8
    TOKEN_SIZE_DESCRIPTOR_LENGTH_IN_BYTES = 4
    HEADER_SIZE_IN_BYTES = DATA_SECTION_LENGTH_IN_BYTES + TOKEN_SIZE_DESCRIPTOR_LENGTH_IN_BYTES

    def __init__(self, data_path: Path, load_index: bool = True):
        self._data_path = Path(data_path)
        if not self._data_path.is_file():
            raise FileNotFoundError(f"Packed data was not found at {self._data_path.absolute()}.")
        with self._data_path.open("rb") as f:
            self.data_len = int.from_bytes(f.read(self.DATA_SECTION_LENGTH_IN_BYTES), byteorder="little")
            self.token_size_in_bytes = int.from_bytes(
                f.read(self.TOKEN_SIZE_DESCRIPTOR_LENGTH_IN_BYTES), byteorder="little", signed=False
            )
            self._index_base: Optional[list[tuple[int, int]]] = None
            if load_index:
                f.seek(self.HEADER_SIZE_IN_BYTES + self.data_len)
                self._index_base = pickle.loads(f.read())
        self._data = np.memmap(self._data_path, mode="r", offset=self.HEADER_SIZE_IN_BYTES, shape=(self.data_len,))

    @property
    def index_base(self) -> list[tuple[int, int]]:
        if self._index_base is None:
            raise ValueError("Index was not loaded. Set `load_index=True` during initialization.")
        return self._index_base

    @property
    def data(self) -> np.ndarray:
        return self._data


def token_size_in_bytes_for_vocab(vocab_size: int) -> int:
    """1/2/4-byte token encoding chosen by vocab size."""
    num_bytes = math.ceil(math.log2(vocab_size) / 8)
    if num_bytes in (1, 2):
        return num_bytes
    if num_bytes <= 4:
        return 4
    raise ValueError("Currently only support token byte sizes of 1, 2, and 4.")


def np_dtype_for_token_size(token_size_in_bytes: int) -> np.dtype:
    return {
        1: np.dtype(np.uint8).newbyteorder("<"),
        2: np.dtype(np.uint16).newbyteorder("<"),
        4: np.dtype(np.uint32).newbyteorder("<"),
    }[token_size_in_bytes]


def write_pbin_file(dst_path: Path, token_arrays: Iterable[np.ndarray], token_size_in_bytes: int) -> int:
    """Write a pbin from per-document token-id arrays; returns the document count."""
    dst_path = Path(dst_path)
    dtype = np_dtype_for_token_size(token_size_in_bytes)
    index: list[tuple[int, int]] = []
    with dst_path.open("wb") as f:
        f.write((0).to_bytes(EmbeddedStreamData.DATA_SECTION_LENGTH_IN_BYTES, byteorder="little"))
        f.write(token_size_in_bytes.to_bytes(EmbeddedStreamData.TOKEN_SIZE_DESCRIPTOR_LENGTH_IN_BYTES, "little"))
        offset = 0
        for arr in token_arrays:
            data = np.asarray(arr).astype(dtype).tobytes()
            f.write(data)
            index.append((offset, len(data)))
            offset += len(data)
        f.write(pickle.dumps(index))
    length = index[-1][0] + index[-1][1] if index else 0
    if not index:
        logger.warning("No data was written to %s (empty input).", dst_path)
    with dst_path.open("rb+") as f:  # backfill the data-section length
        f.write(length.to_bytes(EmbeddedStreamData.DATA_SECTION_LENGTH_IN_BYTES, byteorder="little"))
    return len(index)
