"""The versioned KV handoff record, the only thing that crosses the
prefill -> decode tier boundary: the port of
modalities_tpu/serving/disagg/handoff.py, whose digest and wire it keeps
byte for byte.

A record carries what the decode tier needs to continue a request as if it
had prefilled it itself:

- `payload`: the request's pool blocks in the JAX pool layout, one CPU
  tensor a cache leaf in the JAX tree-flatten order (K, V; int8 pools: K, K
  scales, V, V scales), each [n_blocks, layers, block_size, kv_heads,
  head_dim | 1]. Block i covers positions [i * block_size, (i + 1) *
  block_size); physical pool ids never cross. int8 pools ship their int8
  data and float32 scales verbatim. bf16 blocks are carried as their raw
  16-bit words under the dtype name "bfloat16" (numpy has no bfloat16 and
  the card's host has no ml_dtypes), so the digest and the wire are those of
  the JAX record with the same fields and bytes.
- the sampler: `temperature`, the remaining decode budget (the admission
  clamp applied) and `key`. JAX ships the Threefry key after the first-token
  draw; the port samples from a per-request torch.Generator, so a sampled
  record carries that generator's state after the first draw (its
  `get_state()` bytes as uint32 words: 4 for the card's Philox generator,
  1264 for the CPU's MT19937), and the digest covers it. A greedy request
  never draws, so its sampler state is its seed: the record carries the
  unsplit key PRNGKey(seed) = [seed >> 32, seed & 0xffffffff], the key a
  JAX prefill tier ships for the same greedy request. A decode tier refuses
  a sampled record whose key is not its own generator's state
  (`sampler_mismatch`): a JAX record sampled at temperature > 0 cannot
  continue on a torch generator.
- `last_token`, the first generated token: the decode tier feeds it next.
- `generation`, the weights generation the KV was computed under: a decode
  tier refuses another generation's KV (`generation_mismatch`).
- `digest`: sha256 over the payload bytes and the fields that change what
  the decode tier generates, checked at import (`digest_mismatch`).
"""

from __future__ import annotations

import base64
import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

HANDOFF_VERSION = 1

# payload dtypes by their numpy name (the JAX record's `str(arr.dtype)`)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16, "int8": torch.int8}
_NAMES = {v: k for k, v in _DTYPES.items()}


class HandoffRejected(Exception):
    """An import-side validation failure. `reason` is the
    `disagg_handoff_failures_total` label (digest_mismatch,
    generation_mismatch, version_mismatch, config_mismatch, malformed,
    sampler_mismatch)."""

    def __init__(self, reason: str, detail: str):
        super().__init__(detail)
        self.reason = reason
        self.detail = detail


def dtype_name(t: torch.Tensor) -> str:
    return _NAMES[t.dtype]


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The tensor's raw bytes, C order (bf16: its 16-bit words)."""
    t = t.detach().contiguous().cpu()
    return t.view(torch.uint8).numpy().tobytes() if t.numel() else b""


def tensor_from_bytes(data: bytes, name: str, shape) -> torch.Tensor:
    if name not in _DTYPES:
        raise ValueError(f"unknown payload dtype {name!r}")
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data else torch.empty(0, dtype=torch.uint8)
    return raw.view(_DTYPES[name]).reshape([int(d) for d in shape])


def greedy_key(seed: int) -> np.ndarray:
    """JAX's PRNGKey(seed): the key a greedy request keeps unsplit."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def generator_key(generator: torch.Generator) -> np.ndarray:
    """A torch generator's state as uint32 words (its state bytes are a
    multiple of 4 on the CPU and on the card)."""
    return generator.get_state().numpy().view(np.uint32).copy()


def restore_generator(generator: torch.Generator, key: np.ndarray) -> None:
    generator.set_state(torch.from_numpy(np.ascontiguousarray(key, dtype=np.uint32).view(np.uint8).copy()))


@dataclass
class HandoffRecord:
    """One prefilled request, packaged for the decode tier (the module
    docstring gives the fields' meaning)."""

    version: int
    generation: int
    quant_kv: str  # "none" | "int8": must match the importing pool
    block_size: int
    window: list[int]  # the admitted prompt window (positions [0, len) resident)
    last_token: int  # the first generated token, fed by the decode tier next
    key: np.ndarray  # uint32 sampler state after the first-token draw
    temperature: float
    remaining: int  # decode budget left (the admission clamp applied)
    seed: int
    payload: list[torch.Tensor]  # per cache leaf: [n_blocks, *block_row], on the CPU
    digest: str = ""
    trace_id: str = ""
    trace_hop: int = 0
    rid: int = -1  # the prefill side's rid (diagnostics only)
    prompt_len: int = 0  # the prompt's length before truncation
    truncated: bool = False
    # outside the digest, like the trace id: the deadline re-anchors to the
    # decode tier's arrival clock, the tenant changes scheduling only
    deadline_ms: Optional[float] = None
    tenant: str = ""

    @property
    def kv_bytes(self) -> int:
        """Bytes shipped across the tier boundary (payload only)."""
        return int(sum(t.numel() * t.element_size() for t in self.payload))

    @property
    def num_blocks(self) -> int:
        return int(self.payload[0].shape[0]) if self.payload else 0

    def compute_digest(self) -> str:
        """sha256 over the payload bytes and every field that changes what the
        decode tier generates; each leaf's dtype and shape are folded in, so
        a layout mix-up fails as loudly as a flipped byte."""
        h = hashlib.sha256()
        h.update(repr((self.version, self.generation, self.quant_kv, self.block_size,
                       tuple(int(t) for t in self.window), int(self.last_token), float(self.temperature),
                       int(self.remaining), int(self.seed))).encode())
        h.update(np.ascontiguousarray(self.key, dtype=np.uint32).tobytes())
        for t in self.payload:
            h.update(dtype_name(t).encode())
            h.update(repr(tuple(int(d) for d in t.shape)).encode())
            h.update(tensor_bytes(t))
        return h.hexdigest()

    def seal(self) -> "HandoffRecord":
        self.digest = self.compute_digest()
        return self

    def verify_digest(self) -> None:
        got = self.compute_digest()
        if got != self.digest:
            raise HandoffRejected("digest_mismatch",
                                  f"handoff payload digest {got[:12]}... != sealed {self.digest[:12]}...")

    def to_wire(self) -> dict:
        """JSON-safe dict (payload leaves as base64 + dtype + shape) for the
        HTTP legs; the in-process pair hands records over by reference."""
        return {
            "version": self.version,
            "generation": self.generation,
            "quant_kv": self.quant_kv,
            "block_size": self.block_size,
            "window": [int(t) for t in self.window],
            "last_token": int(self.last_token),
            "key": [int(v) for v in np.asarray(self.key, dtype=np.uint32).ravel()],
            "temperature": float(self.temperature),
            "remaining": int(self.remaining),
            "seed": int(self.seed),
            "digest": self.digest,
            "trace_id": self.trace_id,
            "trace_hop": int(self.trace_hop),
            "rid": int(self.rid),
            "prompt_len": int(self.prompt_len),
            "truncated": bool(self.truncated),
            "deadline_ms": self.deadline_ms,
            "tenant": self.tenant,
            "payload": [{"dtype": dtype_name(t), "shape": [int(d) for d in t.shape],
                         "data": base64.b64encode(tensor_bytes(t)).decode("ascii")} for t in self.payload],
        }

    @classmethod
    def from_wire(cls, wire: dict) -> "HandoffRecord":
        try:
            payload = [tensor_from_bytes(base64.b64decode(leaf["data"]), leaf["dtype"], leaf["shape"])
                       for leaf in wire["payload"]]
            return cls(
                version=int(wire["version"]),
                generation=int(wire["generation"]),
                quant_kv=str(wire["quant_kv"]),
                block_size=int(wire["block_size"]),
                window=[int(t) for t in wire["window"]],
                last_token=int(wire["last_token"]),
                key=np.asarray(wire["key"], dtype=np.uint32),
                temperature=float(wire["temperature"]),
                remaining=int(wire["remaining"]),
                seed=int(wire.get("seed") or 0),
                payload=payload,
                digest=str(wire.get("digest") or ""),
                trace_id=str(wire.get("trace_id") or ""),
                trace_hop=int(wire.get("trace_hop") or 0),
                rid=int(wire.get("rid", -1)),
                prompt_len=int(wire.get("prompt_len") or 0),
                truncated=bool(wire.get("truncated", False)),
                deadline_ms=float(wire["deadline_ms"]) if wire.get("deadline_ms") else None,
                tenant=str(wire.get("tenant") or ""),
            )
        except (KeyError, TypeError, ValueError, RuntimeError) as exc:
            raise HandoffRejected("malformed", f"unreadable handoff record: {type(exc).__name__}: {exc}") from exc
