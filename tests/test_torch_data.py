"""Port parity for the data pipeline: the port's pbin writer, dataset,
samplers, batch sampler, collator and loader (modalities_tpu_torch/dataloader)
against the JAX package's, on the same files. Exact equality: the same bytes
and the same token ids (numpy PCG64 orders both samplers)."""

import numpy as np
import pytest

from modalities_tpu.dataloader.dataloader import LLMDataLoader as JaxLoader
from modalities_tpu.dataloader.dataset_factory import DatasetFactory
from modalities_tpu.dataloader.packed_data import EmbeddedStreamData as JaxStream
from modalities_tpu.dataloader.packed_data import write_pbin_file as jax_write_pbin_file
from modalities_tpu.dataloader.samplers import BatchSampler as JaxBatchSampler
from modalities_tpu.dataloader.samplers import ResumableDistributedSampler as JaxSampler
from modalities_tpu.models.gpt2.collator import GPT2LLMCollateFn as JaxCollate
from modalities_tpu_torch.dataloader.dataloader import GPT2LLMCollateFn, LLMDataLoader
from modalities_tpu_torch.dataloader.dataset import get_packed_mem_map_dataset_continuous
from modalities_tpu_torch.dataloader.packed_data import EmbeddedStreamData, write_pbin_file
from modalities_tpu_torch.dataloader.samplers import (
    create_batch_sampler,
    create_resumable_distributed_multi_dim_sampler,
)
from modalities_tpu_torch.running_env.device_mesh import DeviceMesh


def _docs(seed, vocab, n_docs=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(5, 300))) for _ in range(n_docs)]


@pytest.mark.parametrize("token_size,vocab", [(1, 250), (2, 50304), (4, 100_000)])
def test_the_writer_gives_byte_identical_files(tmp_path, token_size, vocab):
    docs = _docs(token_size, vocab)
    assert write_pbin_file(tmp_path / "port.pbin", docs, token_size) == jax_write_pbin_file(
        tmp_path / "jax.pbin", iter(docs), token_size)
    assert (tmp_path / "port.pbin").read_bytes() == (tmp_path / "jax.pbin").read_bytes()
    ours, theirs = EmbeddedStreamData(tmp_path / "jax.pbin"), JaxStream(tmp_path / "jax.pbin")
    assert (ours.data_len, ours.token_size_in_bytes, ours.index_base) == (
        theirs.data_len, theirs.token_size_in_bytes, theirs.index_base)


@pytest.mark.parametrize("reuse_last_target", [True, False])
@pytest.mark.parametrize("skip", [0, 6])
def test_pipeline_gives_the_jax_batches(tmp_path, reuse_last_target, skip):
    """A pbin from JAX's writer through dataset -> sampler (shuffle, seed 42)
    -> batch sampler -> GPT2 collator -> loader, in both packages."""
    path = tmp_path / "corpus.pbin"
    jax_write_pbin_file(path, iter(_docs(3, 50304, n_docs=12)), 2)
    seq, mbs = 16, 3
    ours = get_packed_mem_map_dataset_continuous(path, seq, "input_ids", reuse_last_target)
    theirs = DatasetFactory.get_packed_mem_map_dataset_continuous(path, seq, "input_ids", reuse_last_target)
    assert len(ours) == len(theirs) > 10
    sampler = create_resumable_distributed_multi_dim_sampler(ours, DeviceMesh(world_size=1), shuffle=True, seed=42,
                                                             skip_num_global_samples=skip)
    port_loader = LLMDataLoader("train", ours, create_batch_sampler(sampler, mbs),
                                GPT2LLMCollateFn("input_ids", "target_ids"))
    jax_sampler = JaxSampler(theirs, rank=0, num_replicas=1, shuffle=True, seed=42, drop_last=True,
                             skip_num_global_samples=skip)
    jax_loader = JaxLoader("train", theirs, JaxBatchSampler(jax_sampler, mbs, drop_last=True),
                           JaxCollate("input_ids", "target_ids"))
    got, want = list(port_loader), list(jax_loader)
    assert len(got) == len(want) == len(port_loader) > 1
    for a, b in zip(got, want):
        for side in ("samples", "targets"):
            (key, x), (key2, y) = *getattr(a, side).items(), *getattr(b, side).items()
            width = seq if reuse_last_target else seq - 1  # disjoint blocks of seq tokens, shifted by one
            assert key == key2 and x.shape == (mbs, width) and x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
