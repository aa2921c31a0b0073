"""Tensor parallelism in one process, on the CPU (the plain versions of the
kernels):

- `tp_in_process` (parallel/tensor_parallel.py) drives the tp ranks of one
  GPT2 block through the block's own modules on each rank's shards; the
  output and every weight gradient equal the unsharded block's (f32, 1e-5:
  the same sums in another order);
- `fused_ce_in_process` (parallel/vocab_parallel_ce.py) runs the fused CE
  on vocab shards and combines them; lse, corr, dh and dW equal the
  whole-vocabulary plain versions (1e-5), with labels on the shards'
  boundaries and ignored rows, for shards that are no multiple of the
  kernels' 64-column tile;
- loss parallelism's cross entropy (`vocab_parallel_sum_and_count`) and the
  fused head on a 1-rank group equal the unsharded losses and gradients;
- the `gpt2_llama3_like` init (nn/llama3_initialization.py): its groups by
  parameter name, its truncation bounds, its per-layer std (statistics at a
  seed, beside the JAX initializer's on the JAX model of the same shape) and
  its structural errors. That its values do not depend on the tp degree is
  checked on a tp-2 world in tests/test_torch_checkpointing_tp.py."""

import math

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from modalities_tpu.nn.model_initialization.llama3_initialization import Llama3Initializer as JaxLlama3
from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM
from modalities_tpu_torch.nn.llama3_initialization import Llama3Initializer
from modalities_tpu_torch.ops import fused_ce as fce
from modalities_tpu_torch.parallel import tensor_parallel as tp_mod
from modalities_tpu_torch.parallel import vocab_parallel_ce as vce
from modalities_tpu_torch.running_env import env
from tests.models.test_gpt2_model import tiny_gpt2
from tests.test_torch_gpt2 import port_config

TOL = dict(atol=1e-5, rtol=1e-5)


def _block(**overrides):
    model = GPT2LLM(**port_config(attention_implementation="dao_flash", use_weight_tying=False, **overrides))
    model.with_spec_updates(compute_dtype="float32")
    module = model.build_train_module(model.init_train_params(torch.Generator().manual_seed(3)))
    return module, module.blocks[0]


@pytest.mark.parametrize("tp,gelu,bias", [(2, False, False), (2, True, False), (2, False, True), (2, True, True)],
                         ids=["swiglu-tp2", "gelu-tp2", "swiglu-bias-tp2", "gelu-bias-tp2"])
def test_tp_in_process_equals_the_unsharded_block(tp, gelu, bias):
    module, block = _block(**({"activation_type": "gelu"} if gelu else {}), bias=bias)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():  # biases drawn away from their zero init: one added per rank would move the output
        for name, p in block.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    x = torch.randn(2, 32, 128, generator=g)
    dy = torch.randn(2, 32, 128, generator=g)
    cos, sin = module._rope_tables(32)
    x_whole = x.clone().requires_grad_()
    want = block.train_forward(x_whole, cos, sin)
    want.backward(dy)
    x_tp = x.clone().requires_grad_()
    got, ranks = tp_mod.tp_in_process(block, x_tp, cos, sin, tp)
    got.backward(dy)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **TOL)
    np.testing.assert_allclose(x_tp.grad.numpy(), x_whole.grad.numpy(), **TOL)
    grads = tp_mod.gather_rank_grads(block, ranks)
    for name, p in block.named_parameters():
        np.testing.assert_allclose(grads[name].numpy(), p.grad.numpy(), err_msg=name, **TOL)
    heads = ranks[0].attn.q_attn.kernel.shape[1] // module.spec.head_dim
    assert heads == module.spec.n_head_q // tp  # each rank's own heads


def test_the_plan_shards_what_the_jax_rules_put_on_tp():
    swiglu = GPT2LLM(**port_config()).config_spec
    gelu = GPT2LLM(**port_config(activation_type="gelu")).config_spec
    assert [tp_mod.shard_dim(swiglu, n) for n in ("attn.q_attn.kernel", "attn.k_attn.kernel", "attn.v_attn.kernel",
                                                  "mlp.W.kernel", "mlp.V.kernel")] == [1, 1, 1, 1, 1]
    assert [tp_mod.shard_dim(gelu, n) for n in ("mlp.c_fc.kernel", "mlp.c_fc.bias", "mlp.c_proj.kernel")] == [1, 0, 0]
    assert [tp_mod.shard_dim(swiglu, n) for n in ("attn.c_proj.kernel", "mlp.W_2.kernel", "attention_norm.scale",
                                                  "ffn_norm.scale", "attn.q_norm.scale")] == [0, 0, None, None, None]
    with pytest.raises(ValueError, match="n_head_kv"):
        tp_mod.check_divisible(GPT2LLM(**port_config(n_head_kv=1)).config_spec, 2)


@pytest.mark.parametrize("n,v,e,tp", [(37, 200, 32, 4), (64, 256, 16, 2), (10, 96, 8, 3)])
def test_the_fused_ce_on_vocab_shards_equals_the_whole_vocabulary(n, v, e, tp):
    g = torch.Generator().manual_seed(n)
    h = torch.randn(n, e, generator=g)
    w = torch.randn(v, e, generator=g) * 0.3
    shard = v // tp
    labels = torch.randint(0, v, (n,), generator=g)
    labels[:6] = torch.tensor([0, shard - 1, shard, v - 1, 2 * shard - 1, -100])  # shard boundaries, one ignored
    gm = torch.rand(n, generator=g) * (labels != -100).float()
    lse_want, corr_want = fce.reference_fused_ce_forward(h, w, labels)
    dh_want, dw_want = fce.reference_fused_ce_backward(h, w, labels, lse_want, gm)
    lse, corr, dh, dw = vce.fused_ce_in_process(h, w, labels, tp, gm)
    for got, want in ((lse, lse_want), (corr, corr_want), (dh, dh_want), (dw, dw_want)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_loss_parallelism_and_the_vocab_sharded_head_on_one_rank_equal_the_unsharded_losses():
    g = torch.Generator().manual_seed(9)
    logits = torch.randn(24, 40, generator=g, requires_grad=True)
    h = torch.randn(24, 16, generator=g, requires_grad=True)
    w = torch.randn(40, 16, generator=g, requires_grad=True)
    labels = torch.randint(0, 40, (24,), generator=g)
    labels[3] = -100
    with env.process_group(torch.device("cpu")):
        group = torch.distributed.group.WORLD
        total, count = vce.vocab_parallel_sum_and_count(logits, labels, group)
        total.backward()
        d_logits = logits.grad.clone()
        fused_total, fused_count = vce.vocab_parallel_fused_sum_and_count(h, w, labels, group)
        fused_total.backward()
    logits.grad = None
    want = F.cross_entropy(logits, labels, ignore_index=-100, reduction="sum")
    want.backward()
    np.testing.assert_allclose(total.item(), want.item(), **TOL)
    np.testing.assert_allclose(d_logits.numpy(), logits.grad.numpy(), **TOL)
    assert count.item() == fused_count.item() == 23
    h2, w2 = h.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    plain_total, _ = fce.plain_sum_and_count(h2, w2, labels)
    plain_total.backward()
    np.testing.assert_allclose(fused_total.item(), plain_total.item(), **TOL)
    np.testing.assert_allclose(h.grad.numpy(), h2.grad.numpy(), **TOL)
    np.testing.assert_allclose(w.grad.numpy(), w2.grad.numpy(), **TOL)


# ------------------------------------------------------------- gpt2_llama3_like


def _llama3_model(n_layer=4, **overrides):
    model = GPT2LLM(**port_config(use_weight_tying=False, n_layer=n_layer, **overrides))
    model.update_train_spec(init_routines=(Llama3Initializer(num_layers=n_layer, n_embd=128, depth_init=True),))
    return model


def test_the_llama3_groups_by_parameter_name():
    init = Llama3Initializer(num_layers=4, n_embd=128)
    groups = {"wte": "embedding", "lm_head.kernel": "lm_head", "blocks.0.attn.q_attn.kernel": "qkv",
              "blocks.3.attn.k_attn.kernel": "qkv", "blocks.1.attn.v_attn.kernel": "qkv",
              "blocks.2.attn.c_proj.kernel": "attn_out", "blocks.0.mlp.W.kernel": "mlp_in",
              "blocks.0.mlp.V.kernel": "mlp_scaled", "blocks.1.mlp.W_2.kernel": "mlp_scaled",
              "blocks.0.attention_norm.scale": None, "lm_head_norm.scale": None}
    assert {name: init.group_of(name) for name in groups} == groups


def test_the_llama3_truncation_bounds_and_per_layer_std_match_the_jax_initializer():
    layers = 4
    params = _llama3_model(layers).init_train_params(torch.Generator().manual_seed(0))
    jax_model = tiny_gpt2("manual", use_weight_tying=False, n_layer=layers)
    jax_params = JaxLlama3(num_layers=layers, n_embd=128, depth_init=True).initialize_in_place(
        jax_model.init_params(jax.random.PRNGKey(0)), jax.random.PRNGKey(1))
    jax_flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(jax_params)[0]}

    def jax_leaf(suffix, layer=None):
        leaf = next(v for k, v in jax_flat.items() if k.removesuffix("/.value").endswith(suffix))
        return leaf if layer is None else leaf[layer]

    assert params["wte"].std().item() == pytest.approx(1.0, rel=0.03)
    s = 1 / math.sqrt(128)
    head = params["lm_head.kernel"]
    assert head.abs().max().item() <= 3 * s and head.std().item() == pytest.approx(0.9866 * s, rel=0.03)
    assert head.std().item() == pytest.approx(float(jax_leaf("lm_head/kernel").std()), rel=0.05)
    for layer in range(layers):
        std_l = 0.02 / math.sqrt(2 * (layer + 1))
        for name, suffix in (("attn.c_proj", "attn/c_proj/kernel"), ("mlp.V", "mlp/V/kernel"),
                             ("mlp.W_2", "mlp/W_2/kernel")):
            t = params[f"blocks.{layer}.{name}.kernel"]
            assert t.std().item() == pytest.approx(std_l, rel=0.05), (layer, name)
            assert t.std().item() == pytest.approx(float(jax_leaf(suffix, layer).std()), rel=0.06), (layer, name)
        for name in ("attn.q_attn", "attn.k_attn", "attn.v_attn", "mlp.W"):
            t = params[f"blocks.{layer}.{name}.kernel"]
            assert t.abs().max().item() <= 2.0 and t.std().item() == pytest.approx(0.02, rel=0.05)
    assert torch.equal(params["blocks.0.attention_norm.scale"], torch.ones(128))  # the default init stays
    flat = Llama3Initializer(num_layers=layers, n_embd=128, depth_init=False)
    assert flat.std_and_bounds("blocks.3.mlp.W_2.kernel") == (0.02 / math.sqrt(2 * layers), -2.0, 2.0)


def test_the_llama3_truncation_holds_at_its_bounds():
    init = Llama3Initializer(num_layers=1, n_embd=4)  # lm_head std 0.5, bounds +-1.5
    t = init.draw("lm_head.kernel", (200_000,), torch.Generator().manual_seed(1))
    assert t.abs().max().item() <= 1.5 and t.abs().max().item() > 1.45


@pytest.mark.parametrize("overrides,match", [
    (dict(bias=True), "Bias initialization"),
    (dict(activation_type="gelu"), "did not match any parameter"),
    (dict(use_weight_tying=True), "'lm_head'"),
], ids=["bias", "gelu-mlp", "tied-head"])
def test_the_llama3_structural_errors(overrides, match):
    model = GPT2LLM(**port_config(**{"use_weight_tying": False, **overrides}))
    model.update_train_spec(init_routines=(Llama3Initializer(num_layers=2, n_embd=128),))
    with pytest.raises(ValueError, match=match):
        model.init_train_params(torch.Generator().manual_seed(0))


def test_a_parameter_in_two_llama3_groups_is_refused(monkeypatch):
    from modalities_tpu_torch.nn import llama3_initialization as l3

    monkeypatch.setitem(l3.GROUPS, "twice", r"\.attn\.q_attn\.kernel$")
    with pytest.raises(ValueError, match="matched multiple init groups"):
        Llama3Initializer(num_layers=2, n_embd=128).validate(["blocks.0.attn.q_attn.kernel"])


def test_serving_a_tensor_parallel_module_is_refused():
    module, _ = _block()
    module.set_tensor_parallel(tp_mod.TensorParallel(group=None))
    cache = module.init_slot_cache(1, 16)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        module.prefill_slot(cache, torch.zeros(1, 4, dtype=torch.long), 0, 0)


def test_the_serve_path_refuses_a_tp_mesh():
    from modalities_tpu_torch.running_env.device_mesh import DeviceMesh
    from modalities_tpu_torch.serving.serve import ServingComponent

    mesh = DeviceMesh(world_size=2, data_parallel_shard_degree=1, tensor_parallel_degree=2)
    with pytest.raises(NotImplementedError, match=r"device_mesh.*Queue 1 item 3"):
        ServingComponent(GPT2LLM(**port_config()), None, device_mesh=mesh)
