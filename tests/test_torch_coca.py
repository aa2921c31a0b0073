"""Port parity for the multimodal models (modalities_tpu_torch/nn/attention.py,
nn/mlp.py, models/vision_transformer, models/coca, `NCELoss`, the dummy
dataset, the CoCa collator) against the JAX package, at
configs/config_example_coca_tpu.yaml's own widths (ViT 2 x 64 over 32 x 32
images in patches of 8; text 2 + 2 layers x 64, vocab 512, 16 tokens; head
dim 32). The JAX modules run as they run on the CPU (attention through XLA's
SDPA); the port runs its plain attention. Inputs and weights are numpy from a
seed, all in f32: the weights fill the JAX tree's own shapes
(`jax.eval_shape` of its init) and are carried across with `params_from_jax`
(by flax path). JAX's initializers are not what is compared, and jitting
them costs several seconds of XLA compile a model on the CPU.

Tolerances: forwards atol 1e-5 (logits 1e-4, as the GPT2 parity tests: fp32
sums in other orders, measured ~1e-6); one train step's loss, grad norm, lr
and parameters 1e-5 (as tests/test_torch_train_step.py). The dummy dataset
and the collator are equal element for element.

Last, `run` over the config cut to world 1 (its token target to 8 steps of
one rank's 4 x 16 tokens, its paths into the test's folder) trains 8 steps
in this process: every logged train loss within 0.05 of ln 512, the JAX e2e
test's oracle (tests/end2end_tests/test_warmstart_e2e.py:85-95), a
checkpoint folder at step 8 and the eval's rows."""

import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from modalities_tpu.checkpointing.stateful.app_state import AppState
from modalities_tpu.dataloader.dataset import DummyDataset as JaxDummyDataset
from modalities_tpu.dataloader.dataset import DummyDatasetConfig as JaxDummyDatasetConfig
from modalities_tpu.loss_functions import CLMCrossEntropyLoss as JaxLoss
from modalities_tpu.loss_functions import NCELoss as JaxNCELoss
from modalities_tpu.models.coca.coca_model import AttentionPooling as JaxAttentionPooling
from modalities_tpu.models.coca.coca_model import CoCa as JaxCoCa
from modalities_tpu.models.coca.coca_model import CoCaCollateFn as JaxCoCaCollateFn
from modalities_tpu.models.vision_transformer.vision_transformer_model import VisionTransformer as JaxViT
from modalities_tpu.nn.attention import AttentionType as JaxAttentionType
from modalities_tpu.nn.attention import MultiHeadAttention as JaxMultiHeadAttention
from modalities_tpu.nn.mlp import MLP as JaxMLP
from modalities_tpu.optimizers.optimizer_factory import OptimizerFactory as JaxOptimizers
from modalities_tpu.optimizers.optimizer_factory import build_weight_decay_mask
from modalities_tpu.training.gradient_clipping import GradientClipper as JaxClipper
from modalities_tpu.training.train_step import TrainStepBuilder
from modalities_tpu_torch.config.config import validate_config
from modalities_tpu_torch.conversion.from_jax import params_by_path, params_from_jax
from modalities_tpu_torch.dataloader.dataset import DummyDatasetConfig, get_dummy_dataset
from modalities_tpu_torch.loss_functions import CLMCrossEntropyLoss, NCELoss
from modalities_tpu_torch.main import Main
from modalities_tpu_torch.models.coca.coca_model import AttentionPooling, CoCa, CoCaCollateFn
from modalities_tpu_torch.models.gpt2.gpt2_model import MixedPrecisionSpec
from modalities_tpu_torch.models.model import jax_param_path
from modalities_tpu_torch.models.vision_transformer.vision_transformer_model import VisionTransformer
from modalities_tpu_torch.nn.attention import AttentionType, MultiHeadAttention
from modalities_tpu_torch.nn.mlp import MLP
from modalities_tpu_torch.ops.static_walk import kernel_work, walking
from modalities_tpu_torch.optimizers.optimizer_factory import OptimizerFactory, weight_decay_mask
from modalities_tpu_torch.training.gradient_clipping import GradientClipper
from modalities_tpu_torch.training.train_step import TrainStep

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "config_example_coca_tpu.yaml"
ATOL = 1e-5
TOL = dict(atol=1e-5, rtol=1e-5)
# eps 1e-6, not the config's 1e-8: the attention's k bias has an exact gradient of 0 (a softmax row does not
# move when a constant is added to its scores) and a few other elements have gradients near 1e-9, so Adam's
# first step g / (|g| + eps) turns the two frameworks' rounding noise in g into updates of up to lr at eps 1e-8
# (measured: 2.3e-5 apart after one step); at 1e-6 that noise stays under 1e-7 of a parameter
OPT = dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-6, weight_decay=0.1, weight_decay_groups_excluded=["embedding", "norm"])
B = 4  # the config's local_train_micro_batch_size


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread for these tests: the config's tiny model
    runs thousands of small ops, and on torch's default of one thread a core
    they spin against a `-n 6` run's other xdist workers (six copies of the
    `run` test at once on 8 cores: 190 s each, 7 s on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config_model_node() -> dict:
    """The config's `model_raw` node with its three references resolved."""
    node = yaml.safe_load(CONFIG.read_text())["model_raw"]["config"]
    node["prediction_key"] = "logits"
    node["text_decoder_config"].update(sample_key="input_ids", prediction_key="logits", block_size=16)
    node["epsilon_attn_pool"] = float(node["epsilon_attn_pool"])
    return node


def _numpy_params(abstract, seed: int):
    """A JAX parameter tree of `abstract`'s shapes drawn from numpy: the
    norms' scales 1 + N(0, 0.1), every other leaf N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        mean, std = (1.0, 0.1) if getattr(path[-1], "key", None) == "scale" else (0.0, 0.02)
        return (mean + std * rng.standard_normal(leaf.shape)).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, abstract)


def _port_layer(module, jax_params) -> torch.nn.Module:
    shapes = {k: v.shape for k, v in module.state_dict().items()}
    module.load_state_dict(params_by_path(jax.tree.map(np.asarray, jax_params), shapes, jax_param_path))
    return module.eval()


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0, err_msg=what)


def _inputs(seed: int, b: int = B, vocab: int = 512):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            "input_ids": rng.integers(0, vocab, size=(b, 16)).astype(np.int32)}


@pytest.fixture(scope="module")
def coca():
    """The JAX CoCa of the config and its train step (AdamW at OPT, 2
    microbatches, clipping at 1.0) from numpy weights, the weights, and the
    port's model with them."""
    node = _config_model_node()
    jax_model = JaxCoCa(**node)
    builder = TrainStepBuilder(model=jax_model, loss_fn=JaxLoss("target_ids", "logits"),
                               optimizer_spec=JaxOptimizers.get_adam_w(wrapped_model=jax_model, **OPT),
                               gradient_acc_steps=2, grad_clip_norm=1.0, grad_clipper=JaxClipper(max_norm=1.0))
    fns = builder.build(seed=0, materialize=False)  # the step's state stays abstract: its shapes
    params = _numpy_params(fns.app_state_handle.state.params, 0)
    jax_params = jax.tree.map(jax.numpy.asarray, params)  # copies: the jitted step donates its state
    opt_state = jax.jit(fns.app_state_handle.tx.init)(jax_params)
    step = jax.numpy.zeros((), jax.numpy.int32)
    fns.app_state_handle.state = AppState(params=jax_params, opt_state=opt_state, step=step)
    model = CoCa(**node)
    return jax_model, fns, params, model, params_from_jax(params, model)


@pytest.mark.parametrize("kind,sq,sk", [("causal_self_attention", 17, 17), ("non_causal_self_attention", 16, 16),
                                        ("cross_attention", 5, 16), ("cross_attention", 16, 4)])
def test_multi_head_attention_matches_the_jax_module(kind, sq, sk):
    rng = np.random.default_rng(sq * 100 + sk)
    x = rng.standard_normal((B, sq, 64)).astype(np.float32)
    context = rng.standard_normal((B, sk, 64)).astype(np.float32) if kind == "cross_attention" else None
    jax_module = JaxMultiHeadAttention(n_embd=64, n_head=2, attention_type=JaxAttentionType(kind))
    params = _numpy_params(jax.eval_shape(jax_module.init, jax.random.PRNGKey(1), x, context), sq * 100 + sk)
    want = jax.jit(jax_module.apply)(params, x, context)
    port = _port_layer(MultiHeadAttention(64, 2, attention_type=AttentionType(kind)), params)
    got = port(torch.from_numpy(x), None if context is None else torch.from_numpy(context))
    _close(got, want, what=kind)


def test_mlp_matches_the_jax_module():
    x = np.random.default_rng(2).standard_normal((B, 16, 64)).astype(np.float32)
    jax_module = JaxMLP(in_features=64, hidden_features=128)
    params = _numpy_params(jax.eval_shape(jax_module.init, jax.random.PRNGKey(2), x), 2)
    _close(_port_layer(MLP(64, 128), params)(torch.from_numpy(x)), jax.jit(jax_module.apply)(params, x))


def test_attention_pooling_matches_the_jax_module():
    rng = np.random.default_rng(3)
    queries = rng.standard_normal((B, 5, 64)).astype(np.float32)
    context = rng.standard_normal((B, 16, 64)).astype(np.float32)
    jax_module = JaxAttentionPooling(n_embd=64, n_head=2, bias=False, epsilon=1e-5)
    params = _numpy_params(jax.eval_shape(jax_module.init, jax.random.PRNGKey(3), queries, context), 3)
    port = _port_layer(AttentionPooling(64, 2, False, 1e-5), params)
    assert port.ln_1.bias is None and port.attn.q_attn.bias is not None  # `bias` governs the norms alone
    want = jax.jit(jax_module.apply)(params, queries, context)
    _close(port(torch.from_numpy(queries), torch.from_numpy(context)), want)


@pytest.mark.parametrize("n_classes,add_cls_token,stride", [(10, True, 8), (10, False, 8), (None, False, 8),
                                                           (None, True, 6)],
                         ids=["classify-cls", "classify-mean", "encoder", "encoder-overlapping-patches"])
def test_the_vit_matches_the_jax_model(n_classes, add_cls_token, stride):
    node = dict(_config_model_node()["vision_encoder_config"], n_classes=n_classes, add_cls_token=add_cls_token,
                prediction_key="logits", ffn_hidden=128, patch_stride=stride)
    grid = (32 - 8) // stride + 1  # VALID: 4 at stride 8, 5 at 6 (the last 2 rows and columns fall outside)
    jax_model, model = JaxViT(**node), VisionTransformer(**node)
    params = _numpy_params(jax.eval_shape(jax_model.init_params, jax.random.PRNGKey(4)), 4)
    images = _inputs(5)["images"]
    want = jax.jit(jax_model.apply)(params, {"images": images})["logits"]
    got = model.build_module(params_from_jax(params, model))({"images":
                                                                                        torch.from_numpy(images)})
    assert got["logits"].shape == ((B, n_classes) if n_classes else (B, grid * grid + add_cls_token, 64))
    _close(got["logits"], want)
    assert model.block_size == VisionTransformer.get_block_size((32, 32), 8, stride, add_cls_token) == (
        grid * grid + add_cls_token)


def test_the_coca_forward_matches_the_jax_model(coca):
    jax_model, _, params, model, state = coca
    inputs = _inputs(6)
    want = jax.jit(jax_model.apply)(params, inputs)
    got = model.build_module(state)({k: torch.from_numpy(v) for k, v in inputs.items()})
    assert set(got) == set(want) == {"logits", "vision_cls", "text_cls"}
    assert got["logits"].dtype == torch.float32 and got["logits"].shape == (B, 16, 512)
    _close(got["logits"], want["logits"], atol=1e-4, what="logits")
    for key in ("vision_cls", "text_cls"):
        assert got[key].shape == (B, 64)
        _close(got[key], want[key], what=key)


@pytest.mark.parametrize("asymmetric,temperature", [(True, 1.0), (False, 0.5)])
def test_nce_loss_matches_the_jax_loss(asymmetric, temperature):
    rng = np.random.default_rng(7)
    preds = {"vision_cls": rng.standard_normal((8, 64)).astype(np.float32),
             "text_cls": rng.standard_normal((8, 64)).astype(np.float32)}
    want = jax.jit(JaxNCELoss("vision_cls", "text_cls", is_asymmetric=asymmetric, temperature=temperature))(preds, {})
    got = NCELoss("vision_cls", "text_cls", is_asymmetric=asymmetric, temperature=temperature)(
        {k: torch.from_numpy(v) for k, v in preds.items()}, {})
    assert abs(float(got) - float(want)) <= ATOL


def test_the_collator_and_the_dummy_dataset_match_the_jax_ones():
    node = yaml.safe_load(CONFIG.read_text())["train_dataset"]["config"]
    node["num_samples"] = 6
    jax_dataset = JaxDummyDataset(**dict(JaxDummyDatasetConfig(**node)))
    dataset = get_dummy_dataset(**vars(validate_config(DummyDatasetConfig, node)))
    assert len(dataset) == len(jax_dataset) == 6
    np.random.seed(11)
    want = [jax_dataset[i] for i in range(6)]
    np.random.seed(11)
    got = [dataset[i] for i in range(6)]
    for w, g in zip(want, got):
        assert set(w) == set(g) == {"images", "input_ids"}
        for key in w:
            assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key
    keys = dict(sample_keys=["images", "input_ids"], target_keys=[], text_sample_key="input_ids",
                text_target_key="target_ids")
    jax_batch, batch = JaxCoCaCollateFn(**keys)(want), CoCaCollateFn(**keys)(got)
    for part in ("samples", "targets"):
        mine, theirs = getattr(batch, part), getattr(jax_batch, part)
        assert set(mine) == set(theirs)
        for key in mine:
            assert np.array_equal(mine[key], np.asarray(theirs[key])), (part, key)
    assert batch.samples["input_ids"].shape == (6, 16) and batch.targets["target_ids"].shape == (6, 16)


def test_the_weight_decay_masks_are_the_jax_ones(coca):
    jax_model, _, params, model, _ = coca
    mask = build_weight_decay_mask(params, jax_model, OPT["weight_decay_groups_excluded"])
    as_arrays = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params)
    want = {k: bool(v.reshape(-1)[0]) for k, v in params_from_jax(as_arrays, model).items()}
    got = weight_decay_mask([model.jax_param_path(n) for n in want], model.weight_decay_groups,
                            OPT["weight_decay_groups_excluded"])
    assert list(got.values()) == list(want.values())
    assert not any(want[n] for n in ("wte", "vision_queries", "text_block.0.ln_1.scale", "mm_ln_f.bias",
                                     "vision_encoder.embedding_fn.conv.kernel", "vision_encoder.blocks.1.norm2.scale"))
    assert want["multimodal_block.1.cross_attn.k_attn.kernel"] and want["vision_encoder.blocks.0.mlp.fc1.bias"]


def test_one_coca_train_step_matches_the_jax_step(coca):
    """One optimizer step of 2 microbatches: AdamW with decay on the kernels
    only, clipping at 1.0, the CLM loss on the logits."""
    _, fns, _, model, state = coca
    jax_state = fns.app_state_handle.state
    model.update_train_spec(mixed_precision=MixedPrecisionSpec("float32", "float32", "float32"))
    step = TrainStep(model, CLMCrossEntropyLoss("target_ids", "logits"), OptimizerFactory.get_adam_w(
        wrapped_model=model, **OPT), device="cpu", gradient_acc_steps=2, grad_clipper=GradientClipper(max_norm=1.0),
        params={k: v.clone() for k, v in state.items()})
    rng = np.random.default_rng(8)
    text = rng.integers(0, 512, size=(2, B, 17)).astype(np.int32)
    batch = {"samples": {"images": rng.standard_normal((2, B, 32, 32, 3)).astype(np.float32),
                         "input_ids": text[..., :-1]}, "targets": {"target_ids": text[..., 1:]}}
    jax_state, jm = fns.train_step(jax_state, fns.put_batch(batch))
    pm = step({k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), err_msg=key, **TOL)
    assert abs(float(jm["loss"]) - math.log(512)) < 0.05
    want = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, jax_state.params), model).items()}
    got = {k: v.detach().numpy() for k, v in step.state_dict().items()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **TOL)


def test_the_static_walk_records_the_coca_and_vit_attention_shapes(coca):
    """The flash stand-ins (ops/static_walk.py) record each attention of a
    CoCa step at its shapes (Sq != Sk and the causal ones), and a head dim of
    96 (the ViT's 768 / 8) passes the kernels' shape check, each call priced
    by `kernel_work` (causal pairs counted from position 0, as the kernels
    mask)."""
    calls = []

    class Recorder:
        def custom_call(self, name, flops, nbytes, what="", tensor_cores=True):
            calls.append((name, what, flops, nbytes, tensor_cores))

    *_, model, state = coca
    module = model.build_train_module({k: v.clone() for k, v in state.items()})
    with walking(Recorder()):
        out = module({k: torch.from_numpy(v) for k, v in _inputs(9).items()})
        out["logits"].sum().backward()
    seen = {(name, what) for name, what, *_ in calls}
    shapes = {"q[4, 2, 16, 32] k[4, 2, 16, 32]", "q[4, 2, 5, 32] k[4, 2, 16, 32]", "q[4, 2, 17, 32] k[4, 2, 17, 32]",
              "q[4, 2, 16, 32] k[4, 2, 4, 32]"}
    assert seen == {(name, what) for name in ("flash_fwd", "flash_dq", "flash_dkv") for what in shapes}
    assert len(calls) == 3 * (2 + 1 + 2 + 2 * 2)  # ViT, pooling, text, multimodal self and cross: fwd, dq, dkv each
    assert ("flash_fwd", "q[4, 2, 17, 32] k[4, 2, 17, 32]", *kernel_work(
        "flash_fwd", b=4, hq=2, hkv=2, sq=17, sk=17, d=32, el=4, causal=True), False) in calls
    vit = VisionTransformer(sample_key="images", prediction_key="logits", img_size=32, n_layer=1, n_embd=192,
                            n_head=2, patch_size=8, patch_stride=8, ffn_hidden=64)
    calls.clear()
    with walking(Recorder()):
        vit.build_module(vit.init_params(torch.Generator().manual_seed(0)))({"images": torch.zeros(2, 32, 32, 3)})
    assert [(name, what) for name, what, *_ in calls] == [("flash_fwd", "q[2, 2, 17, 96] k[2, 2, 17, 96]")]


def _coca_run_config(tmp_path: Path) -> Path:
    cfg = yaml.safe_load(CONFIG.read_text())
    cfg["settings"]["paths"].update(checkpoint_saving_path=str(tmp_path / "checkpoints"),
                                    experiments_root_path=str(tmp_path / "experiments"))
    cfg["device_mesh"]["config"].update(data_parallel_shard_degree=1, world_size=1)
    cfg["settings"]["training_target"]["num_target_tokens"] = 8 * 4 * 16
    path = tmp_path / "coca.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def test_run_trains_the_coca_config_on_one_rank(tmp_path, capsys):
    np.random.seed(0)  # the dummy dataset draws from numpy's global generator
    results = Main(_coca_run_config(tmp_path), device="cpu").run()
    logged = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[train] step")]
    assert logged and logged[-1].startswith("[train] step 8:")
    rows = [json.loads(line) for path in (tmp_path / "experiments").rglob("evaluation_results.jsonl")
            for line in path.read_text().splitlines()]
    train = [r for r in rows if r["dataloader_tag"] == "train"]
    val = [r for r in rows if r["dataloader_tag"] == "val"]
    assert [r["num_train_steps_done"] for r in train] == [2, 4, 6, 8] and len(results) >= 4
    losses = [r["losses"]["train loss avg"] for r in train]
    assert all(abs(loss - math.log(512)) < 0.05 for loss in losses), losses
    assert val and all(abs(r["losses"]["loss avg"] - math.log(512)) < 0.1 for r in val)
    info = json.loads((tmp_path / "checkpoints" / "last_checkpoint_info.json").read_text())
    assert "-seen_steps_8-" in info["checkpoint_folder_path"] and Path(info["checkpoint_folder_path"]).is_dir()


def test_a_misspelled_settings_key_still_fails_at_load(tmp_path):
    """Only the `settings` blocks that TrainingSettings does not declare and
    the config's own references read (`coca_example_settings`) are taken out
    before the strict schema; any other unknown key is refused."""
    cfg = yaml.safe_load(_coca_run_config(tmp_path).read_text())
    cfg["settings"]["debuging"] = {}
    path = tmp_path / "misspelled.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    main = Main(path, device="cpu")
    assert "settings.coca_example_settings.train_num_samples" in main.references
    with pytest.raises(ValueError, match=r"Invalid keys \['debuging'\] for config TrainingSettings"):
        main.build_components()
