"""Recipe validation, its activation estimate: the port of
modalities_tpu/utils/recipe_validation.py:77-144 (`_estimate_activation_bytes`,
GPT2 family). memscope's static report (telemetry/memscope.py) adds it to a
train step's temp bytes. The rest of the JAX module (`validate_recipe`, the
lowered step) is ROADMAP.md Queue 1 item 6's next part.

`mesh_handle` needs `degrees` (the JAX mesh's degree table) and
`enable_loss_parallel` (the port's `running_env/device_mesh.py:DeviceMesh`);
`step_profile` needs `local_train_micro_batch_size` and `sequence_length`.
"""

from __future__ import annotations


def _estimate_activation_bytes(model, mesh_handle, step_profile) -> dict:
    """Documented per-chip activation estimate for the GPT2LLM family.

    Let b = local microbatch rows, s_l = seq / cp, d_l = n_embd / tp, f_l = ffn / tp,
    act = 2 bytes (bf16 compute). Per layer the live set during backward is:
      - full remat: only the block input residual stream survives the forward
        (b*s_l*d_l) plus ONE block's recompute working set (counted once, not per
        layer): ~ b*s_l*(4*d_l + 3*f_l).
      - no remat: qkv+attn-out+norms+residuals ~ 10*d_l plus swiglu gate/up/act
        ~ 3*f_l per token, all stored for backward.
    Flash/ring attention never materializes the [s, s] score matrix, so no s^2 term.
    The lm head adds b*s_l*vocab/tp fp32 logits UNLESS lm_head_chunk_size caps it at
    b*chunk*vocab/tp.
    """
    spec = getattr(model, "config_spec", None)
    required = ("n_embd", "n_layer", "vocab_size", "activation", "ffn_hidden")
    if spec is None or any(not hasattr(spec, a) for a in required):
        # validating a non-GPT2 recipe (CoCa/ViT/...): state bytes are still exact,
        # but the activation formula is GPT2LLM-specific — report that clearly
        # instead of crashing mid-report with an AttributeError
        return {
            "remat_mode": None,
            "layer_activation_bytes": 0,
            "lm_head_bytes": 0,
            "total": 0,
            "unavailable": (
                f"activation estimate unavailable for model family "
                f"{type(model).__name__}: the formula is GPT2LLM-specific; "
                "per-chip totals below cover params/optimizer/gradients only"
            ),
        }
    degrees = mesh_handle.degrees
    tp = max(1, degrees.get("tp", 1))
    cp = max(1, degrees.get("cp", 1))
    pp = max(1, degrees.get("pp", 1))

    b = step_profile.local_train_micro_batch_size
    s_l = step_profile.sequence_length // cp
    d_l = spec.n_embd // tp
    ffn = spec.swiglu_hidden if spec.activation == "swiglu" else spec.ffn_hidden
    f_l = (ffn or 4 * spec.n_embd) // tp
    n_layer_local = -(-spec.n_layer // pp)
    act = 2  # bf16

    mode = str(getattr(spec, "remat_variant", None) or "none")
    tokens = b * s_l
    if "full" in mode:
        per_layer = tokens * d_l * act
        working_set = tokens * (4 * d_l + 3 * f_l) * act  # one block recompute
        layer_bytes = n_layer_local * per_layer + working_set
    elif "selective" in mode:
        # between full and none; assume half the no-remat live set
        layer_bytes = n_layer_local * tokens * (10 * d_l + 3 * f_l) * act // 2
    else:
        layer_bytes = n_layer_local * tokens * (10 * d_l + 3 * f_l) * act

    chunk = getattr(spec, "lm_head_chunk_size", None)
    vocab_l = spec.vocab_size // tp if mesh_handle.enable_loss_parallel else spec.vocab_size
    head_rows = b * (chunk if chunk else s_l)
    head_bytes = head_rows * vocab_l * 4  # fp32 logits for the live chunk / sequence

    return {
        "remat_mode": mode,
        "layer_activation_bytes": int(layer_bytes),
        "lm_head_bytes": int(head_bytes),
        "total": int(layer_bytes + head_bytes),
    }
