"""The hand-written Hopper kernels and their wrappers. Each wrapper counts its
launches (`<wrapper>.launches`; the CPU path never counts)."""


def launch_counts() -> dict[str, int]:
    """This process's kernel launches by kernel since the counters were last set to 0."""
    from modalities_tpu_torch.ops import flash_attention as fa
    from modalities_tpu_torch.ops import fused_ce as ce
    from modalities_tpu_torch.ops.quant_matmul import quant_matmul
    from modalities_tpu_torch.ops.rmsnorm import rms_norm, rms_norm_backward

    return {"flash_fwd": fa.flash_fwd_out_lse.launches, "flash_dq": fa.flash_bwd_dq.launches,
            "flash_dkv": fa.flash_bwd_dkv.launches, "rms_fwd": rms_norm.launches, "rms_bwd": rms_norm_backward.launches,
            "ce_fwd": ce.fused_ce_forward.launches, "ce_dh": ce.fused_ce_backward_dh.launches,
            "ce_dw": ce.fused_ce_backward_dw.launches, "quant_matmul": quant_matmul.launches}
