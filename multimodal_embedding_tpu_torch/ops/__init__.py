"""The port's kernels (``*_cuda.py`` over ``csrc/``), their plain versions,
and the launch counts their wrappers keep in ``utils/profiling.py:KERNELS``."""

from ..utils.profiling import KERNELS

# Every launch counts under one name: the f32 bodies of attention and MaxSim
# apart from the bf16 ones, the prologue's row pass alone apart from the
# whole prologue; ``grouped_mm`` is the MoE layers' grouped expert product
# (``ops/moe.py``, ``torch._grouped_mm``: a library kernel, counted beside
# the port's own). ``fused_attention_wgmma`` counts again each bf16 attention
# launch (``fused_attention`` or ``fused_attention_qkv``) that ran the
# warpgroup body (``attention_cuda.uses_wgmma``). ``moe_swiglu`` and
# ``moe_combine`` are the DeepSeek decoder's SwiGLU activations and MoE
# combines (``ops/moe_cuda.py``): 53 and 26 a Kimi-VL-A3B forward, 80 and 40
# a Granite-4.0-H-Small one. ``ssm_scan`` is the Granite decoder's state-space
# scan (``ops/ssm_cuda.py``), one a Mamba-2 layer: 36 a forward;
# ``ssm_scan_chunked`` counts again each scan launch that ran the chunked
# body (``ssm_cuda.uses_chunked``: bf16). ``kda_scan`` is the Kimi-Linear
# decoder's KDA recurrence (``ops/kda_cuda.py``), one a KDA layer: 12 a forward
# of the benchmark's 16-layer cut.
LAUNCH_KEYS = ("fused_attention", "fused_attention_f32", "fused_attention_qkv", "preprocess", "maxsim", "maxsim_f32",
               "fused_res_norm_matmul", "fused_layer_norm", "fused_res_norm_rows", "mlp_activation", "grouped_mm",
               "fused_attention_wgmma", "moe_swiglu", "moe_combine", "ssm_scan",
               "ssm_scan_chunked", "kda_scan")


def launch_counts() -> dict[str, int]:
    """Each kernel's launches since :func:`reset_launch_counts`, by kernel."""
    return {k: KERNELS.counts.get(k, 0) for k in LAUNCH_KEYS}


def reset_launch_counts() -> None:
    """Set every count :func:`launch_counts` reads to 0."""
    KERNELS.reset()
