"""The port's kernels (``*_cuda.py`` over ``csrc/``), their plain versions,
and the launch counts their wrappers keep."""


def launch_counts() -> dict[str, int]:
    """Each kernel's launches since :func:`reset_launch_counts`, by kernel:
    the f32 bodies of attention and MaxSim apart from the bf16 ones, so that
    every launch counts under one name."""
    from . import attention_cuda as a, fused_ln_matmul_cuda, layernorm_cuda, maxsim_cuda as m, preprocess_cuda

    return {"fused_attention": a.launches - a.f32_launches, "fused_attention_f32": a.f32_launches,
            "fused_attention_qkv": a.qkv_launches, "preprocess": preprocess_cuda.launches,
            "maxsim": m.launches - m.f32_launches, "maxsim_f32": m.f32_launches,
            "fused_res_norm_matmul": fused_ln_matmul_cuda.launches, "fused_layer_norm": layernorm_cuda.launches}


def reset_launch_counts() -> None:
    """Set every count :func:`launch_counts` reads to 0."""
    from . import attention_cuda as a, fused_ln_matmul_cuda, layernorm_cuda, maxsim_cuda as m, preprocess_cuda

    a.launches = a.qkv_launches = a.f32_launches = 0
    m.launches = m.f32_launches = 0
    preprocess_cuda.launches = fused_ln_matmul_cuda.launches = layernorm_cuda.launches = 0
