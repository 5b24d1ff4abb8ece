from ganleaks_tpu_torch.ops.lpips.lpips import (  # noqa: F401
    LPIPS,
    LPIPS_SCALE,
    LPIPS_SHIFT,
    default_lpips_params,
    init_lpips_params,
    load_lpips_params,
    lpips_embed,
    lpips_embed_fn,
    lpips_pair,
    normalize_tensor,
    reference_lin_weights,
    save_lpips_params,
)
