from repro_torch.optim.adamw import (  # noqa: F401
    adamw_init, adamw_update, clip_scale, cosine_schedule, global_norm,
    global_norm_clip)
