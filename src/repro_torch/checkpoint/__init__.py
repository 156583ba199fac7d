from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    AsyncCheckpointer, host_tree, latest_step, restore, save)
