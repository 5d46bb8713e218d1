from repro_torch.optim.adamw import (OptConfig, adamw_init,  # noqa: F401
                                     adamw_update, cosine_lr, global_norm)
