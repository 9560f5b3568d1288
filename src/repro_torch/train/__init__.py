from .optimizer import (Optimizer, adamw, apply_updates, clip_by_global_norm,
                        cosine_schedule, global_norm, optimizer_state_bytes)
from .loop import (InjectedFailure, StragglerMonitor, Trainer, make_loss_fn,
                   make_train_step)
