from .adamw import (OptConfig, apply_updates, global_norm, init_opt_state,
                    lr_schedule, tree_leaves, tree_map)

__all__ = ["OptConfig", "init_opt_state", "apply_updates", "lr_schedule",
           "global_norm", "tree_leaves", "tree_map"]
