"""repro_torch.launch — the training driver (:mod:`.train`).  ``repro``'s
mesh, sharding, dry-run and serve launchers come with the mesh slice."""

from .train import (build_train_step, default_opt_cfg, loss_and_grads,
                    make_train_state, train_loop, train_state_specs)

__all__ = ["make_train_state", "build_train_step", "train_loop",
           "train_state_specs", "default_opt_cfg", "loss_and_grads"]
