"""repro_torch.launch — meshes (:mod:`.mesh`), the sharding rules and
their DTensor placements (:mod:`.sharding`), the training loop
(:mod:`.train`), the serving steps (:mod:`.serve`) and the
pipeline-parallel mode (:mod:`.pipeline_mode`), the HLO analysis and its
counterpart for a traced step (:mod:`.hlo_analysis`), and the dry run
(:mod:`.dryrun`, run as a process: ``python -m
repro_torch.launch.dryrun``)."""

from .mesh import MODEL_AXIS, dp_axes, make_production_mesh, make_test_mesh
from .sharding import (PartitionSpec, cache_pspecs, gather_tree,
                       input_pspecs, opt_pspecs, param_pspecs, place_tree,
                       state_pspecs, to_placements)
from .train import (build_train_step, default_opt_cfg, loss_and_grads,
                    make_train_state, train_loop, train_state_specs)

__all__ = ["make_production_mesh", "make_test_mesh", "dp_axes",
           "MODEL_AXIS", "PartitionSpec", "param_pspecs", "input_pspecs",
           "opt_pspecs", "state_pspecs", "to_placements", "cache_pspecs",
           "place_tree", "gather_tree", "make_train_state",
           "build_train_step", "train_loop", "train_state_specs",
           "default_opt_cfg", "loss_and_grads"]
