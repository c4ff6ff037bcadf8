"""Distribution over `torch.distributed` (port of `repro.dist`): the
Gram all-reduce of data-parallel calibration, the column-sharded solve,
the compressed all-reduce, the mesh helpers and the SPMD process world.

Mesh mechanics only: the math stays in `core/` and the models see a
process group only where MoE routing must count tokens globally
(`BuildPlan.moe_group`).
"""
from repro_torch.dist.calibrate import (calib_mesh, data_mesh,  # noqa: F401
                                        gather_columns, model_size,
                                        reduce_batched_gram, reduce_gram,
                                        set_allreduce_observer, shard_batch,
                                        sharded_batched_gram, sharded_gram,
                                        sharded_solve)
from repro_torch.dist.collectives import (all_reduce_gram,  # noqa: F401
                                          compressed_all_reduce,
                                          init_error_state)
from repro_torch.dist.sharding import (axis_group, axis_rank,  # noqa: F401
                                       axis_size, column_slice, dp_size,
                                       mesh_shape, paged_layout, tp_size)
from repro_torch.dist.world import (close_world, init_world,  # noqa: F401
                                    is_rank0, rank_device)
