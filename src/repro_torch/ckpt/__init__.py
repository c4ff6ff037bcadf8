from repro_torch.ckpt.checkpoint import (CheckpointManager,
                                        flatten_with_paths)
from repro_torch.ckpt.quantized import (PackedCkptError, load_packed_ckpt,
                                       pack_tree, policy_extra,
                                       restore_policy, save_packed_ckpt,
                                       strip_for_serving, to_host,
                                       tree_bytes, unpack_tree)

__all__ = ["CheckpointManager", "PackedCkptError", "flatten_with_paths",
           "load_packed_ckpt", "pack_tree", "policy_extra",
           "restore_policy", "save_packed_ckpt", "strip_for_serving",
           "to_host", "tree_bytes", "unpack_tree"]
