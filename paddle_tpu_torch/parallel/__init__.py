"""Tensor-parallel serving (counterpart: paddle_tpu/parallel/, the
serving half).

* `partition` — the regex partition rules over the serving params dict
  (`gpt_serving_rules`, `kv_pages_spec`, `kv_scales_spec`), the mesh
  spec parser, the weight bridge that cuts a params dict into one dict a
  rank (`shard_params`, `gather_params`) and the all-reduce volume of a
  sharded step (`collective_bytes`);
* `mesh` — the runtime: a `Mesh` of worker processes over
  `torch.distributed`, one per rank past the controller, built once per
  process and spec by `build_mesh`;
* `pipeline` — the pipeline schedules over a ``pp`` group
  (`pipeline_local`, `pipeline_1f1b_local`, `pipeline_spmd_step`);
* `ring_attention` — sequence parallelism over an ``sp`` group, each
  block on kernel K3 on the card.

Training's rules (`gpt_train_rules`, `gpt_tensor_parallel_rules`) are in
`partition`.  Serving meshes are ``mp=N`` only, as in the JAX package
(which has no serving ``dp`` axis)."""
from .partition import (PartitionSpec, QKV_HEADS, build_mesh,
                        collective_bytes, gather_params, gpt_serving_rules,
                        gpt_tensor_parallel_rules, gpt_train_rules,
                        kv_pages_spec, kv_scales_spec, match_partition_rules,
                        parse_mesh_spec, shard_params, tree_path_names)

__all__ = ["PartitionSpec", "QKV_HEADS", "build_mesh", "collective_bytes",
           "gather_params", "gpt_serving_rules",
           "gpt_tensor_parallel_rules", "gpt_train_rules", "kv_pages_spec",
           "kv_scales_spec", "match_partition_rules", "parse_mesh_spec",
           "shard_params", "tree_path_names"]
