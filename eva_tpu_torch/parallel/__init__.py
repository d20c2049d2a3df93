"""Multi-device parallelism on torch.distributed: device meshes, sharded
ciphertext batches, digit-parallel key switching and ring-sharded NTTs.

Port of eva_tpu/parallel/ (JAX `Mesh` and `shard_map`). One process per
device: NCCL across cards, gloo across CPU processes. The mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the JAX mesh's axis
names, and every rank runs the same program on its own shard:

  * batch axis  -> independent ciphertexts sharded over ranks
                   (no communication; outputs gathered at the end)
  * limb axis   -> key-switch gadget digits sharded over ranks, the
                   partial inner products summed by a modular
                   all-reduce (ks_shard)
  * host axis   -> a second batch axis spanning nodes; "hlimb" a
                   second digit axis spanning nodes, accumulated by the
                   hierarchical modular all-reduce
  * seq axis    -> the ring axis N of every polynomial sharded, one
                   all-to-all per NTT (ntt_shard, seq_exec)

EVAPublic.execute_batch(compiled, encs, mesh=make_device_mesh(...)) runs
a compiled program on a mesh (backend/executor_torch)."""

from .sharding import (make_device_mesh, shard_batch, batch_axes,
                       batch_pipeline_step, replicated)
from .ks_shard import ShardedKeySwitch
from .ntt_shard import ShardedNTT, get_sharded_ntt
from .seq_exec import SeqLevelOps, get_seq_ops, seq_compatible
