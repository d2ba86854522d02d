"""See the counterpart package `vsrcic_tpu.parallel`: data parallelism, here
over `torch.distributed` with one process per device (`launch.run`)."""
from vsrcic_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh, make_mesh, replicate, shard_batch)
from vsrcic_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_beam_search_v, sharded_greedy)
