"""Multi-device parallel layer: mesh sharding over genomes, pairs, and
sequence chunks (device-mesh replacement of the reference's OpenCilk
work-stealing layer, SURVEY.md §2.1)."""
from .mesh import (COL_AXIS, ROW_AXIS, data_spec, make_mesh, pad_to_multiple,
                   replicated)
from .allpairs import sharded_all_pairs_fn, sharded_ani_fn
from .sketch import pack_genome_batch, sharded_sketch_fn
from .allpairs import mesh_all_pairs_packed
from .sequence import (sequence_parallel_sketch_compact_fn,
                       sequence_parallel_sketch_fn)
from .distributed import (global_mesh, init_distributed, local_batch_rows,
                          process_shard)

__all__ = [
    "COL_AXIS", "ROW_AXIS", "data_spec", "make_mesh", "pad_to_multiple",
    "replicated", "sharded_all_pairs_fn", "sharded_ani_fn",
    "pack_genome_batch", "sharded_sketch_fn", "sequence_parallel_sketch_fn",
    "sequence_parallel_sketch_compact_fn", "mesh_all_pairs_packed",
    "global_mesh", "init_distributed", "local_batch_rows", "process_shard",
]
