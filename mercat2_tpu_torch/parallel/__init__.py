"""Sharded counting over a host's cards, and the multi-host run.

Port of ``mercat2_tpu.parallel`` (MerCat2's Ray fan-out and the dict
merge after it, bin/mercat2.py:86-137, 217, as a device mesh):

- ``mesh``: a mesh is a list of ``torch.device``s, one a shard; a device
  may repeat. One process drives every card of its host.
- ``count``: the (k-1)-halo stream sharding, the dense histogram summed
  over shards, and the distributed sort-count: per-shard key build and
  sort, sample-based splitter agreement, one key-range exchange of copies
  between the shards' devices, then a re-sort and the finalize kernel per
  shard. The concatenated per-shard tables ARE the sorted, filtered table.
- ``dist``: the multi-host run over a gloo ``torch.distributed`` group
  (barriers only), and the deterministic file share of each host.

The JAX package's block-cyclic layout (``shard_stream_blocks``) has no
counterpart: it existed for the fixed-shape exchange, which the port's
variable-size segments replace.
"""

from mercat2_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from mercat2_tpu_torch.parallel.count import (
    flat_mesh,
    shard_stream,
    sharded_count_sources,
    sharded_count_streams,
    sharded_dense_histogram,
)

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "flat_mesh",
    "shard_stream",
    "sharded_count_sources",
    "sharded_count_streams",
    "sharded_dense_histogram",
]
