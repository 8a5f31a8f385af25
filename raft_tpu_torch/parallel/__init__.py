"""The sharded engine: ``ShardedBFS`` over ``torch.distributed`` (one
process per shard, ``sharded.py``), its owner route (``route.py``, the
``owner_route`` kernel) and the launch of its ranks (``launch.py``)."""

from .sharded import ShardedBFS, ShardedResult

__all__ = ["ShardedBFS", "ShardedResult"]
