"""The checker across shards: the hash-owned sharded BFS
(``mesh.ShardedEngine``), its spill-composed form whose levels stream
through host RAM (``spill_mesh.SpilledShardedEngine``) and the walker
fleet (``sim_mesh.ShardedSimEngine``), each a single controller over a
list of devices.
"""

from .mesh import ShardedEngine
from .sim_mesh import ShardedSimEngine
from .spill_mesh import SpilledShardedEngine

__all__ = ["ShardedEngine", "ShardedSimEngine", "SpilledShardedEngine"]
