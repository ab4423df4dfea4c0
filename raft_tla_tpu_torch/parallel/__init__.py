"""The checker across shards: the hash-owned sharded BFS
(``mesh.ShardedEngine``) and the walker fleet (``sim_mesh.
ShardedSimEngine``), each a single controller over a list of devices.
"""

from .mesh import ShardedEngine
from .sim_mesh import ShardedSimEngine

__all__ = ["ShardedEngine", "ShardedSimEngine"]
