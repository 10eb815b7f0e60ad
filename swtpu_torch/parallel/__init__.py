"""Multi-device and multi-process search: the device mesh, lane- and
row-sharded scoring with a collective top-K, query-band sharding on the
kernel's band-carry hand-off, and the database-sharded fleet of processes
(the counterpart of ``swtpu.parallel``)."""

from .distributed import DistributedSearchEngine, initialize  # noqa: F401
from .mesh import DB_AXIS, Mesh, make_mesh, replicate, shard_lanes  # noqa: F401
from .search import ShardedSearchEngine, make_sharded_step  # noqa: F401
