"""Single-host multi-device search: the device mesh, lane-sharded scoring
with a collective top-K, and query-band sharding on the kernel's band-carry
hand-off (the counterpart of ``swtpu.parallel``; multi-host is a later
slice)."""

from .mesh import DB_AXIS, Mesh, make_mesh, replicate, shard_lanes  # noqa: F401
from .search import ShardedSearchEngine, make_sharded_step  # noqa: F401
