from pilotguru.parallel.mesh import (  # noqa: F401
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_leading_axis,
)
