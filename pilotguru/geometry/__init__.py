from pilotguru.geometry.quaternion import (  # noqa: F401
    quat_conjugate,
    quat_cumulative_product,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_rotation_matrix,
    rotation_rate_to_quat,
)
from pilotguru.geometry.strapdown import (  # noqa: F401
    StrapdownResult,
    integrate_motion,
)
