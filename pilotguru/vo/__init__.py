from pilotguru.vo.camera import (  # noqa: F401
    CameraSettings,
    read_camera_settings,
    write_camera_settings,
)
from pilotguru.vo.flatten import (  # noqa: F401
    flatten_trajectory,
    plane_is_valid,
    project_directions,
    project_translations,
    trajectory_pca,
    turn_angles_from_directions,
)
from pilotguru.vo.tracking import (  # noqa: F401
    LOST,
    NOT_INITIALIZED,
    OK,
    CameraModel,
    MonocularTracker,
    TrackerConfig,
)
