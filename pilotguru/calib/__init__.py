from pilotguru.calib.accelerometer import (  # noqa: F401
    NUM_PARAMS,
    integrate_window,
    replay_windows,
    solve_windows,
    window_loss,
    window_residuals,
)
from pilotguru.calib.corpus import (  # noqa: F401
    CorpusBuckets,
    RideArrays,
    fit_motion_corpus,
)
from pilotguru.calib.fit_motion import (  # noqa: F401
    FitMotionConfig,
    FitMotionResult,
    fit_motion_arrays,
    window_loss_fn,
)
from pilotguru.calib.integrate import (  # noqa: F401
    integrate_motion_debiased,
)
from pilotguru.calib.interpolate import (  # noqa: F401
    InterpolationSettings,
    interpolate_gps_velocities,
)
from pilotguru.calib.pieces import (  # noqa: F401
    RidePieces,
    WindowedProblem,
    build_ride_pieces,
    build_windowed_problem,
)
from pilotguru.calib.rotation_axis import (  # noqa: F401
    angular_velocities_around_axis,
    integrate_rotation_chunks,
    principal_rotation_axes,
    rotations_complementary_to_axis,
)
