from pilotguru.timeseries.interval_average import (  # noqa: F401
    annotate_frames_values,
    time_averaged_values,
)
from pilotguru.timeseries.merge import (  # noqa: F401
    InterpolationPieces,
    make_interpolation_pieces,
    merge_time_series,
    window_piece_slices,
)
from pilotguru.timeseries.smoothing import (  # noqa: F401
    smooth_quaternion_sequence,
    smooth_time_series,
)
