from pilotguru.video.io import VideoWriterRgb, read_video_rgb  # noqa: F401
from pilotguru.video.render import (  # noqa: F401
    MotionRenderer,
    load_per_frame_series,
    render_frame_number,
    render_steering,
    render_velocity,
)
