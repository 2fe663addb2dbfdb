from pilotguru.solvers.gradient_descent import gradient_descent  # noqa: F401
from pilotguru.solvers.levenberg_marquardt import (  # noqa: F401
    LMResult,
    batched_levenberg_marquardt,
    levenberg_marquardt,
)
