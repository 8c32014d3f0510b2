from .loop import add_batch_sample, run_offline_eval  # noqa: F401
from .metrics import NuScenesDetectionEvaluator  # noqa: F401
from .results import format_nusc_submission, velocity_attribute  # noqa: F401
