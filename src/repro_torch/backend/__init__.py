"""Backend execution layer: lanes, the autotune profile, padding helpers."""
from repro_torch.backend.padding import (  # noqa: F401
    np_log2, np_pow2ceil, pad1, pad_to, pow2_bucket, pow2ceil,
)
from repro_torch.backend.policy import (  # noqa: F401
    LANE_HOPPER, LANE_REF, LANES, OPS, ExecutionPolicy, default_policy,
)
from repro_torch.backend.profile import (  # noqa: F401
    DEFAULT_PROFILE, PROFILE_VERSION, AutotuneProfile,
)
