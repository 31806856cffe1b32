"""Lane layer and star engine of the port: bucketed ragged dispatch and
slab auto-tuning (``lanes``), and the follower star engine (``bigf``).
Meshes wait for ROADMAP.md Queue 1 item 6."""

from .bigf import (  # noqa: F401
    CtrlParams,
    StarBuilder,
    StarConfig,
    StarResult,
    WallParams,
    broadcast_star,
    simulate_star,
    simulate_star_batch,
    stack_star,
    star_to_dataframe,
)
from .lanes import (  # noqa: F401
    measured_slab,
    plan_buckets,
    simulate_ragged,
    simulate_slabbed,
)
