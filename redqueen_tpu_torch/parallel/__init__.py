"""Distributed execution of the port on ``torch.distributed``: collectives
that are the identity outside a bound mesh axis (``comm``), the
component batch split over ranks (``shard``), the run across processes
(``multihost``), the lane layer's bucketed ragged dispatch and slab
auto-tuning (``lanes``), and the follower star engine (``bigf``), whose
feeds split over a ``"feed"`` axis."""

from .comm import (  # noqa: F401
    axis_total,
    make_mesh,
    pany,
    pmax,
    pmin,
    psum,
    replicate,
    shard_leading,
)
from .shard import simulate_sharded  # noqa: F401
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
