"""serve3d: the multi-scene reconstruction service on one card -- scene
sessions trained in cohorts and time slices, a divergence guard with
rollback, atomic (optionally persisted) snapshots, and batched novel-view
renders served from them while training goes on."""
from .session import (  # noqa: F401
    SceneSession, PENDING, ACTIVE, SUSPENDED, DONE, QUARANTINED,
)
from .scheduler import SessionScheduler  # noqa: F401
from .snapshot import Snapshot, SnapshotStore  # noqa: F401
from .render import (  # noqa: F401
    RenderError, RenderRequest, RenderResult, RenderService,
    batched_render_fn, batched_redistributed_render_fn,
)
from .guard import GuardConfig, SessionGuard  # noqa: F401
from .service import ReconstructionService  # noqa: F401
