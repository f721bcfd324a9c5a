"""serve3d: novel-view renders from published snapshots (serving slice)."""
from .render import RenderError, RenderRequest, RenderResult, RenderService  # noqa: F401
from .snapshot import Snapshot, SnapshotStore  # noqa: F401
