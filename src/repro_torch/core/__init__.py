"""Instant-3D's decomposed hash-grid radiance field, in PyTorch: the
package-level names of `repro.core`."""
from .encoding import HashEncoding, HashGridConfig, sh_encoding, sh_dim  # noqa: F401
from .field import Field, FieldConfig, trunc_exp  # noqa: F401
from .rendering import RenderConfig, RayBatch, render_rays, sample_ts, pixel_rays, sphere_poses  # noqa: F401
from .pipeline import RenderPipeline, suggest_budget  # noqa: F401
from .trainer import Instant3DTrainer, TrainerConfig, TrainState, train_cohort  # noqa: F401
from . import losses, occupancy  # noqa: F401
