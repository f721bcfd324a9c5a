"""Procedural scenes with analytic ground truth, the ray sampler, and the
LM substrate's synthetic token streams."""
from .synthetic_scene import SceneParams, SceneDataset, make_scene, build_dataset  # noqa: F401
from .rays_dataset import RaySampler  # noqa: F401
from .lm_data import LMStreamConfig, SyntheticLMStream  # noqa: F401
