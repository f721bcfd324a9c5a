"""Test-only runtime hooks (fault injection): the port's copy of
`repro.testing`.  See `repro_torch.testing.faults` for the contract."""
from . import faults  # noqa: F401
