"""Diffusion schedules, forward process, samplers and SuperDiff."""

from superdiff_torch.diffusion.samplers import (  # noqa: F401
    ddim_sample, ddpm_sample, dpmpp_sample)
from superdiff_torch.diffusion.schedules import (  # noqa: F401
    DiffusionSchedule, make_schedule)
from superdiff_torch.diffusion.superdiff import superdiff_sample  # noqa: F401
