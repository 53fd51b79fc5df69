"""UNet models, layers and presets."""

from superdiff_torch.models.presets import build_model, model_from_config  # noqa: F401
from superdiff_torch.models.unet import CondUNet  # noqa: F401
from superdiff_torch.models.unet_ref import RefUNet  # noqa: F401
