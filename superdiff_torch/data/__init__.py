"""Device-side batch preparation and the synthetic data generator. The
dataset index, splits, the datamodule and the native loader are not ported
yet."""

from superdiff_torch.data.synthetic import synthetic_xray_batch  # noqa: F401
from superdiff_torch.data.transforms import (  # noqa: F401
    augment, denormalize, normalize, prepare_batch)
