"""The data layer: the folder-tree index and batch iterators, the splitter,
the native shard loader, the host decode / resize / CLAHE, the device-side
batch preparation, the datamodule and the synthetic data generator."""

from superdiff_torch.data.synthetic import synthetic_xray_batch  # noqa: F401
from superdiff_torch.data.dataset import (  # noqa: F401
    BatchIterator, ChestXrayIndex)
from superdiff_torch.data.split import (  # noqa: F401
    is_split_already_done, split_dataset)
from superdiff_torch.data.transforms import (  # noqa: F401
    augment, clahe, denormalize, host_resize, normalize, prepare_batch)
from superdiff_torch.data.datamodule import DataModule  # noqa: F401
