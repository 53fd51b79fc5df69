"""Analysis: feature extraction (SmallCNN, ResNet-18, DenseNet-121, the
diffusion bottleneck, HF and torch callables), the SmallCNN classifier's
training, and FID. Grad-CAM, projections and the dashboard are not ported
yet."""

from superdiff_torch.analysis.features import (  # noqa: F401
    FeatureExtractor, SmallCNN, extract_features, load_classifier,
    save_classifier)
from superdiff_torch.analysis.fid import (  # noqa: F401
    compute_fid, frechet_distance)
