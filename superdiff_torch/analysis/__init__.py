"""Analysis: feature extraction (SmallCNN, ResNet-18, DenseNet-121, the
diffusion bottleneck, HF and torch callables), the SmallCNN classifier's
training, FID, latent projections (t-SNE / UMAP / PCA, 2D / 3D,
thumbnails), Grad-CAM, the cross-model comparison and the dashboard; the
JAX package's ``analysis`` exports, and the SmallCNN's own helpers."""

from superdiff_torch.analysis.features import (  # noqa: F401
    FeatureExtractor, SmallCNN, extract_features, load_classifier,
    save_classifier)
from superdiff_torch.analysis.projection import (  # noqa: F401
    run_projection, run_projection_with_thumbnails,
    compare_tsne_umap_thumbnails, run_projection_3d)
from superdiff_torch.analysis.gradcam import (  # noqa: F401
    compute_gradcam, compute_gradcam_from_fns, make_backbone_cam_fns,
    run_gradcam, run_gradcam_backbone)
from superdiff_torch.analysis.fid import (  # noqa: F401
    compute_fid, frechet_distance)
from superdiff_torch.analysis.plotly3d import (  # noqa: F401
    run_plotly_projection_3d_with_thumbnails, thumbnail_data_uri)

__all__ = [
    "FeatureExtractor", "extract_features", "run_projection",
    "run_projection_with_thumbnails", "compare_tsne_umap_thumbnails",
    "run_projection_3d", "compute_gradcam", "compute_gradcam_from_fns",
    "make_backbone_cam_fns", "run_gradcam", "run_gradcam_backbone",
    "frechet_distance", "compute_fid",
    "run_plotly_projection_3d_with_thumbnails", "thumbnail_data_uri",
    "SmallCNN", "load_classifier", "save_classifier",
]
