from expann_tpu_torch.data.dataset import TestDataset
from expann_tpu_torch.data.loader import (
    generate_synthetic_clustered,
    load_sift1m,
    load_sift1m_custom,
    load_synthetic_uniform_sphere_points,
    read_vecs,
)

__all__ = [
    "TestDataset",
    "generate_synthetic_clustered",
    "load_synthetic_uniform_sphere_points",
    "load_sift1m",
    "load_sift1m_custom",
    "read_vecs",
]
