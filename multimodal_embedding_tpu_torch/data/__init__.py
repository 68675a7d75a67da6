from .captions import get_all_captions, caps_per_image
from .synthetic import synthetic_retrieval_dataset
from .coco import load_benchmark_dataset

__all__ = ["get_all_captions", "caps_per_image", "synthetic_retrieval_dataset", "load_benchmark_dataset"]
