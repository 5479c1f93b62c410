"""Data layer: torch corpus and the synthetic flickr8k-mini generator."""

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus, GoldAnnotations
from multimodalworddiscovery_tpu_torch.data.synthetic import (
    make_flickr8k_mini,
    phones_to_frames,
)

__all__ = ["Corpus", "GoldAnnotations", "make_flickr8k_mini", "phones_to_frames"]
