"""Data layer: torch corpus and the synthetic flickr8k-mini generators."""

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus, GoldAnnotations
from multimodalworddiscovery_tpu_torch.data.synthetic import (
    concept_palette,
    expand_gold_to_frames,
    images_for_corpus,
    make_boxes_mini,
    make_flickr8k_mini,
    phone_templates,
    phones_to_frames,
    phones_to_waveforms,
    phones_to_waveforms_batched,
)

__all__ = [
    "Corpus",
    "GoldAnnotations",
    "concept_palette",
    "expand_gold_to_frames",
    "images_for_corpus",
    "make_boxes_mini",
    "make_flickr8k_mini",
    "phone_templates",
    "phones_to_frames",
    "phones_to_waveforms",
    "phones_to_waveforms_batched",
]
