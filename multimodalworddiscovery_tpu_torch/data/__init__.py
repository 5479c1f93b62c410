"""Data layer: torch corpus, the synthetic flickr8k-mini generators, and (in
their own modules) the on-disk format (``io``), shards and streaming
(``stream``), length buckets (``bucketing``) and the dataset builders
(``flickr8k``, ``mscoco``, ``flickr30k_entities``)."""

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus, GoldAnnotations
from multimodalworddiscovery_tpu_torch.data.synthetic import (
    concept_palette,
    expand_gold_to_frames,
    images_for_corpus,
    make_boxes_mini,
    make_flickr8k_mini,
    make_flickr8k_mini_batches,
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
    "make_flickr8k_mini_batches",
    "phone_templates",
    "phones_to_frames",
    "phones_to_waveforms",
    "phones_to_waveforms_batched",
]
