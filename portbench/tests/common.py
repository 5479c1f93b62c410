"""Shared pieces of the benchmark's tests: the cells at a size a CPU test
holds (fewer captions; the Gaussian's concepts, caption width and
feature width cut as well)."""

from __future__ import annotations

import copy
import pathlib

from portbench import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCHMARK = ROOT / "BENCHMARK.json"

TINY_CORPUS = {
    "hmm_flickr8k.em": {"n_utterances": 120},
    "hmm_flickr8k.align": {"n_utterances": 60},
    "gauss_stretch.em": {"n_utterances": 40, "n_concepts": 20, "min_concepts": 4,
                         "max_concepts": 8, "max_src_len": 60},
}


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.load_cell(name, BENCHMARK)
    cell = copy.deepcopy(cell)
    cell.config["corpus"].update(TINY_CORPUS[name])
    if "frames" in cell.config:
        cell.config["frames"].update(feat_dim=8, max_len=150)
    if cell.traffic["loop"] == "em":
        cell.config["num_iterations"] = min(cell.config["num_iterations"], 4)
    else:
        cell.traffic["train_iterations"] = 3
    return cell
