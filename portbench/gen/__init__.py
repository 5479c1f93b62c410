"""The cell's inputs, made from ``--seed`` by one general generator that
reads the configuration's ``corpus`` (and ``frames``) parameters.  A
traffic mix may set the corpus's scale (``n_utterances``) and nothing
else: the widths and lengths are the configuration's."""

from __future__ import annotations

import numpy as np
import torch

from portbench.gen.synthetic import frames_on_device, frames_per_token, make_flickr8k_mini


SCALE_KEYS = ("n_utterances",)


def corpus_params(config: dict, traffic: dict) -> dict:
    over = traffic.get("corpus", {})
    widths = sorted(set(over) - set(SCALE_KEYS))
    if widths:
        raise ValueError(f"a traffic mix sets the corpus's scale only, not {widths}")
    return {**config["corpus"], **over}


def make(config: dict, traffic: dict, seed: int, device) -> dict:
    """The paired corpus on ``device`` (phone ids, or frames where the
    configuration names ``frames``), with host copies of the lengths."""
    src, src_len, trg, trg_len, v_src, v_trg = make_flickr8k_mini(
        **corpus_params(config, traffic), seed=seed)
    out = {"trg": torch.as_tensor(trg, device=device),
           "trg_len": torch.as_tensor(trg_len, device=device),
           "trg_len_host": trg_len, "src_vocab": v_src, "trg_vocab": v_trg, "seed": seed}
    fr = config.get("frames")
    if fr is None:
        out.update(src=torch.as_tensor(src, device=device),
                   src_len=torch.as_tensor(src_len, device=device), src_len_host=src_len)
        return out
    nf = frames_per_token(src_len, seed, fr["min_frames"], fr["max_frames"], fr["max_len"])
    x, x_len = frames_on_device(src, nf, v_src, fr["feat_dim"], fr["noise"], seed,
                                fr["max_len"], device)
    out.update(src=x, src_len=x_len, src_len_host=nf.sum(axis=1).astype(np.int32))
    return out


def corpus_tuple(inp: dict) -> tuple:
    return inp["src"], inp["src_len"], inp["trg"], inp["trg_len"]
