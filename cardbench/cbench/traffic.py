"""The one traffic generator: every mix is a JSON file of parameters under
``traffic/`` that this module reads.

Tokens follow a Zipf law over the vocabulary (exponent ``zipf_s``), each
row shifted by an offset of its own, so that rows differ in which tokens
are frequent, as documents do.  Frames (the encoder-decoder's stub speech
embeddings) are normal with std ``frame_std``.  Everything is drawn on the
device from generators seeded by the run's seed and the item's index
(``weights.sub_seed``): a seed fixes the inputs, and every seed gets the
same sizes.

kinds (each run by ``kind_<kind>.py``):
- ``train``: closed loop of training steps; ``batch`` rows of a budget of
  ``positions`` (split as the configuration's ``input_shapes`` says);
  ``ref_steps`` steps at the start are the ones the reference follows.
- ``serve_rounds``: closed loop of rounds; each round admits ``batch``
  requests with prompts of ``prompt_len`` tokens, prefills them as one
  batch into a cache of ``pad_to`` slots and decodes ``new_tokens`` greedy
  tokens each; ``sample_requests`` finished requests are checked.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from .weights import generator


def load(root: Path, name: str) -> dict:
    """A mix's parameters; its ``kind`` names the module that runs it,
    ``cbench/kind_<kind>.py``."""
    mix = json.loads((root / "traffic" / f"{name}.json").read_text())
    if not (Path(__file__).parent / f"kind_{mix.get('kind')}.py").is_file():
        raise ValueError(f"traffic {name}: no runner for kind "
                         f"{mix.get('kind')!r}")
    return mix


class Generator:
    def __init__(self, mix: dict, seed: int, vocab: int, device):
        self.mix, self.seed, self.vocab, self.device = mix, seed, vocab, device
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64)
        w = ranks ** -float(mix["zipf_s"])
        self.cdf = (torch.cumsum(w, 0) / w.sum()).float().to(device)

    def tokens(self, rows: int, length: int, *tag) -> torch.Tensor:
        gen = generator(self.device, self.seed, "tokens", *tag)
        shift = torch.randint(0, self.vocab, (rows, 1), generator=gen,
                              device=self.device)
        u = torch.rand((rows, length), generator=gen, device=self.device)
        rank = torch.searchsorted(self.cdf, u).clamp_(max=self.vocab - 1)
        return ((rank + shift) % self.vocab).to(torch.int32)

    def frames(self, shape, *tag) -> torch.Tensor:
        gen = generator(self.device, self.seed, "frames", *tag)
        x = torch.randn(shape, generator=gen, device=self.device)
        return (x * float(self.mix.get("frame_std", 1.0))).to(torch.bfloat16)

    def batch(self, shapes: dict, *tag) -> dict:
        """One batch of the configuration's ``input_shapes``."""
        out = {}
        for key, (shape, kind) in shapes.items():
            out[key] = (self.tokens(shape[0], shape[1], key, *tag)
                        if kind == "tokens" else self.frames(shape, key, *tag))
        return out
