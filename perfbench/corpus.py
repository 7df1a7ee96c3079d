"""A corpus too large for one float32 copy, made in row blocks on the
device from the run's seed: block ``b`` holds rows ``[b R, (b + 1) R)`` of
standard normal values from a generator of its own (``R`` the
configuration's ``index.corpus_block_rows``), so the program's index and
the reference rebuild the same rows one block at a time, and neither ever
holds more than one block in float32."""
from __future__ import annotations

import torch

from .traffic import sub_seed


def block_rows(cfg: dict) -> int:
    ix = cfg["index"]
    return min(ix["corpus_block_rows"], ix["rows"])


def n_blocks(cfg: dict) -> int:
    return -(-cfg["index"]["rows"] // block_rows(cfg))


def block(cfg: dict, seed: int, b: int, device) -> torch.Tensor:
    """Block ``b`` of the corpus of ``seed``: (rows, hidden) float32."""
    r = block_rows(cfg)
    n = min(r, cfg["index"]["rows"] - b * r)
    g = torch.Generator(device=device).manual_seed(
        sub_seed(seed, f"corpus:{b}"))
    return torch.randn(n, cfg["hidden_size"], generator=g, device=device)


class Blocks:
    """The corpus of ``seed`` as a sequence of its blocks, each made when
    it is asked for."""

    def __init__(self, cfg: dict, seed: int, device) -> None:
        self.cfg, self.seed, self.device = cfg, seed, device

    def __len__(self) -> int:
        return n_blocks(self.cfg)

    def __getitem__(self, b: int) -> torch.Tensor:
        if not 0 <= b < len(self):
            raise IndexError(b)
        return block(self.cfg, self.seed, b, self.device)

    def starts(self):
        """(first row, block) of every block, in order."""
        r = block_rows(self.cfg)
        for b in range(len(self)):
            yield b * r, self[b]
