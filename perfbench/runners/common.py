"""What the runners share: the port's model configuration from a
configuration file, the benchmark's weights copied into the program's
model, seeded uint8 image buckets and token ids, and a seeded sample of
the window's calls."""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.weights import generator, sub_seed, tower_shapes

__all__ = ["model_config", "load_weights", "image_buckets", "token_ids", "bucket_counts",
           "Reservoir", "free_cuda", "SOT", "EOT"]

SOT, EOT = 49406, 49407  # CLIP BPE's start and end of text; EOT is the largest id


def model_config(cfg: dict, quant: str = "none"):
    """The port's ``ModelConfig`` for a configuration file, after checking
    that the port's variant of that name has the file's widths."""
    from tpualign_torch.config import ModelConfig

    mc = ModelConfig(model_name=cfg["port_model"], quick_gelu=cfg["quick_gelu"],
                     compute_dtype=cfg["compute_dtype"], quant=quant)
    v, s = mc.variant, tower_shapes(cfg)
    want = {"embed_dim": s["embed_dim"], "image_size": s["vision"]["image_size"],
            "patch_size": s["vision"]["patch"], "vision_width": s["vision"]["width"],
            "vision_layers": s["vision"]["layers"], "vision_heads": s["vision"]["heads"],
            "context_length": s["text"]["seq"], "vocab_size": s["text"]["vocab"],
            "text_width": s["text"]["width"], "text_layers": s["text"]["layers"],
            "text_heads": s["text"]["heads"]}
    got = {k: getattr(v, k) for k in want}
    mlp = (v.vision_mlp_dim or 4 * v.vision_width, v.text_mlp_dim or 4 * v.text_width)
    if got != want or mlp != (s["vision"]["mlp"], s["text"]["mlp"]):
        raise ValueError(f"the port's {cfg['port_model']} is not the configuration: "
                         f"{got}, mlp {mlp} against {want}")
    return mc


@torch.no_grad()
def load_weights(model, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's leaves into the program's model; every leaf of
    either side must match by name and shape."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"leaves differ: {sorted(set(params) ^ set(weights))[:6]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: {tuple(p.shape)} against {tuple(weights[name].shape)}")
        p.copy_(weights[name])


def image_buckets(n: int, bucket: int, side_range: Sequence[int], seed: int, tag: str,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` uint8 ``(bucket, bucket, 3)`` buffers, each holding a random
    image of a random true (h, w) in its top-left corner and zeros
    elsewhere, as ``pad_to_bucket`` leaves them; and the (n, 2) int32
    sizes. Made on ``device``."""
    g = generator(seed, tag, device)
    lo, hi = int(side_range[0]), int(side_range[1])
    hw = torch.randint(lo, hi + 1, (n, 2), generator=g, device=device, dtype=torch.int32)
    u8 = torch.randint(0, 256, (n, bucket, bucket, 3), generator=g, device=device,
                       dtype=torch.uint8)
    pos = torch.arange(bucket, device=device)
    inside = (pos[None, :, None] < hw[:, 0, None, None]) & (pos[None, None, :] < hw[:, 1, None, None])
    u8.mul_(inside[..., None].to(torch.uint8))
    return u8, hw


def bucket_counts(total: int, shares: Sequence[float]) -> List[int]:
    """Rows a bucket of ``total``: the shares rounded, the remainder to the
    largest share, so every seed gets the same counts."""
    counts = [int(round(total * s)) for s in shares]
    counts[int(np.argmax(shares))] += total - sum(counts)
    return counts


def token_ids(counts: Sequence[int], buckets: Sequence[int], floor: int, context: int,
              seed: int, tag: str, device: torch.device) -> torch.Tensor:
    """``sum(counts)`` rows of ``context`` int32 token ids, ``counts[i]`` of
    them with a length (SOT and EOT included) drawn uniformly from
    bucket ``i``'s range (above the previous bucket, at least ``floor``),
    in a random row order: SOT, random ids below SOT, EOT, zeros."""
    g = generator(seed, tag, device)
    lengths = []
    lo = floor
    for count, top in zip(counts, buckets):
        lengths.append(torch.randint(lo, top + 1, (count,), generator=g, device=device))
        lo = top + 1
    lengths = torch.cat(lengths)
    lengths = lengths[torch.randperm(len(lengths), generator=g, device=device)]
    n = len(lengths)
    ids = torch.randint(1, SOT, (n, context), generator=g, device=device, dtype=torch.int32)
    pos = torch.arange(context, device=device)[None, :]
    ids[:, 0] = SOT
    ids = torch.where(pos == lengths[:, None] - 1, EOT, ids)
    return torch.where(pos >= lengths[:, None], 0, ids).to(torch.int32)


class Reservoir:
    """A uniform sample of the calls offered, drawn from the seed
    (algorithm R), kept apart for each stratum: ``size(stratum)`` of
    each."""

    def __init__(self, size: Callable[[object], int], seed: int, tag: str):
        self.size = size
        self.rng = np.random.default_rng(sub_seed(seed, tag))
        self.kept: Dict[object, list] = {}
        self.seen: Dict[object, int] = {}

    def offer(self, stratum, item) -> None:
        seen = self.seen.get(stratum, 0)
        kept = self.kept.setdefault(stratum, [])
        size = self.size(stratum)
        if seen < size:
            kept.append(item)
        else:
            j = int(self.rng.integers(0, seen + 1))
            if j < size:
                kept[j] = item
        self.seen[stratum] = seen + 1


def free_cuda(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
