"""The inputs the benchmark makes from ``--seed`` and hands to both the
program and the plain reference: training parameters and token ids.
Made on the device, in a few large calls. Also the shape of model that
the burn-in block runs (:func:`check_burnin`)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# The burn-in block's parameters, in its [in, out] layout, with the
# scales of its initialisation: name, shape and scale as functions of
# (d_model, d_ff, vocab).
PARAM_TABLE = (
    ("embed", lambda d, f, v: (v, d), lambda d, f: 0.02),
    ("wq", lambda d, f, v: (d, d), lambda d, f: d ** -0.5),
    ("wk", lambda d, f, v: (d, d), lambda d, f: d ** -0.5),
    ("wv", lambda d, f, v: (d, d), lambda d, f: d ** -0.5),
    ("wo", lambda d, f, v: (d, d), lambda d, f: d ** -0.5),
    ("w1", lambda d, f, v: (d, f), lambda d, f: d ** -0.5),
    ("w2", lambda d, f, v: (f, d), lambda d, f: f ** -0.5),
    ("out", lambda d, f, v: (d, v), lambda d, f: d ** -0.5),
)


def check_burnin(model: Dict[str, int]) -> None:
    """Raise where the burn-in block cannot run ``model``: its heads split
    ``d_model`` evenly (one kind of head, no separate key and value
    heads), at a width the port's attention kernels take."""
    from tpu_cluster_torch.kernels.flash_attention import SUPPORTED_HEAD_DIMS

    if model["d_model"] != model["n_heads"] * model["d_head"]:
        raise ValueError(f"d_model {model['d_model']} is not n_heads "
                         f"{model['n_heads']} x d_head {model['d_head']}")
    if model["d_head"] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"d_head {model['d_head']} is none of the kernels' "
                         f"{SUPPORTED_HEAD_DIMS}")


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def train_params(model: Dict[str, int], seed: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """f32 master parameters from ``seed``: one normal draw for all of
    them, each scaled in place. The tensors are views of one buffer."""
    d, f, v = model["d_model"], model["d_ff"], model["vocab"]
    shapes = [(name, shape(d, f, v), scale(d, f))
              for name, shape, scale in PARAM_TABLE]
    sizes = [s[0] * s[1] for _, s, _ in shapes]
    flat = torch.randn(sum(sizes), generator=_generator(seed, device),
                       device=device, dtype=torch.float32)
    out = {}
    for (name, shape, scale), part in zip(shapes, flat.split(sizes)):
        out[name] = part.view(shape).mul_(scale)
    return out


def token_batches(vocab: int, batch: int, seq: int, count: int, seed: int,
                  device: torch.device) -> List[Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """``count`` batches of ids drawn uniformly from ``seed`` (a stream of
    its own, apart from the parameters'): each row ``seq + 1`` ids,
    tokens the first ``seq`` and targets the ids shifted by one."""
    gen = _generator(int(seed) ^ 0x5EED0F1D5, device)
    ids = torch.randint(0, vocab, (count, batch, seq + 1), generator=gen,
                        device=device, dtype=torch.int64)
    return [(ids[i, :, :-1].contiguous(), ids[i, :, 1:].contiguous())
            for i in range(count)]
